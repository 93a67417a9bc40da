"""The folded backbone's conv epilogue in one pass: CUDA kernel and plain twin.

For a (B, C, H, W) conv output ``x`` computed without its bias (contiguous
or channels-last: the detector's own path is channels-last, as its images
arrive NHWC), a bias ``(C,)`` in x's dtype and an optional residual shaped
and laid out like ``x``:

  y = act(x + bias) [+ residual]      act: SiLU or identity

written in place in ``x``, or, given SAME pads ``(top, bottom, left,
right)``, into a new zero-bordered ``(B, C, H + top + bottom, W + left +
right)`` buffer in x's layout that the next (stride-2 depthwise) conv
reads unpadded.

:func:`conv_epilogue` calls one of two custom ops (registered here with
``torch.library``, so that ``torch.export`` keeps each as one node):
``efficientdet_tpu_torch::conv_epilogue_`` (in place; mutates ``x``) and
``efficientdet_tpu_torch::conv_epilogue_padded`` (returns the padded
buffer). Their CUDA implementation launches ``csrc/conv_epilogue.cu`` on the
current stream (float32 sums rounded once to the activation's type; no
synchronisation, and nothing allocated but the padded op's output), their
CPU implementation is :func:`conv_epilogue_reference` (ATen's add, silu,
add and pad, each rounded to the activation's type), and any other device
raises.

``conv_epilogue.launches`` counts the kernel's launches and
``conv_epilogue.padded`` those that wrote a padded buffer, counted where the
kernel is launched (as for the other kernels' counters): the CPU twin, a
fake tensor's trace and a CUDA graph's replay count none.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Pads = Tuple[int, int, int, int]  # (top, bottom, left, right)


def conv_epilogue_reference(x: torch.Tensor, bias: torch.Tensor,
                            residual: Optional[torch.Tensor] = None, silu: bool = False,
                            pads: Sequence[int] = (0, 0, 0, 0)) -> torch.Tensor:
    """Plain-torch twin: the ops the folded model ran before the kernel."""
    y = x + bias.reshape(1, -1, 1, 1)
    if silu:
        y = F.silu(y)
    if residual is not None:
        y = y + residual
    if any(pads):
        y = F.pad(y, (pads[2], pads[3], pads[0], pads[1]))
    return y


def conv_epilogue(x: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                  silu: bool = False, pads: Optional[Pads] = None) -> torch.Tensor:
    """``act(x + bias) [+ residual]``: ``x`` itself, updated in place, or a
    new buffer with the SAME pad ``pads`` around it."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_epilogue: unsupported device {x.device}")
    if pads is None:
        torch.ops.efficientdet_tpu_torch.conv_epilogue_(x, bias, residual, silu)
        return x
    return torch.ops.efficientdet_tpu_torch.conv_epilogue_padded(x, bias, residual, silu,
                                                                 list(pads))


conv_epilogue.launches = 0
conv_epilogue.padded = 0


def padded_shape(x: torch.Tensor, pads: Sequence[int]) -> Tuple[int, int, int, int]:
    """``x``'s (B, C, H, W) with ``pads`` (top, bottom, left, right) added."""
    b, c, h, w = x.shape
    return b, c, h + pads[0] + pads[1], w + pads[2] + pads[3]


def channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` is laid out channels-last (and not also contiguous:
    where both hold, as for C = 1 or H = W = 1, the two orders agree)."""
    return not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


def layout(x: torch.Tensor) -> torch.memory_format:
    """``x``'s layout, which an op's output keeps."""
    return torch.channels_last if channels_last(x) else torch.contiguous_format


def empty_padded(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """An uninitialised buffer of x's padded shape, in x's layout."""
    return torch.empty(padded_shape(x, pads), dtype=x.dtype, device=x.device,
                       memory_format=layout(x))


@torch.library.custom_op("efficientdet_tpu_torch::conv_epilogue_", mutates_args=("x",),
                         device_types="cpu")
def _conv_epilogue_op(x: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
                      silu: bool) -> None:
    x.copy_(conv_epilogue_reference(x, bias, residual, silu))


@_conv_epilogue_op.register_fake
def _conv_epilogue_fake(x, bias, residual, silu):
    return None


@_conv_epilogue_op.register_kernel("cuda")
def _conv_epilogue_cuda(x, bias, residual, silu):
    launch_into(x, bias, residual, x, silu, (0, 0, 0, 0))


@torch.library.custom_op("efficientdet_tpu_torch::conv_epilogue_padded", mutates_args=(),
                         device_types="cpu")
def _conv_epilogue_padded_op(x: torch.Tensor, bias: torch.Tensor,
                             residual: Optional[torch.Tensor], silu: bool,
                             pads: List[int]) -> torch.Tensor:
    return conv_epilogue_reference(x, bias, residual, silu, pads)


@_conv_epilogue_padded_op.register_fake
def _conv_epilogue_padded_fake(x, bias, residual, silu, pads):
    return empty_padded(x, pads)


@_conv_epilogue_padded_op.register_kernel("cuda")
def _conv_epilogue_padded_cuda(x, bias, residual, silu, pads):
    out = empty_padded(x, pads)
    launch_into(x, bias, residual, out, silu, pads)
    return out


def launch_into(x: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
                out: torch.Tensor, silu: bool, pads: Sequence[int]) -> None:
    """Launch csrc/conv_epilogue.cu on the current stream: ``out`` is ``x``
    (pads all 0) or a distinct buffer of the padded shape."""
    from . import cuda_build

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or bias.shape != (x.shape[1],):
        raise ValueError(f"x {tuple(x.shape)} is not (B, C, H, W) or bias {tuple(bias.shape)} "
                         "is not (C,)")
    if len(pads) != 4 or min(pads) < 0 or tuple(out.shape) != padded_shape(x, pads):
        raise ValueError(f"out {tuple(out.shape)} is not x {tuple(x.shape)} padded by {pads}")
    tensors = [x, bias, out] + ([] if residual is None else [residual])
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} is not shaped like x {tuple(x.shape)}")
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError("x, bias, residual and out must share one dtype")
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, bias, residual and out must be on one device")
    nhwc = channels_last(x)
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    maps = [x, out] + ([] if residual is None else [residual])
    if not (bias.is_contiguous() and all(t.is_contiguous(memory_format=fmt) for t in maps)):
        raise ValueError("x, residual and out must share one layout, contiguous or "
                         "channels-last, and bias must be contiguous")
    padded = any(pads)
    if padded == (out.data_ptr() == x.data_ptr()):
        raise ValueError("out must be x itself exactly when nothing is padded")
    vec_in = not padded or (nhwc and x.shape[1] * x.element_size() % 16 == 0)
    if any(t.data_ptr() % 16 for t in (maps if vec_in else [out])):
        raise ValueError("x, residual and out must start 16-byte aligned")
    lib = cuda_build.load("conv_epilogue")
    fn = lib.conv_epilogue_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), bias.data_ptr(), 0 if residual is None else residual.data_ptr(),
                 out.data_ptr(), b, c, h, w, *pads, int(silu), int(nhwc),
                 int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(lib, "conv_epilogue", err)
    conv_epilogue.launches += 1
    conv_epilogue.padded += int(padded)
