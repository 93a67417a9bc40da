"""One BiFPN node in one pass: CUDA kernel and plain twin.

For a node at level l, the one or two inputs ``kept`` already at its level
(B, C, H, W), the input ``moved`` at its own level (B, C, H / 2, W / 2)
top-down (``up``) or (B, C, 2 H, 2 W) bottom-up, and the node's raw float32
fusion weights (None for a plain sum):

  out = silu(sum_i w_i kept_i + w_m R(moved))      (B, C, H, W) in kept[0]'s layout

with R the nearest 2x upsample (``up``) or the 3x3 stride-2 max-pool with
flax's SAME pad (-inf past the edge), and ``w = relu(w) / (sum relu(w) +
1e-4)`` cast to the activation's dtype, as the model's ``fuse`` forms it.

:func:`bifpn_node` calls the custom op ``efficientdet_tpu_torch::bifpn_node``
(registered with ``torch.library``, so that ``torch.export`` keeps it as one
node). Its CUDA implementation launches ``csrc/bifpn_node.cu`` on the
current stream (float32 sums in ``fuse``'s order, one rounding to the
activation's type; no synchronisation, and nothing allocated but the
output, so a CUDA graph can capture it); its CPU implementation is
:func:`bifpn_node_reference`, ATen's resample and the fusion op for op
(``ops/resample.py`` and :func:`fusion`); any other device raises.

``bifpn_node.launches`` counts the kernel's launches, where it is launched:
the CPU twin, a fake tensor's trace and a CUDA graph's replay count none.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from .conv_epilogue import layout
from .resample import _maxpool, _upsample

FUSION_EPS = 1e-4


def fusion(inputs: Sequence[torch.Tensor], weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A node's fusion and swish in ATen's ops: the inputs summed,
    relu-weighted with fast normalisation where ``weights`` is given."""
    if weights is None:
        x = inputs[0]
        for t in inputs[1:]:
            x = x + t
    else:
        w = F.relu(weights)
        w = (w / (w.sum() + FUSION_EPS)).to(inputs[0].dtype)
        x = w[0] * inputs[0]
        for i in range(1, len(inputs)):
            x = x + w[i] * inputs[i]
    return F.silu(x)


def resampled(moved: torch.Tensor, h: int, w: int, up: bool) -> torch.Tensor:
    """``moved`` brought to an (h, w) level by ATen: the nearest upsample,
    or the SAME max-pool."""
    return _upsample(moved, h, w) if up else _maxpool(moved, 3, 2)


def bifpn_node_reference(kept: Sequence[torch.Tensor], moved: torch.Tensor, up: bool,
                         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain-torch twin: the ops the folded model ran before the kernel."""
    h, w = kept[0].shape[-2:]
    y = fusion(list(kept) + [resampled(moved, h, w, up)], weights)
    return y.contiguous(memory_format=layout(kept[0]))


def bifpn_node(kept: Sequence[torch.Tensor], moved: torch.Tensor, up: bool,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``silu(sum w_i kept_i + w_m R(moved))`` in one pass, in ``kept[0]``'s
    layout."""
    if moved.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bifpn_node: unsupported device {moved.device}")
    return torch.ops.efficientdet_tpu_torch.bifpn_node(list(kept), moved, up, weights)


bifpn_node.launches = 0


@torch.library.custom_op("efficientdet_tpu_torch::bifpn_node", mutates_args=(),
                         device_types="cpu")
def _bifpn_node_op(kept: List[torch.Tensor], moved: torch.Tensor, up: bool,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    return bifpn_node_reference(kept, moved, up, weights)


@_bifpn_node_op.register_fake
def _bifpn_node_fake(kept, moved, up, weights):
    return torch.empty_like(kept[0], memory_format=layout(kept[0]))


@_bifpn_node_op.register_kernel("cuda")
def _bifpn_node_cuda(kept, moved, up, weights):
    # the kernel reads and writes channels-last: the detector's maps are (a
    # trace may have seen another layout; then these copies run)
    fmt = layout(kept[0])
    kept = [t.contiguous(memory_format=torch.channels_last) for t in kept]
    moved = moved.contiguous(memory_format=torch.channels_last)
    out = torch.empty_like(kept[0], memory_format=torch.channels_last)
    launch_into(kept, moved, up, weights, out)
    return out.contiguous(memory_format=fmt)


def launch_into(kept: Sequence[torch.Tensor], moved: torch.Tensor, up: bool,
                weights: Optional[torch.Tensor], out: torch.Tensor) -> None:
    """Launch csrc/bifpn_node.cu on the current stream into ``out``, shaped
    and laid out (channels-last) as the kept inputs."""
    from . import cuda_build

    if not 1 <= len(kept) <= 2:
        raise ValueError(f"a node keeps one or two inputs at its level, got {len(kept)}")
    x = kept[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the maps must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] % 8:
        raise ValueError(f"kept {tuple(x.shape)} is not (B, C, H, W) with C a multiple of 8")
    b, c, h, w = x.shape
    want = (b, c, h // 2, w // 2) if up else (b, c, 2 * h, 2 * w)
    if up and (h % 2 or w % 2):
        raise ValueError(f"a top-down node's level {h} x {w} is not twice the one above")
    if tuple(moved.shape) != want:
        raise ValueError(f"moved {tuple(moved.shape)} is not {want}: the level "
                         f"{'above' if up else 'below'} at half or twice the size")
    maps = list(kept) + [out]
    if any(tuple(t.shape) != tuple(x.shape) for t in maps):
        raise ValueError("the kept inputs and out must share one shape")
    if any(t.dtype != x.dtype for t in maps + [moved]):
        raise TypeError("the kept inputs, moved and out must share one dtype")
    if weights is not None and (weights.dtype != torch.float32 or weights.shape != (len(kept) + 1,)
                                or not weights.is_contiguous()):
        raise ValueError(f"weights must be the node's {len(kept) + 1} float32 fusion weights")
    if any(t.device != x.device for t in maps + [moved] + ([] if weights is None else [weights])):
        raise ValueError("the maps and the weights must be on one device")
    if not all(t.is_contiguous(memory_format=torch.channels_last) for t in maps + [moved]):
        raise ValueError("the maps must be laid out channels-last")
    if any(t.data_ptr() % 16 for t in maps + [moved]):
        raise ValueError("the maps must start 16-byte aligned")
    lib = cuda_build.load("bifpn_node")
    fn = lib.bifpn_node_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), kept[1].data_ptr() if len(kept) == 2 else 0, moved.data_ptr(),
                 0 if weights is None else weights.data_ptr(), out.data_ptr(), b, c, h, w,
                 int(up), int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(lib, "bifpn_node", err)
    bifpn_node.launches += 1
