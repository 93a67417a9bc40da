"""The folded backbone's depthwise conv in one pass: CUDA kernel and plain twin.

For a (B, C, H, W) activation ``x`` (channels-last, as the detector's
maps are; the kernel reads another layout from a channels-last copy and
returns ``y`` in ``x``'s layout, as a conv does), a depthwise filter
``weight`` (C, 1, k, k) (k 3 or 5) and its folded ``bias`` (C,), all of one
dtype (float32 or bf16), a stride (1 or 2) and a SAME pad ``(top, bottom,
left, right)`` read as zeros (all 0 where the expand's epilogue already
wrote it):

  y = silu(depthwise_conv(x, weight) + bias)                 (B, C, Ho, Wo) in x's layout
  sums[b, band, c] = sum of y[b, c] over a band's rows / (Ho Wo)  (B, bands, C) float32

``sums`` are the squeeze-excite's channel sums over bands of ``plan(...).th``
output rows, each scaled by 1 / (Ho Wo): the shares of the SE's mean, which
:func:`se_mean` adds up (the kernel writes one row of them a band, with no
atomics).

:func:`depthwise_conv` calls the custom op
``efficientdet_tpu_torch::depthwise_conv_silu`` (registered with
``torch.library``, so that ``torch.export`` keeps it as one node). Its CUDA
implementation launches ``csrc/depthwise_conv.cu`` on the current stream
(float32 sums of the taps, bias and SiLU, one rounding to the activation's
type; the SE sums of the rounded outputs; no synchronisation, and nothing
allocated but the two outputs, so a CUDA graph can capture it); its CPU
implementation is :func:`depthwise_conv_reference` (ATen's depthwise conv,
the conv epilogue's twin and a float32 sum); any other device raises.

``depthwise_conv.launches`` counts the kernel's launches, where it is
launched: the CPU twin, a fake tensor's trace and a CUDA graph's replay
count none.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from .conv_epilogue import conv_epilogue_reference, layout

KERNEL_SIZES = (3, 5)
STRIDES = (1, 2)
# the kernel's constants (csrc/depthwise_conv.cu): workers (warps) a block,
# tiles in flight a worker
WARPS, STAGES = 4, 2
NC = 4  # channels a lane
SMEM_MAX = 232448  # a block's shared memory on an H100, one block an SM


class Plan(NamedTuple):
    """A launch's tile: ``cs`` channels a slice (``NC`` a lane), ``cg``
    lanes a row of a chunk (the warp's ``32 // cg`` lane rows; the other
    ``32 % cg`` lanes idle), ``rpl`` rows a lane (:func:`rows_a_lane`, at
    once, sharing each input row), so that a warp's band is ``th`` output
    rows (a row of SE sums) and a chunk ``th`` x :func:`chunk_cols` outputs."""
    cs: int
    cg: int
    rpl: int

    @property
    def th(self) -> int:
        return 32 // self.cg * self.rpl


def out_size(h: int, w: int, k: int, stride: int, pads: Sequence[int]) -> Tuple[int, int]:
    return (h + pads[0] + pads[1] - k) // stride + 1, (w + pads[2] + pads[3] - k) // stride + 1


def chunk_cols(stride: int) -> int:
    """Output columns a chunk: 8 at stride 1, 4 at stride 2."""
    return 8 if stride == 1 else 4


def rows_a_lane(k: int, stride: int) -> int:
    """Output rows a lane: 2, sharing each input row; 1 at k 5, stride 2
    (the kernel's ``rows_a_lane``)."""
    return 1 if k == 5 and stride == 2 else 2


def tile_shape(k: int, stride: int, cg: int) -> Tuple[int, int]:
    """(rows, columns) of a chunk's input tile."""
    return ((32 // cg * rows_a_lane(k, stride) - 1) * stride + k,
            (chunk_cols(stride) - 1) * stride + k)


def smem_bytes(k: int, stride: int, cs: int, cg: int, esize: int) -> int:
    """A block's shared memory: each worker's ring of tiles (128-byte
    aligned), its filters and biases in float32 and its mbarriers
    (``depthwise_conv_smem_bytes`` in the kernel's source, byte for byte)."""
    ih, iw = tile_shape(k, stride, cg)
    tile = -(-ih * iw * cs * esize // 128) * 128
    return WARPS * (STAGES * (tile + 8) + (k * k + 1) * cs * 4) + 128


@functools.lru_cache(maxsize=None)
def plan(c: int, ho: int, wo: int, k: int, stride: int, esize: int) -> Plan:
    """The tile for a (C, Ho, Wo) output of a k x k, stride-``stride`` conv
    in ``esize``-byte elements, from what the card's times at the three
    cells' shapes taught (every tile of up to 128 channels timed at each of
    their 40 shapes; NVIDIA H100 80GB HBM3):

    - a TMA box row (a pixel's slice) of 64 bytes at k 3, stride 1 and k 5,
      stride 2, and of 32 bytes at k 5, stride 1, whose taps dominate: the
      smallest slice at least that wide that divides C, or the widest below
      it; at k 3, stride 2, where the copies bound the kernel (a quarter of
      the input feeds each output), the widest slice up to 192 bytes;
    - lanes a row: slice / 4; bands of 32 / lanes-a-row rows a lane row,
      times :func:`rows_a_lane`."""
    slices = [cs for cs in range(NC, 129, NC) if c % cs == 0 and cs * esize % 16 == 0]
    if not slices:
        raise ValueError(f"channels {c} have no slice of whole 16-byte pieces")
    if k == 3 and stride == 2:
        fit = [cs for cs in slices if cs * esize <= 192]
        cs = max(fit) if fit else min(slices)
    else:
        target = (32 if k == 5 and stride == 1 else 64) // esize
        wide = [cs for cs in slices if cs >= target]
        cs = min(wide) if wide else max(slices)
    cg = cs // NC
    if smem_bytes(k, stride, cs, cg, esize) > SMEM_MAX:
        raise ValueError(f"no tile fits C {c}, {ho} x {wo}, k {k}, stride {stride}")
    return Plan(cs, cg, rows_a_lane(k, stride))


def bands(ho: int, th: int) -> int:
    return -(-ho // th)


def _plan_of(x: torch.Tensor, weight: torch.Tensor, stride: int,
             pads: Sequence[int]) -> Tuple[Plan, int, int]:
    # the shapes as ints: a trace's symbolic sizes specialise to the plan's
    c, h, w, k = (int(v) for v in (x.shape[1], x.shape[2], x.shape[3], weight.shape[-1]))
    ho, wo = out_size(h, w, k, stride, pads)
    return plan(c, ho, wo, k, stride, x.element_size()), ho, wo


def depthwise_conv_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             stride: int, pads: Sequence[int]
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin: ATen's depthwise conv (as the folded model ran it
    before the kernel: the pad inside the conv where it is symmetric), the
    conv epilogue's twin (bias, SiLU), and the float32 sums of the rounded
    output over each band, scaled by 1 / (Ho Wo)."""
    c = x.shape[1]
    if len(set(pads)) == 1:
        y = F.conv2d(x, weight, None, stride, pads[0], 1, c)
    else:
        y = F.conv2d(F.pad(x, (pads[2], pads[3], pads[0], pads[1])), weight, None, stride, 0, 1, c)
    y = conv_epilogue_reference(y, bias, None, True).contiguous(memory_format=layout(x))
    b, _, ho, wo = y.shape
    th = _plan_of(x, weight, stride, pads)[0].th
    n = bands(ho, th)
    rows = F.pad(y.float().sum(dim=3), (0, n * th - ho))
    sums = rows.view(b, c, n, th).sum(dim=3).transpose(1, 2) * inv_area(ho, wo)
    return y, sums.contiguous()


def depthwise_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int,
                   pads: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(silu(depthwise_conv(x) + bias), sums)``: the output, in ``x``'s
    layout, and the SE's float32 channel sums, (B, bands, C)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"depthwise_conv: unsupported device {x.device}")
    return torch.ops.efficientdet_tpu_torch.depthwise_conv_silu(x, weight, bias, stride,
                                                                list(pads))


depthwise_conv.launches = 0


def inv_area(ho: int, wo: int) -> float:
    """1 / (Ho Wo) in float32, as the kernel scales the sums by it."""
    return float(torch.tensor(1.0 / (ho * wo), dtype=torch.float32))


def se_mean(sums: torch.Tensor) -> torch.Tensor:
    """The SE's (B, C, 1, 1) float32 mean from the output's scaled sums."""
    return sums.sum(dim=1)[:, :, None, None]


@torch.library.custom_op("efficientdet_tpu_torch::depthwise_conv_silu", mutates_args=(),
                         device_types="cpu")
def _depthwise_conv_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int,
                       pads: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    return depthwise_conv_reference(x, weight, bias, stride, pads)


def _empty_outputs(x, weight, stride, pads, fmt=torch.channels_last):
    p, ho, wo = _plan_of(x, weight, stride, pads)
    b, c = x.shape[:2]
    y = torch.empty((b, c, ho, wo), dtype=x.dtype, device=x.device, memory_format=fmt)
    return y, torch.empty((b, bands(ho, p.th), c), dtype=torch.float32, device=x.device)


@_depthwise_conv_op.register_fake
def _depthwise_conv_fake(x, weight, bias, stride, pads):
    return _empty_outputs(x, weight, stride, pads, layout(x))


@_depthwise_conv_op.register_kernel("cuda")
def _depthwise_conv_cuda(x, weight, bias, stride, pads):
    # the kernel reads and writes channels-last: the detector's maps are (a
    # trace may have seen another layout; then these copies run)
    fmt = layout(x)
    x = x.contiguous(memory_format=torch.channels_last)
    y, sums = _empty_outputs(x, weight, stride, pads)
    launch_into(x, weight, bias, stride, pads, y, sums)
    return y.contiguous(memory_format=fmt), sums


def launch_into(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int,
                pads: Sequence[int], y: torch.Tensor, sums: torch.Tensor) -> None:
    """Launch csrc/depthwise_conv.cu on the current stream into ``y`` and
    ``sums`` (shaped as :func:`depthwise_conv` returns them)."""
    from . import cuda_build

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"x {tuple(x.shape)} must be (B, C, H, W) laid out channels-last")
    b, c, h, w = x.shape
    k = weight.shape[-1]
    if (tuple(weight.shape) != (c, 1, k, k) or k not in KERNEL_SIZES or stride not in STRIDES
            or bias.shape != (c,) or c % 8):
        raise ValueError(f"weight {tuple(weight.shape)}, bias {tuple(bias.shape)}, stride "
                         f"{stride}: not a depthwise k3 or k5 filter at stride 1 or 2 over C "
                         f"{c}, a multiple of 8")
    if len(pads) != 4 or min(pads) < 0:
        raise ValueError(f"pads {pads} are not (top, bottom, left, right)")
    p, ho, wo = _plan_of(x, weight, stride, pads)
    if (tuple(y.shape) != (b, c, ho, wo) or not y.is_contiguous(memory_format=torch.channels_last)
            or tuple(sums.shape) != (b, bands(ho, p.th), c) or sums.dtype != torch.float32
            or not sums.is_contiguous()):
        raise ValueError(f"y {tuple(y.shape)} or sums {tuple(sums.shape)} is not shaped for "
                         f"the output ({b}, {c}, {ho}, {wo}) and {bands(ho, p.th)} bands")
    if any(t.dtype != x.dtype for t in (weight, bias, y)):
        raise TypeError("x, weight, bias and y must share one dtype")
    if any(t.device != x.device for t in (weight, bias, y, sums)):
        raise ValueError("x, weight, bias, y and sums must be on one device")
    if not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("weight and bias must be contiguous")
    if x.data_ptr() % 16 or y.data_ptr() % 16 or sums.data_ptr() % 16:
        raise ValueError("x, y and sums must start 16-byte aligned")
    lib = cuda_build.load("depthwise_conv")
    fn = lib.depthwise_conv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 13
                   + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 sums.data_ptr(), b, c, h, w, k, stride, *pads, p.cs, p.cg, p.rpl,
                 int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(lib, "depthwise_conv", err)
    depthwise_conv.launches += 1
