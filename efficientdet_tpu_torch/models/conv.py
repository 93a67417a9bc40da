"""Convolution with flax's ``padding="SAME"`` and compute-dtype semantics.

Parameters are float32, as flax keeps them, and each call casts the kernel
and bias to the activation's dtype, which is what ``nn.Conv(dtype=...)``
does; ``fuse_for_inference`` stores them in that dtype, so there the cast
is a no-op.
With stride 1 and an odd kernel SAME is symmetric and goes to the
convolution itself. With stride 2 it is asymmetric for even sizes (k=3 pads
(0, 1), k=5 pads (1, 2)), so the input is padded explicitly first.
Under a spatial ``parallel_context`` a height band reads its halo rows from
the neighbouring ranks first (parallel/context.py).

A folded backbone conv called with grad off (:func:`folds`) runs without
its bias (``bias=False``), and one pass of ``ops/conv_epilogue.py`` adds it
with the activation and residual (models/efficientnet.py); that pass also
writes the SAME pad of a following stride-2 conv
(:meth:`Conv2d.explicit_pads`), which then reads its input as it is
(``padded=True``). A folded depthwise conv of the backbone
(:func:`depthwise_folds`) runs in one kernel of ``ops/depthwise_conv.py``
with its bias, SiLU and the squeeze-excite's channel sums instead.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_epilogue import Pads
from ..ops.depthwise_conv import KERNEL_SIZES, STRIDES
from ..ops.resample import same_pads
from ..parallel.context import active_context


def same_conv(x: torch.Tensor, w: torch.Tensor, b, k: int, s: int, groups: int) -> torch.Tensor:
    """flax's SAME convolution of a whole (B, Cin, H, W) map."""
    if s == 1 and k % 2 == 1:
        return F.conv2d(x, w, b, 1, k // 2, 1, groups)
    ph = same_pads(x.shape[-2], k, s)
    pw = same_pads(x.shape[-1], k, s)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, b, s, 0, 1, groups)


class Conv2d(nn.Module):
    """(B, Cin, H, W) -> (B, Cout, H', W'), SAME padding, optional groups."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.zeros(out_ch, in_ch // groups, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor, bias: bool = True, padded: bool = False) -> torch.Tensor:
        """``bias=False`` leaves the bias out; ``padded``: ``x`` already holds
        this conv's SAME pad (:meth:`explicit_pads`)."""
        k, s = self.kernel_size, self.stride
        w = self.weight.to(x.dtype)
        b = None if self.bias is None or not bias else self.bias.to(x.dtype)
        if padded:
            return F.conv2d(x, w, b, s, 0, 1, self.groups)
        ctx = active_context()
        if ctx is not None and (k > 1 or s > 1) and ctx.banded(x):
            return ctx.conv2d(x, w, b, k, s, self.groups,
                              lambda whole: same_conv(whole, w, b, k, s, self.groups))
        return same_conv(x, w, b, k, s, self.groups)

    def same_pads(self, x: torch.Tensor) -> Pads:
        """(top, bottom, left, right): flax's SAME pad of this conv on ``x``."""
        k, s = self.kernel_size, self.stride
        return same_pads(x.shape[-2], k, s) + same_pads(x.shape[-1], k, s)

    def explicit_pads(self, x: torch.Tensor) -> Optional[Pads]:
        """(top, bottom, left, right): the SAME pad that :func:`same_conv`
        writes around ``x`` before this conv runs on it; None where the conv
        pads by itself, or ``x`` is a band (its halo brings the rows)."""
        if self.stride == 1 and self.kernel_size % 2 == 1:
            return None
        if _banded(x):
            return None
        pads = self.same_pads(x)
        return pads if any(pads) else None


def _banded(x: torch.Tensor) -> bool:
    ctx = active_context()
    return ctx is not None and ctx.banded(x)


def folds(conv: Conv2d, x: torch.Tensor) -> bool:
    """Whether ``conv`` on ``x`` takes the one-pass epilogue: a folded conv
    (it carries a bias) called with grad off, on the CPU (the op's twin) or
    the card. Training, remat, any call with grad and the unfused model keep
    ATen's separate ops."""
    return (conv.bias is not None and not torch.is_grad_enabled()
            and x.device.type in ("cpu", "cuda"))


def depthwise_folds(conv: Conv2d, x: torch.Tensor) -> bool:
    """Whether the depthwise ``conv`` on ``x`` takes the one-pass depthwise
    kernel (ops/depthwise_conv.py: the conv, bias, SiLU and the SE's channel
    sums): where it :func:`folds`, k 3 or 5 at stride 1 or 2, C a multiple of
    8, float32 or bf16, and not a band of a spatial context (its halo and its
    SE mean come from the neighbouring ranks). Elsewhere the conv keeps
    :func:`folds`'s path or ATen's. The layout is not asked: a trace may see
    a layout the run does not (the kernel copies any but channels-last, the
    detector's own, and its output keeps ``x``'s layout)."""
    c = x.shape[1]
    return (folds(conv, x) and conv.groups == c == conv.weight.shape[0] and c % 8 == 0
            and conv.kernel_size in KERNEL_SIZES and conv.stride in STRIDES
            and x.dtype in (torch.float32, torch.bfloat16) and not _banded(x))


class SeparableConv(nn.Module):
    """Depthwise kxk (no bias) + pointwise 1x1 (keras SeparableConv2D)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True):
        super().__init__()
        self.depthwise = Conv2d(in_ch, in_ch, kernel_size, groups=in_ch, bias=False)
        self.pointwise = Conv2d(in_ch, features, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))
