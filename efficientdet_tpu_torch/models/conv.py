"""Convolution with flax's ``padding="SAME"`` and compute-dtype semantics.

Parameters are float32, as flax keeps them, and each call casts the kernel
and bias to the activation's dtype, which is what ``nn.Conv(dtype=...)``
does; ``fuse_for_inference`` stores them in that dtype, so there the cast
is a no-op.
With stride 1 and an odd kernel SAME is symmetric and goes to the
convolution itself. With stride 2 it is asymmetric for even sizes (k=3 pads
(0, 1), k=5 pads (1, 2)), so the input is padded explicitly first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resample import same_pads


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.stride
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if s == 1 and k % 2 == 1:
            return F.conv2d(x, w, b, 1, k // 2, 1, self.groups)
        ph = same_pads(x.shape[-2], k, s)
        pw = same_pads(x.shape[-1], k, s)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, b, s, 0, 1, self.groups)


class SeparableConv(nn.Module):
    """Depthwise kxk (no bias) + pointwise 1x1 (keras SeparableConv2D)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True):
        super().__init__()
        self.depthwise = Conv2d(in_ch, in_ch, kernel_size, groups=in_ch, bias=False)
        self.pointwise = Conv2d(in_ch, features, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))
