"""BiFPN with fast-normalised weighted fusion, inference forward, NCHW.

Counterpart of the JAX package's ``models/bifpn.py``. Per layer (paper
Fig. 2): the first layer builds P3..P5 from 1x1 conv+BN of C3..C5 (P4/P5 get
separate convs for the top-down node and the bottom-up skip), P6 = maxpool
of conv+BN(C5), P7 = maxpool of P6; then

  top-down:  P6td = F(P6, up(P7)) ... P3out = F(P3, up(P4td))
  bottom-up: P4out = F(P4, P4td, down(P3out)) ... P7out = F(P7, down(P6out))

with F = relu-weighted fusion (eps 1e-4; each ``w_i / norm`` is cast to the
input dtype) -> swish -> SeparableConv 3x3 -> BN. ``weighted=False`` (D6/D7)
sums the inputs instead.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resample import downsample_maxpool, upsample_to
from .conv import Conv2d, SeparableConv
from .normalization import TpuBatchNorm

FUSION_EPS = 1e-4


class FusedNode(nn.Module):
    """One BiFPN node: fuse -> swish -> sepconv -> BN."""

    def __init__(self, features: int, num_inputs: int, weighted: bool = True,
                 bn_epsilon: float = 1e-3, fuse_bn: bool = False):
        super().__init__()
        self.num_inputs = num_inputs
        self.weighted = weighted
        if weighted:
            self.fusion_weights = nn.Parameter(torch.ones(num_inputs))
        self.conv = SeparableConv(features, features)
        self.bn = nn.Identity() if fuse_bn else TpuBatchNorm(features, bn_epsilon)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(inputs) != self.num_inputs:
            raise ValueError(f"expected {self.num_inputs} inputs, got {len(inputs)}")
        if self.weighted:
            w = F.relu(self.fusion_weights)
            w = (w / (w.sum() + FUSION_EPS)).to(inputs[0].dtype)
            x = w[0] * inputs[0]
            for i in range(1, self.num_inputs):
                x = x + w[i] * inputs[i]
        else:
            x = inputs[0]
            for t in inputs[1:]:
                x = x + t
        return self.bn(self.conv(F.silu(x)))


_NODES = (  # name, number of inputs, in the order the layer runs them
    ("p6_td", 2), ("p5_td", 2), ("p4_td", 2), ("p3_out", 2),
    ("p4_out", 3), ("p5_out", 3), ("p6_out", 3), ("p7_out", 2),
)


class BiFPNLayer(nn.Module):
    """One bidirectional pass over P3..P7."""

    def __init__(self, features: int, first: bool, in_channels=None,
                 weighted: bool = True, bn_epsilon: float = 1e-3,
                 fuse_bn: bool = False):
        super().__init__()
        self.first = first
        if first:
            c3, c4, c5 = in_channels
            for name, ch in (("p3_in", c3), ("p4_in_td", c4), ("p4_in_bu", c4),
                             ("p5_in_td", c5), ("p5_in_bu", c5), ("p6_in", c5)):
                self.add_module(f"{name}_conv", Conv2d(ch, features, 1))
                self.add_module(
                    f"{name}_bn",
                    nn.Identity() if fuse_bn else TpuBatchNorm(features, bn_epsilon),
                )
        for name, n in _NODES:
            self.add_module(name, FusedNode(features, n, weighted, bn_epsilon, fuse_bn))

    def _conv_bn(self, x, name):
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.first:
            c3, c4, c5 = feats
            p3_in = self._conv_bn(c3, "p3_in")
            p4_in_td = self._conv_bn(c4, "p4_in_td")
            p4_in_bu = self._conv_bn(c4, "p4_in_bu")
            p5_in_td = self._conv_bn(c5, "p5_in_td")
            p5_in_bu = self._conv_bn(c5, "p5_in_bu")
            p6_in = downsample_maxpool(self._conv_bn(c5, "p6_in"))
            p7_in = downsample_maxpool(p6_in)
        else:
            p3_in, p4_in_td, p5_in_td, p6_in, p7_in = feats
            p4_in_bu, p5_in_bu = p4_in_td, p5_in_td

        def up(x, like):
            return upsample_to(x, like.shape[-2], like.shape[-1])

        down = downsample_maxpool
        p6_td = self.p6_td([p6_in, up(p7_in, p6_in)])
        p5_td = self.p5_td([p5_in_td, up(p6_td, p5_in_td)])
        p4_td = self.p4_td([p4_in_td, up(p5_td, p4_in_td)])
        p3_out = self.p3_out([p3_in, up(p4_td, p3_in)])
        p4_out = self.p4_out([p4_in_bu, p4_td, down(p3_out)])
        p5_out = self.p5_out([p5_in_bu, p5_td, down(p4_out)])
        p6_out = self.p6_out([p6_in, p6_td, down(p5_out)])
        p7_out = self.p7_out([p7_in, down(p6_out)])
        return [p3_out, p4_out, p5_out, p6_out, p7_out]


class BiFPN(nn.Module):
    """Stack of ``depth`` BiFPN layers: (C3, C4, C5) -> [P3..P7]."""

    def __init__(self, features: int, depth: int, in_channels,
                 weighted: bool = True, bn_epsilon: float = 1e-3,
                 fuse_bn: bool = False):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer{i}", BiFPNLayer(
                features, first=(i == 0), in_channels=in_channels,
                weighted=weighted, bn_epsilon=bn_epsilon, fuse_bn=fuse_bn,
            ))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        for i in range(self.depth):
            feats = getattr(self, f"layer{i}")(feats)
        return list(feats)
