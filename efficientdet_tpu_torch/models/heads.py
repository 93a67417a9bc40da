"""Shared class/box prediction heads, inference forward, NCHW inside.

Counterpart of the JAX package's ``models/heads.py``. Depth-``d`` stacks of
SeparableConv 3x3 whose weights are shared across P3..P7, with per-level
BatchNorm and swish, then a final SeparableConv to ``A*num_classes`` logits
(bias = -log((1-pi)/pi), pi = 0.01) or ``A*4`` box deltas.

With ``fuse_bn=True`` the per-level BN folds into per-level copies of the
shared pointwise (``pw_l{lvl}_d{i}``) and the depthwise stays shared
(``conv{i}_dw``); utils/fold_bn.py makes those weights.

Two output paths:

* ``anchor_major=False``: per level, the final 1x1 conv, reshaped to
  (B, H*W*A, out) and concatenated over levels (the ``"concat"`` front end);
* ``anchor_major=True`` (the main path): per level, only the final
  depthwise; its output becomes NHWC pixel rows ``b*H*W + p``, the rows of
  all levels are concatenated, and ONE launch of the head pointwise kernel
  (ops/head_kernel.py) computes the final 1x1 for every level.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.head_kernel import head_pointwise_anchor_major
from .conv import Conv2d, SeparableConv
from .normalization import TpuBatchNorm


def prior_prob_bias(prior: float = 0.01) -> float:
    """The class head's final bias: -log((1-pi)/pi)."""
    return -math.log((1.0 - prior) / prior)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B*H*W, C) rows in NHWC pixel order."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b * h * w, c)


class _Head(nn.Module):
    """Common structure for ClassNet/BoxNet."""

    def __init__(self, width: int, depth: int, num_outputs: int,
                 num_anchors: int, num_levels: int, split_anchors: bool,
                 bn_epsilon: float = 1e-3, fuse_bn: bool = False):
        super().__init__()
        self.depth = depth
        self.num_levels = num_levels
        self.num_outputs = num_outputs
        self.num_anchors = num_anchors
        self.split_anchors = split_anchors
        self.fuse_bn = fuse_bn
        for i in range(depth):
            if fuse_bn:
                self.add_module(f"conv{i}_dw", Conv2d(width, width, 3, groups=width, bias=False))
                for lvl in range(num_levels):
                    self.add_module(f"pw_l{lvl}_d{i}", Conv2d(width, width, 1))
            else:
                self.add_module(f"conv{i}", SeparableConv(width, width))
                for lvl in range(num_levels):
                    self.add_module(f"bn_l{lvl}_d{i}", TpuBatchNorm(width, bn_epsilon))
        self.final = SeparableConv(width, num_outputs * num_anchors)

    def _tower(self, x: torch.Tensor, lvl: int) -> torch.Tensor:
        for i in range(self.depth):
            if self.fuse_bn:
                x = getattr(self, f"pw_l{lvl}_d{i}")(getattr(self, f"conv{i}_dw")(x))
            else:
                x = getattr(self, f"bn_l{lvl}_d{i}")(getattr(self, f"conv{i}")(x))
            x = F.silu(x)
        return x

    def forward(self, feats: Sequence[torch.Tensor], anchor_major: bool = False):
        if len(feats) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels, got {len(feats)}")
        if not anchor_major:
            outputs = []
            for lvl, x in enumerate(feats):
                x = self.final(self._tower(x, lvl))
                outputs.append(
                    x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.num_outputs)
                )
            return torch.cat(outputs, dim=1)  # (B, A_total, num_outputs)

        rows, hws = [], []
        bsz = feats[0].shape[0]
        for lvl, x in enumerate(feats):
            d = self.final.depthwise(self._tower(x, lvl))
            rows.append(_rows(d))
            hws.append(d.shape[-2] * d.shape[-1])
        allrows = torch.cat(rows, dim=0)  # (M_tot, Cin)
        pw = self.final.pointwise
        k2d = pw.weight.reshape(pw.weight.shape[0], -1).t()  # (Cin, A*out)
        a = self.num_anchors
        if not self.split_anchors:
            z, _, _ = head_pointwise_anchor_major(allrows, k2d, pw.bias, 1)
            return z[0], tuple(hws)  # (Mp_tot, A*4) pixel rows
        z, amax, _ = head_pointwise_anchor_major(allrows, k2d, pw.bias, a)
        # per-image best-class logit (B, A_total), in level-major
        # (anchor-major, pixel) order
        parts = []
        off = 0
        for hw in hws:
            seg = amax[:, off:off + bsz * hw].reshape(a, bsz, hw)
            parts.append(seg.permute(1, 0, 2).reshape(bsz, a * hw))
            off += bsz * hw
        return z, torch.cat(parts, dim=1), tuple(hws)


class ClassNet(nn.Module):
    """Classification head -> (B, A, num_classes) logits."""

    def __init__(self, width: int, depth: int, num_classes: int,
                 num_anchors: int = 9, num_levels: int = 5, prior: float = 0.01,
                 bn_epsilon: float = 1e-3, fuse_bn: bool = False):
        super().__init__()
        self.prior = prior
        self.net = _Head(width, depth, num_classes, num_anchors, num_levels,
                         True, bn_epsilon, fuse_bn)

    def forward(self, feats, anchor_major: bool = False):
        return self.net(feats, anchor_major)


class BoxNet(nn.Module):
    """Box regression head -> (B, A, 4) encoded deltas."""

    def __init__(self, width: int, depth: int, num_anchors: int = 9,
                 num_levels: int = 5, bn_epsilon: float = 1e-3,
                 fuse_bn: bool = False):
        super().__init__()
        self.net = _Head(width, depth, 4, num_anchors, num_levels,
                         False, bn_epsilon, fuse_bn)

    def forward(self, feats, anchor_major: bool = False):
        return self.net(feats, anchor_major)
