"""EfficientDet over any pyramid P``min``..P``max``, in plain PyTorch.

The reference for configurations whose pyramid is not P3..P7 (EfficientDet-D7x:
P3..P8), and the same detector as ``model.Detector`` where it is. The levels
come from the configuration's anchor strides (``2 ** level``). The backbone,
the convolutions, BN, the fusion node and the resamples are ``model.py``'s;
this file adds the BiFPN layer for any level range and the heads with a BN
per level. Float32, NCHW inside; run with TF32 off.

The BiFPN graph is google/automl's ``bifpn_config(min_level, max_level)``: the
first layer makes P3..P5 from 1x1 conv + BN of C3..C5 (P4 and P5 a second
pair for their bottom-up node), P6 from a 1x1 conv + BN of C5 and a stride-2
max-pool, and each level above P6 by a max-pool of the one below; then
- top-down, from P(max-1) down to P3: one node a level, fusing the level's
  last node and the nearest-upsampled last node of the level above;
- bottom-up, from P4 up to P(max): one node a level, fusing every node of
  the level so far and the max-pooled last node of the level below.
A node is (sum, or relu-weighted sum) -> swish -> separable conv -> BN.

Parameter and buffer names are the port's unfused ``EfficientDet``'s (each
node ``bifpn.layer{i}.p{l}_td`` or ``p{l}_out``), so one state dict loads
into both. Departures from automl, both the port's:
- anchor ratios are written height over width (automl lists 1.0, 2.0, 0.5
  as width over height), which gives the same nine anchors in another order;
- SAME padding is flax's rule, the smaller half before (and -inf around a
  max-pool), which is TF's at the even sizes these levels have.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import B0_BLOCKS, EFFICIENTNET_PARAMS, Config, round_filters
from .model import (BatchNorm, Conv2d, EfficientNet, FusedNode, Quant, SeparableConv,
                    maxpool_down, upsample_to)


def levels_of(cfg: Config) -> Tuple[int, int]:
    """(min_level, max_level) of the configuration's anchor strides."""
    return int(math.log2(cfg.strides[0])), int(math.log2(cfg.strides[-1]))


def bifpn_nodes(min_level: int, max_level: int) -> List[Tuple[str, int, List[int]]]:
    """(name, level, graph ids of its inputs) of each node, in build order:
    the input levels are ids 0..L-1, the nodes L, L+1, ..."""
    n = max_level - min_level + 1
    at: Dict[int, List[int]] = {lvl: [lvl - min_level] for lvl in range(min_level, max_level + 1)}
    nodes = []
    for lvl in range(max_level - 1, min_level - 1, -1):
        nodes.append(("p%d_%s" % (lvl, "out" if lvl == min_level else "td"), lvl,
                      [at[lvl][-1], at[lvl + 1][-1]]))
        at[lvl].append(n + len(nodes) - 1)
    for lvl in range(min_level + 1, max_level + 1):
        nodes.append(("p%d_out" % lvl, lvl, at[lvl] + [at[lvl - 1][-1]]))
        at[lvl].append(n + len(nodes) - 1)
    return nodes


class BiFPNLayer(nn.Module):
    def __init__(self, width: int, first: bool, taps, cfg: Config, quant: Quant):
        super().__init__()
        self.first = first
        self.min_level, self.max_level = levels_of(cfg)
        if first:
            c3, c4, c5 = taps
            for name, c in (("p3_in", c3), ("p4_in_td", c4), ("p4_in_bu", c4),
                            ("p5_in_td", c5), ("p5_in_bu", c5), ("p6_in", c5)):
                self.add_module(f"{name}_conv", Conv2d(c, width, 1, quant=quant))
                self.add_module(f"{name}_bn", BatchNorm(width, cfg.bn_epsilon, cfg.bn_momentum))
        self.nodes = bifpn_nodes(self.min_level, self.max_level)
        for name, _, inputs in self.nodes:
            self.add_module(name, FusedNode(width, len(inputs), cfg, quant))

    def _in(self, x, name):
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))

    def forward(self, feats):
        bottom_up_input = {}
        if self.first:
            c3, c4, c5 = feats
            graph = [self._in(c3, "p3_in"), self._in(c4, "p4_in_td"), self._in(c5, "p5_in_td")]
            p = maxpool_down(self._in(c5, "p6_in"))
            graph.append(p)
            for _ in range(7, self.max_level + 1):
                p = maxpool_down(p)
                graph.append(p)
            bottom_up_input = {4: self._in(c4, "p4_in_bu"), 5: self._in(c5, "p5_in_bu")}
        else:
            graph = list(feats)
        n = len(graph)
        for name, level, inputs in self.nodes:
            xs = [graph[i] for i in inputs]
            if len(graph) - n < self.max_level - self.min_level:  # top-down
                xs[-1] = upsample_to(xs[-1], xs[0].shape[-2], xs[0].shape[-1])
            else:
                xs[-1] = maxpool_down(xs[-1])
                if level in bottom_up_input:
                    xs[0] = bottom_up_input[level]
            graph.append(getattr(self, name)(xs))
        return graph[-(self.max_level - self.min_level + 1):]


class Head(nn.Module):
    """Depth-d separable 3x3 convs shared over the levels, a BN per level
    and depth, swish, then the final separable conv to A*out channels."""

    def __init__(self, width: int, depth: int, out: int, cfg: Config, quant: Quant):
        super().__init__()
        self.depth, self.quant = depth, quant
        for i in range(depth):
            self.add_module(f"conv{i}", SeparableConv(width, width, quant))
            for lvl in range(len(cfg.strides)):
                self.add_module(f"bn_l{lvl}_d{i}", BatchNorm(width, cfg.bn_epsilon, cfg.bn_momentum))
        self.final = SeparableConv(width, out * cfg.num_anchors, quant)

    def forward(self, feats):
        outs = []
        for lvl, x in enumerate(feats):
            for i in range(self.depth):
                x = F.silu(getattr(self, f"bn_l{lvl}_d{i}")(getattr(self, f"conv{i}")(x)))
            y = self.final(x).permute(0, 2, 3, 1)
            outs.append(self.quant(y) if self.quant is not None else y)
        return outs  # per level (B, H, W, A*out)


class Detector(nn.Module):
    """Backbone -> BiFPN over the configuration's levels -> class and box
    heads, on normalised NHWC images; ``model.Detector``'s outputs."""

    def __init__(self, cfg: Config, quant: Quant = None):
        super().__init__()
        self.config = cfg
        width, _ = EFFICIENTNET_PARAMS[cfg.backbone]
        taps = tuple(round_filters(B0_BLOCKS[s].output_filters, width) for s in (2, 4, 6))
        self.backbone = EfficientNet(cfg, quant)
        self.bifpn = nn.Module()
        for i in range(cfg.bifpn_depth):
            self.bifpn.add_module(f"layer{i}", BiFPNLayer(cfg.bifpn_width, i == 0, taps, cfg, quant))
        self.class_net = nn.Module()
        self.class_net.net = Head(cfg.bifpn_width, cfg.head_depth, cfg.num_classes, cfg, quant)
        self.box_net = nn.Module()
        self.box_net.net = Head(cfg.bifpn_width, cfg.head_depth, 4, cfg, quant)

    def forward(self, images: torch.Tensor, levels: bool = False, generator=None):
        feats = self.backbone(images.permute(0, 3, 1, 2), generator)
        for i in range(self.config.bifpn_depth):
            feats = getattr(self.bifpn, f"layer{i}")(feats)
        cls, box = self.class_net.net(feats), self.box_net.net(feats)
        if levels:
            return cls, box
        c = self.config.num_classes
        return (torch.cat([x.reshape(x.shape[0], -1, c) for x in cls], 1),
                torch.cat([x.reshape(x.shape[0], -1, 4) for x in box], 1))
