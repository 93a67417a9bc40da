"""BiFPN with fast-normalised weighted fusion, NCHW, over P3 up to any max level.

Counterpart of the JAX package's ``models/bifpn.py``, generalised from P3..P7
to P3..P``max_level`` as google/automl's ``bifpn_config(min_level,
max_level)`` builds the graph. Per layer (paper Fig. 2): the first layer
builds P3..P5 from 1x1 conv+BN of C3..C5 (P4/P5 get separate convs for the
top-down node and the bottom-up skip), P6 = maxpool of conv+BN(C5), and each
level above P6 is a maxpool of the one below; then

  top-down:  one node a level from P(max-1) down to P3, each fusing its
             level's last node and the upsampled node of the level above
             (P6td = F(P6, up(P7)) ... P3out = F(P3, up(P4td)) for P3..P7)
  bottom-up: one node a level from P4 up to P(max), each fusing all its
             level's nodes so far and the max-pooled output of the level
             below (P4out = F(P4, P4td, down(P3out)) ... P7out = F(P7,
             down(P6out)) for P3..P7)

with F = relu-weighted fusion (eps 1e-4; each ``w_i / norm`` is cast to the
input dtype) -> swish -> SeparableConv 3x3 -> BN. ``weighted=False`` (D6,
D7, D7x) sums the inputs instead. The node plan (:func:`node_plan`) is made
once a layer; for P3..P7 it gives the eight nodes, names and order of the
five-level BiFPN, so D0..D7 weights load unchanged. With ``remat`` each
layer is recomputed in the backward pass (models/remat.py).

Where a node's BN is folded and it runs with grad off (:func:`node_folds`),
one op of ``ops/bifpn_node.py`` resamples its moved input, fuses and swishes
in one pass (the kernel reads the moved input at its own level); elsewhere
ATen resamples it and :func:`fuse` follows.

Spans (``utils/profiling.span``): ``bifpn.fuse`` around each node's pass,
the moved input's resample included where the op takes it, else its sum and
swish; ``bifpn.resample`` around the first layer's pools to P6 and up and
each resample the op does not take. Every node counts in ``fuse.sum`` or
``fuse.weighted``, whichever path runs it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.bifpn_node import bifpn_node, fusion
from ..ops.resample import downsample_maxpool, upsample_to
from ..parallel.context import active_context
from ..utils.profiling import span
from .conv import Conv2d, SeparableConv
from .normalization import TpuBatchNorm
from .remat import remat as _remat


def _count(weights: Optional[torch.Tensor]) -> None:
    if weights is None:
        fuse.sum += 1
    else:
        fuse.weighted += 1


def fuse(inputs: Sequence[torch.Tensor], weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One node's fusion and swish: the inputs summed, relu-weighted with
    fast normalisation where ``weights`` is given."""
    _count(weights)
    return fusion(inputs, weights)


fuse.sum = 0
fuse.weighted = 0


def node_folds(node: "FusedNode", kept: Sequence[torch.Tensor], moved: torch.Tensor,
               up: bool) -> bool:
    """Whether the node takes the one-pass op (ops/bifpn_node.py): its BN
    folded, grad off, on the CPU (the op's twin) or the card, float32 or
    bf16 maps of one dtype with C a multiple of 8, each fine size exactly
    twice the coarse one, float32 fusion weights, and no map a band of a
    spatial context (its halo comes from the neighbouring ranks). Training,
    remat, the unfused model, banded maps and other sizes keep ATen's
    resample and :func:`fuse`. The layout is not asked: the op copies any
    but channels-last, the detector's own."""
    x = kept[0]
    fine, coarse = (x, moved) if up else (moved, x)
    ctx = active_context()
    return (isinstance(node.bn, nn.Identity) and not torch.is_grad_enabled()
            and x.device.type in ("cpu", "cuda") and x.dtype in (torch.float32, torch.bfloat16)
            and x.shape[1] % 8 == 0
            and all(t.shape == x.shape and t.dtype == x.dtype for t in kept)
            and moved.dtype == x.dtype and moved.shape[:2] == x.shape[:2]
            and fine.shape[-2] == 2 * coarse.shape[-2] and fine.shape[-1] == 2 * coarse.shape[-1]
            and (not node.weighted or node.fusion_weights.dtype == torch.float32)
            and not (ctx is not None and any(ctx.banded(t) for t in (*kept, moved))))


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
        with span("bifpn.fuse"):
            x = fuse(inputs, self.fusion_weights if self.weighted else None)
        return self.bn(self.conv(x))

    def resampling(self, kept: Sequence[torch.Tensor], moved: torch.Tensor,
                   up: bool) -> torch.Tensor:
        """The node on its level's inputs ``kept`` and ``moved`` from the
        level above (``up``: upsampled to kept[0]'s size) or below
        (max-pooled): one op where :func:`node_folds`, else ATen's resample
        and :meth:`forward`."""
        if len(kept) + 1 != self.num_inputs or not node_folds(self, kept, moved, up):
            with span("bifpn.resample"):
                ref = kept[0]
                moved = (upsample_to(moved, ref.shape[-2], ref.shape[-1]) if up
                         else downsample_maxpool(moved))
            return self(list(kept) + [moved])
        weights = self.fusion_weights if self.weighted else None
        _count(weights)
        with span("bifpn.fuse"):
            x = bifpn_node(kept, moved, up, weights)
        return self.bn(self.conv(x))


def node_plan(min_level: int = 3, max_level: int = 7) -> Tuple[Tuple[str, int, Tuple[int, ...]], ...]:
    """automl's ``bifpn_config``: (name, level, inputs) of each fusion node,
    in the order a layer runs them. The graph numbers the input levels
    P``min_level``..P``max_level`` 0..L-1 and each node from L on; a node's
    last input is resampled to its level (upsampled on the top-down path,
    max-pooled on the bottom-up one)."""
    n = max_level - min_level + 1
    ids = {lvl: [lvl - min_level] for lvl in range(min_level, max_level + 1)}
    plan = []
    for lvl in range(max_level - 1, min_level - 1, -1):
        name = f"p{lvl}_out" if lvl == min_level else f"p{lvl}_td"
        plan.append((name, lvl, (ids[lvl][-1], ids[lvl + 1][-1])))
        ids[lvl].append(n + len(plan) - 1)
    for lvl in range(min_level + 1, max_level + 1):
        plan.append((f"p{lvl}_out", lvl, tuple(ids[lvl]) + (ids[lvl - 1][-1],)))
        ids[lvl].append(n + len(plan) - 1)
    return tuple(plan)


class BiFPNLayer(nn.Module):
    """One bidirectional pass over P3..P``max_level``."""

    def __init__(self, features: int, first: bool, in_channels=None,
                 weighted: bool = True, bn_epsilon: float = 1e-3,
                 fuse_bn: bool = False, max_level: int = 7):
        super().__init__()
        if max_level < 6:
            raise ValueError(f"the BiFPN needs P3..P6 at least, got max_level {max_level}")
        self.first = first
        self.num_levels = n = max_level - 2
        if first:
            c3, c4, c5 = in_channels
            for name, ch in (("p3_in", c3), ("p4_in_td", c4), ("p4_in_bu", c4),
                             ("p5_in_td", c5), ("p5_in_bu", c5), ("p6_in", c5)):
                self.add_module(f"{name}_conv", Conv2d(ch, features, 1))
                self.add_module(
                    f"{name}_bn",
                    nn.Identity() if fuse_bn else TpuBatchNorm(features, bn_epsilon),
                )
        plan = node_plan(3, max_level)
        # the first layer's graph holds the bottom-up skips of P4 and P5
        # (their own 1x1 convs) after the input levels, so its nodes start
        # two places later
        extra = 2 if first else 0
        bu_skip = {4: n, 5: n + 1} if first else {}
        steps = []
        for j, (name, level, ids) in enumerate(plan):
            node = FusedNode(features, len(ids), weighted, bn_epsilon, fuse_bn)
            self.add_module(name, node)
            ids = tuple(i if i < n else i + extra for i in ids)
            top_down = j < n - 1
            if not top_down and level in bu_skip:
                ids = (bu_skip[level],) + ids[1:]
            # (node, inputs taken as they are, the input resampled, upsample
            # or max-pool); an upsample takes the first input's size
            steps.append((node, ids[:-1], ids[-1], top_down))
        self._steps = tuple(steps)
        self._out = n + extra + n - 2  # the graph's index of P3's output

    def _conv_bn(self, x, name):
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.first:
            c3, c4, c5 = feats
            graph = [self._conv_bn(c3, "p3_in"), self._conv_bn(c4, "p4_in_td")]
            p4_in_bu = self._conv_bn(c4, "p4_in_bu")
            graph.append(self._conv_bn(c5, "p5_in_td"))
            p5_in_bu = self._conv_bn(c5, "p5_in_bu")
            x = self._conv_bn(c5, "p6_in")
            for _ in range(self.num_levels - 3):
                with span("bifpn.resample"):
                    x = downsample_maxpool(x)
                graph.append(x)
            graph += (p4_in_bu, p5_in_bu)
        else:
            graph = list(feats)
        for node, kept, src, top_down in self._steps:
            graph.append(node.resampling([graph[i] for i in kept], graph[src], top_down))
        return graph[self._out:]


class BiFPN(nn.Module):
    """Stack of ``depth`` BiFPN layers: (C3, C4, C5) -> [P3..P``max_level``]."""

    def __init__(self, features: int, depth: int, in_channels,
                 weighted: bool = True, bn_epsilon: float = 1e-3,
                 fuse_bn: bool = False, remat: bool = False, max_level: int = 7):
        super().__init__()
        self.depth = depth
        self.remat = remat
        for i in range(depth):
            self.add_module(f"layer{i}", BiFPNLayer(
                features, first=(i == 0), in_channels=in_channels,
                weighted=weighted, bn_epsilon=bn_epsilon, fuse_bn=fuse_bn,
                max_level=max_level,
            ))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        for i in range(self.depth):
            layer = getattr(self, f"layer{i}")
            feats = _remat(layer, feats) if self.remat else layer(feats)
        return list(feats)
