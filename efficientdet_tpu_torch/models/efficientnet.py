"""EfficientNet-B0..B7 backbone, NCHW inside.

Counterpart of the JAX package's ``models/efficientnet.py``: stem 3x3/s2
conv, 7 MBConv stages with compound ``round_filters``/``round_repeats``
scaling, squeeze-excite ratio 0.25, swish, and the C3/C4/C5 taps after stages
3, 5 and 7. Submodule names are the flax ones, so utils/convert.py maps a
flax variables tree onto this module key for key.

In training mode a residual block drops its branch per sample (stochastic
depth): a (B, 1, 1, 1) Bernoulli keep mask divided by the block's survival
probability ``1 - (1 - survival_prob) * idx / total``. The masks are drawn
from the caller's ``torch.Generator`` before the block runs, so a block
recomputed by remat (``remat_max_stage``) sees the same mask.

Under a data-parallel ``parallel_context`` the masks are drawn for the
global batch and each rank keeps its rows, so N ranks draw what one process
draws for the concatenated batch; under a spatial one the SE's mean is the
bands' sums all-reduced (parallel/context.py).

``fuse_bn=True`` builds the inference-folded variant: every conv carries a
bias and no BatchNorm exists (utils/fold_bn.py makes its weights). Called
with grad off, its stem, expand and project convs run without their biases,
and one epilogue pass each adds the bias, the SiLU and the residual
(models/conv.py ``folds``, ops/conv_epilogue.py); the expand pass of a
stride-2 block also writes the depthwise conv's SAME pad. Its depthwise conv
runs in one kernel with its bias and SiLU, which also sums the output's
channels for the squeeze-excite's mean (models/conv.py ``depthwise_folds``,
ops/depthwise_conv.py).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import (
    BACKBONE_BLOCK_TABLES,
    EFFICIENTNET_PARAMS,
    BlockConfig,
    round_filters,
    round_repeats,
)
from ..ops.conv_epilogue import conv_epilogue
from ..ops.depthwise_conv import depthwise_conv, se_mean
from ..parallel.context import active_context
from .conv import Conv2d, depthwise_folds, folds
from .normalization import TpuBatchNorm
from .remat import remat


def _bn(channels: int, eps: float, fuse_bn: bool) -> nn.Module:
    return nn.Identity() if fuse_bn else TpuBatchNorm(channels, eps)


def _conv_bn(conv: Conv2d, bn: nn.Module, x: torch.Tensor, silu: bool,
             residual: torch.Tensor | None = None, padded: bool = False,
             pads=None) -> torch.Tensor:
    """``silu?(bn(conv(x))) [+ residual]``. Where the conv :func:`folds`:
    the conv without its bias, then one epilogue pass, in place or into a
    buffer padded by ``pads`` (the next conv's ``explicit_pads``).
    ``padded``: ``x`` already holds this conv's SAME pad."""
    if folds(conv, x):
        y = conv(x, bias=False, padded=padded)
        return conv_epilogue(y, conv.bias.to(y.dtype), residual, silu, pads)
    x = bn(conv(x, padded=padded))
    if silu:
        x = F.silu(x)
    return x if residual is None else x + residual


def _depthwise_conv_bn(conv: Conv2d, bn: nn.Module, x: torch.Tensor, padded: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """``silu(bn(conv(x)))`` of the depthwise conv, and the SE's channel sums
    where the one-pass depthwise kernel takes it (models/conv.py
    ``depthwise_folds``), else None. ``padded``: ``x`` already holds the
    conv's SAME pad."""
    if depthwise_folds(conv, x):
        pads = (0, 0, 0, 0) if padded else conv.same_pads(x)
        return depthwise_conv(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), conv.stride,
                              pads)
    return _conv_bn(conv, bn, x, True, padded=padded), None


class SqueezeExcite(nn.Module):
    """Global mean (f32) -> reduce 1x1 -> swish -> expand 1x1 -> sigmoid gate."""

    def __init__(self, channels: int, num_reduced: int):
        super().__init__()
        self.reduce = Conv2d(channels, num_reduced, 1)
        self.expand = Conv2d(num_reduced, channels, 1)

    def forward(self, x: torch.Tensor, sums: torch.Tensor | None = None) -> torch.Tensor:
        """``sums``: the depthwise kernel's float32 channel sums of ``x``,
        scaled to shares of the mean (ops/depthwise_conv.py), which give the
        mean without a pass over ``x``; or None."""
        ctx = active_context()
        if sums is not None:
            se = se_mean(sums).to(x.dtype)
        elif ctx is not None and ctx.banded(x):
            se = ctx.spatial_mean(x).to(x.dtype)
        else:
            se = torch.mean(x, dim=(2, 3), keepdim=True,
                            dtype=torch.promote_types(x.dtype, torch.float32)).to(x.dtype)
        se = self.expand(F.silu(self.reduce(se)))
        return x * torch.sigmoid(se)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck: expand 1x1 -> depthwise kxk -> SE -> project."""

    def __init__(self, config: BlockConfig, input_filters: int,
                 output_filters: int, strides: int, bn_epsilon: float = 1e-3,
                 fuse_bn: bool = False, survival_prob: float = 1.0):
        super().__init__()
        self.survival_prob = survival_prob
        filters = input_filters * config.expand_ratio
        self.has_expand = config.expand_ratio != 1
        if self.has_expand:
            self.expand_conv = Conv2d(input_filters, filters, 1, bias=fuse_bn)
            self.expand_bn = _bn(filters, bn_epsilon, fuse_bn)
        self.depthwise_conv = Conv2d(
            filters, filters, config.kernel_size, stride=strides,
            groups=filters, bias=fuse_bn,
        )
        self.depthwise_bn = _bn(filters, bn_epsilon, fuse_bn)
        self.has_se = 0 < config.se_ratio <= 1
        if self.has_se:
            self.se = SqueezeExcite(
                filters, max(1, int(input_filters * config.se_ratio))
            )
        self.project_conv = Conv2d(filters, output_filters, 1, bias=fuse_bn)
        self.project_bn = _bn(output_filters, bn_epsilon, fuse_bn)
        self.residual = strides == 1 and input_filters == output_filters

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        """``keep``: the (B, 1, 1, 1) stochastic-depth mask of a residual
        block in training, or None."""
        inputs = x
        pads = None
        if self.has_expand:
            # a folded expand writes the stride-2 depthwise conv's SAME pad
            if folds(self.expand_conv, x):
                pads = self.depthwise_conv.explicit_pads(x)
            x = _conv_bn(self.expand_conv, self.expand_bn, x, True, pads=pads)
        x, sums = _depthwise_conv_bn(self.depthwise_conv, self.depthwise_bn, x,
                                     padded=pads is not None)
        if self.has_se:
            x = self.se(x, sums)
        residual = inputs if self.residual and keep is None else None
        x = _conv_bn(self.project_conv, self.project_bn, x, False, residual)
        if self.residual and keep is not None:
            x = x * keep / self.survival_prob + inputs
        return x


class EfficientNet(nn.Module):
    """Backbone (B, 3, S, S) -> (C3, C4, C5), NCHW, in the input's dtype."""

    def __init__(self, model_name: str = "efficientnet-b0",
                 bn_epsilon: float = 1e-3, fuse_bn: bool = False,
                 survival_prob: float = 0.8, remat: bool = False,
                 remat_max_stage: int = 7):
        super().__init__()
        width, depth, _ = EFFICIENTNET_PARAMS[model_name]
        table = BACKBONE_BLOCK_TABLES[model_name]
        total = sum(round_repeats(c.num_repeat, depth) for c in table)
        self.remat_blocks = set()
        stem = round_filters(table[0].input_filters, width)
        self.stem_conv = Conv2d(3, stem, 3, stride=2, bias=fuse_bn)
        self.stem_bn = _bn(stem, bn_epsilon, fuse_bn)
        self.block_names = []
        self.tap_after = {}  # block name -> tap name
        for stage_idx, cfg in enumerate(table):
            in_f = round_filters(cfg.input_filters, width)
            out_f = round_filters(cfg.output_filters, width)
            for r in range(round_repeats(cfg.num_repeat, depth)):
                name = f"stage{stage_idx + 1}_block{r}"
                idx = len(self.block_names)
                self.add_module(name, MBConvBlock(
                    cfg,
                    input_filters=in_f if r == 0 else out_f,
                    output_filters=out_f,
                    strides=cfg.strides if r == 0 else 1,
                    bn_epsilon=bn_epsilon,
                    fuse_bn=fuse_bn,
                    survival_prob=1.0 - (1.0 - survival_prob) * idx / total,
                ))
                self.block_names.append(name)
                if remat and stage_idx + 1 <= remat_max_stage:
                    self.remat_blocks.add(name)
            tap = {2: "C3", 4: "C4", 6: "C5"}.get(stage_idx)
            if tap:
                self.tap_after[self.block_names[-1]] = tap

    def keep_masks(self, batch: int, device, generator=None):
        """The stochastic-depth keep masks of one forward, by block name:
        float32 (B, 1, 1, 1) in {0, 1}, drawn in block order for the
        residual blocks whose survival is below 1; empty in eval mode."""
        ctx = active_context()
        offset, total = (ctx and ctx.draw_rows(batch)) or (0, batch)
        masks = {}
        for name in self.block_names:
            block = getattr(self, name)
            if self.training and block.residual and block.survival_prob < 1.0:
                masks[name] = torch.empty((total, 1, 1, 1), device=device).bernoulli_(
                    block.survival_prob, generator=generator)[offset:offset + batch]
        return masks

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``generator``: where stochastic depth draws its masks in training
        (torch's default generator of the device when None)."""
        masks = self.keep_masks(x.shape[0], x.device, generator)
        x = _conv_bn(self.stem_conv, self.stem_bn, x, True)
        taps = {}
        for name in self.block_names:
            block = getattr(self, name)
            keep = masks.get(name)
            if keep is not None:
                keep = keep.to(x.dtype)
            x = remat(block, x, keep) if name in self.remat_blocks else block(x, keep)
            if name in self.tap_after:
                taps[self.tap_after[name]] = x
        return taps["C3"], taps["C4"], taps["C5"]
