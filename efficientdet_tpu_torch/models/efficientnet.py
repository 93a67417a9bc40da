"""EfficientNet-B0..B7 backbone, inference forward, NCHW inside.

Counterpart of the JAX package's ``models/efficientnet.py``: stem 3x3/s2
conv, 7 MBConv stages with compound ``round_filters``/``round_repeats``
scaling, squeeze-excite ratio 0.25, swish, and the C3/C4/C5 taps after stages
3, 5 and 7. Submodule names are the flax ones, so utils/convert.py maps a
flax variables tree onto this module key for key. Stochastic depth is a
training feature and is off here; training arrives with a later slice.

``fuse_bn=True`` builds the inference-folded variant: every conv carries a
bias and no BatchNorm exists (utils/fold_bn.py makes its weights).
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
from .conv import Conv2d
from .normalization import TpuBatchNorm


def _bn(channels: int, eps: float, fuse_bn: bool) -> nn.Module:
    return nn.Identity() if fuse_bn else TpuBatchNorm(channels, eps)


class SqueezeExcite(nn.Module):
    """Global mean (f32) -> reduce 1x1 -> swish -> expand 1x1 -> sigmoid gate."""

    def __init__(self, channels: int, num_reduced: int):
        super().__init__()
        self.reduce = Conv2d(channels, num_reduced, 1)
        self.expand = Conv2d(num_reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = torch.mean(x, dim=(2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)
        se = self.expand(F.silu(self.reduce(se)))
        return x * torch.sigmoid(se)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck: expand 1x1 -> depthwise kxk -> SE -> project."""

    def __init__(self, config: BlockConfig, input_filters: int,
                 output_filters: int, strides: int, bn_epsilon: float = 1e-3,
                 fuse_bn: bool = False):
        super().__init__()
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        if self.has_expand:
            x = F.silu(self.expand_bn(self.expand_conv(x)))
        x = F.silu(self.depthwise_bn(self.depthwise_conv(x)))
        if self.has_se:
            x = self.se(x)
        x = self.project_bn(self.project_conv(x))
        if self.residual:
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """Backbone (B, 3, S, S) -> (C3, C4, C5), NCHW, in the input's dtype."""

    def __init__(self, model_name: str = "efficientnet-b0",
                 bn_epsilon: float = 1e-3, fuse_bn: bool = False):
        super().__init__()
        width, depth, _ = EFFICIENTNET_PARAMS[model_name]
        table = BACKBONE_BLOCK_TABLES[model_name]
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
                self.add_module(name, MBConvBlock(
                    cfg,
                    input_filters=in_f if r == 0 else out_f,
                    output_filters=out_f,
                    strides=cfg.strides if r == 0 else 1,
                    bn_epsilon=bn_epsilon,
                    fuse_bn=fuse_bn,
                ))
                self.block_names.append(name)
            tap = {2: "C3", 4: "C4", 6: "C5"}.get(stage_idx)
            if tap:
                self.tap_after[self.block_names[-1]] = tap

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        taps = {}
        for name in self.block_names:
            x = getattr(self, name)(x)
            if name in self.tap_after:
                taps[self.tap_after[name]] = x
        return taps["C3"], taps["C4"], taps["C5"]
