"""EfficientDet in plain PyTorch, NCHW inside (a copy of the port's
``models/``, ``ops/preprocess.py`` and ``ops/resample.py``).

Parameter and buffer names are the port's unfused ``EfficientDet``'s, so
one state dict loads into both. The heads end in their ordinary final
separable convolution; :meth:`Detector.forward` returns the concatenated
(B, A, C) logits and (B, A, 4) deltas, or with ``levels=True`` each level's
(B, H, W, A*out) output, which the training loss reads.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import B0_BLOCKS, EFFICIENTNET_PARAMS, Config, round_filters, round_repeats

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FUSION_EPS = 1e-4
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def normalize(images: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> float32 ImageNet-normalised, NHWC."""
    x = images.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def same_pads(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def upsample_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if h == 2 * x.shape[-2] and w == 2 * x.shape[-1]:
        return F.interpolate(x, scale_factor=2.0, mode="nearest")
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


def maxpool_down(x: torch.Tensor) -> torch.Tensor:
    ph, pw = same_pads(x.shape[-2], 3, 2), same_pads(x.shape[-1], 3, 2)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


class Conv2d(nn.Module):
    """flax's SAME convolution; ``quant`` rounds its input and weight."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1,
                 bias: bool = True, quant: Quant = None):
        super().__init__()
        self.k, self.stride, self.groups, self.quant = k, stride, groups, quant
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        k, s = self.k, self.stride
        if s == 1 and k % 2 == 1:
            return F.conv2d(x, w, self.bias, 1, k // 2, 1, self.groups)
        ph, pw = same_pads(x.shape[-2], k, s), same_pads(x.shape[-1], k, s)
        return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, self.bias, s, 0, 1, self.groups)


class SeparableConv(nn.Module):
    def __init__(self, cin: int, cout: int, quant: Quant = None):
        super().__init__()
        self.depthwise = Conv2d(cin, cin, 3, groups=cin, bias=False, quant=quant)
        self.pointwise = Conv2d(cin, cout, 1, quant=quant)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class BatchNorm(nn.Module):
    """y = x * a + b with a = rsqrt(var + eps) * weight, b = bias - mean * a;
    in training the batch's biased statistics, and the running ones move by
    ``momentum``."""

    def __init__(self, c: int, eps: float, momentum: float):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        a = torch.rsqrt(var + self.eps) * self.weight
        b = self.bias - mean * a
        return x * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


class MBConv(nn.Module):
    def __init__(self, blk, cin: int, cout: int, stride: int, survival: float, cfg: Config,
                 quant: Quant):
        super().__init__()
        eps, mom = cfg.bn_epsilon, cfg.bn_momentum
        self.survival_prob = survival
        mid = cin * blk.expand_ratio
        self.has_expand = blk.expand_ratio != 1
        if self.has_expand:
            self.expand_conv = Conv2d(cin, mid, 1, bias=False, quant=quant)
            self.expand_bn = BatchNorm(mid, eps, mom)
        self.depthwise_conv = Conv2d(mid, mid, blk.kernel_size, stride, groups=mid, bias=False,
                                     quant=quant)
        self.depthwise_bn = BatchNorm(mid, eps, mom)
        self.se = nn.Module()
        self.se.reduce = Conv2d(mid, max(1, int(cin * blk.se_ratio)), 1, quant=quant)
        self.se.expand = Conv2d(max(1, int(cin * blk.se_ratio)), mid, 1, quant=quant)
        self.project_conv = Conv2d(mid, cout, 1, bias=False, quant=quant)
        self.project_bn = BatchNorm(cout, eps, mom)
        self.residual = stride == 1 and cin == cout

    def forward(self, x, keep=None):
        inputs = x
        if self.has_expand:
            x = F.silu(self.expand_bn(self.expand_conv(x)))
        x = F.silu(self.depthwise_bn(self.depthwise_conv(x)))
        se = x.mean(dim=(2, 3), keepdim=True)
        x = x * torch.sigmoid(self.se.expand(F.silu(self.se.reduce(se))))
        x = self.project_bn(self.project_conv(x))
        if self.residual:
            if keep is not None:
                x = x * keep / self.survival_prob
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    def __init__(self, cfg: Config, quant: Quant):
        super().__init__()
        width, depth = EFFICIENTNET_PARAMS[cfg.backbone]
        total = sum(round_repeats(b.num_repeat, depth) for b in B0_BLOCKS)
        stem = round_filters(B0_BLOCKS[0].input_filters, width)
        self.stem_conv = Conv2d(3, stem, 3, 2, bias=False, quant=quant)
        self.stem_bn = BatchNorm(stem, cfg.bn_epsilon, cfg.bn_momentum)
        self.names: List[str] = []
        self.taps = {}
        for s, blk in enumerate(B0_BLOCKS):
            cin, cout = round_filters(blk.input_filters, width), round_filters(blk.output_filters, width)
            for r in range(round_repeats(blk.num_repeat, depth)):
                name = f"stage{s + 1}_block{r}"
                survival = 1.0 - (1.0 - cfg.survival_prob) * len(self.names) / total
                self.add_module(name, MBConv(blk, cin if r == 0 else cout, cout,
                                             blk.strides if r == 0 else 1, survival, cfg, quant))
                self.names.append(name)
            if s in (2, 4, 6):
                self.taps[self.names[-1]] = len(self.taps)

    def forward(self, x, generator=None):
        masks = {}
        for name in self.names:  # drawn in block order before the blocks run
            blk = getattr(self, name)
            if self.training and blk.residual and blk.survival_prob < 1.0:
                masks[name] = torch.empty((x.shape[0], 1, 1, 1), device=x.device).bernoulli_(
                    blk.survival_prob, generator=generator)
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        taps = []
        for name in self.names:
            x = getattr(self, name)(x, masks.get(name))
            if name in self.taps:
                taps.append(x)
        return taps


class FusedNode(nn.Module):
    def __init__(self, width: int, n: int, cfg: Config, quant: Quant):
        super().__init__()
        self.weighted = cfg.weighted_bifpn
        if self.weighted:
            self.fusion_weights = nn.Parameter(torch.ones(n))
        self.conv = SeparableConv(width, width, quant)
        self.bn = BatchNorm(width, cfg.bn_epsilon, cfg.bn_momentum)

    def forward(self, inputs):
        if self.weighted:
            w = F.relu(self.fusion_weights)
            w = w / (w.sum() + FUSION_EPS)
            x = w[0] * inputs[0]
            for i in range(1, len(inputs)):
                x = x + w[i] * inputs[i]
        else:
            x = inputs[0]
            for t in inputs[1:]:
                x = x + t
        return self.bn(self.conv(F.silu(x)))


NODES = (("p6_td", 2), ("p5_td", 2), ("p4_td", 2), ("p3_out", 2),
         ("p4_out", 3), ("p5_out", 3), ("p6_out", 3), ("p7_out", 2))


class BiFPNLayer(nn.Module):
    def __init__(self, width: int, first: bool, taps, cfg: Config, quant: Quant):
        super().__init__()
        self.first = first
        if first:
            c3, c4, c5 = taps
            for name, c in (("p3_in", c3), ("p4_in_td", c4), ("p4_in_bu", c4),
                            ("p5_in_td", c5), ("p5_in_bu", c5), ("p6_in", c5)):
                self.add_module(f"{name}_conv", Conv2d(c, width, 1, quant=quant))
                self.add_module(f"{name}_bn", BatchNorm(width, cfg.bn_epsilon, cfg.bn_momentum))
        for name, n in NODES:
            self.add_module(name, FusedNode(width, n, cfg, quant))

    def _in(self, x, name):
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))

    def forward(self, feats):
        if self.first:
            c3, c4, c5 = feats
            p3, p4_td_in, p4_bu_in = self._in(c3, "p3_in"), self._in(c4, "p4_in_td"), self._in(c4, "p4_in_bu")
            p5_td_in, p5_bu_in = self._in(c5, "p5_in_td"), self._in(c5, "p5_in_bu")
            p6 = maxpool_down(self._in(c5, "p6_in"))
            p7 = maxpool_down(p6)
        else:
            p3, p4_td_in, p5_td_in, p6, p7 = feats
            p4_bu_in, p5_bu_in = p4_td_in, p5_td_in

        def up(x, like):
            return upsample_to(x, like.shape[-2], like.shape[-1])

        p6_td = self.p6_td([p6, up(p7, p6)])
        p5_td = self.p5_td([p5_td_in, up(p6_td, p5_td_in)])
        p4_td = self.p4_td([p4_td_in, up(p5_td, p4_td_in)])
        p3_out = self.p3_out([p3, up(p4_td, p3)])
        p4_out = self.p4_out([p4_bu_in, p4_td, maxpool_down(p3_out)])
        p5_out = self.p5_out([p5_bu_in, p5_td, maxpool_down(p4_out)])
        p6_out = self.p6_out([p6, p6_td, maxpool_down(p5_out)])
        p7_out = self.p7_out([p7, maxpool_down(p6_out)])
        return [p3_out, p4_out, p5_out, p6_out, p7_out]


class Head(nn.Module):
    """Depth-d separable 3x3 convs shared over the levels, a BN per level
    and depth, swish, then the final separable conv to A*out channels."""

    def __init__(self, width: int, depth: int, out: int, cfg: Config, quant: Quant):
        super().__init__()
        self.depth, self.out, self.quant = depth, out, quant
        for i in range(depth):
            self.add_module(f"conv{i}", SeparableConv(width, width, quant))
            for lvl in range(5):
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
    """Backbone -> BiFPN -> class and box heads, on normalised NHWC images."""

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
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.momentum = cfg.bn_momentum

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
