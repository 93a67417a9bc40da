"""EfficientDet assembly, the D0..D7 builders and the prediction entry points.

Counterpart of the JAX package's ``models/detector.py``. The module holds its
weights, so the prediction function is ``predict(images)`` rather than
``predict(variables, images)``. Images at the public functions are
(B, S, S, 3) NHWC, uint8 RGB; detections are (boxes (B,100,4),
scores (B,100), classes (B,100), num_valid (B,)), as in the JAX package.

Entry points run on the GPU: ``device=None`` means ``"cuda"``, and with no
GPU they raise. Only an explicit ``device="cpu"`` runs on the CPU, where the
kernels' plain versions stand in for them.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..anchors import anchors_for_shape
from ..configs import (
    BACKBONE_BLOCK_TABLES,
    EFFICIENTNET_PARAMS,
    EvalConfig,
    ModelConfig,
    round_filters,
)
from ..ops.nms import batched_filter_from_anchor_major_levels, batched_filter_from_logits
from ..ops.preprocess import preprocess_batch_fixed
from .bifpn import BiFPN
from .conv import Conv2d
from .efficientnet import EfficientNet
from .heads import BoxNet, ClassNet, prior_prob_bias

FRONT_ENDS = ("anchor_major", "concat")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the GPU; raise rather than fall back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def _tap_channels(backbone: str) -> Tuple[int, int, int]:
    width, _, _ = EFFICIENTNET_PARAMS[backbone]
    table = BACKBONE_BLOCK_TABLES[backbone]
    return tuple(round_filters(table[s].output_filters, width) for s in (2, 4, 6))


class EfficientDet(nn.Module):
    """Backbone -> BiFPN -> shared heads, on NHWC normalised images."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype = torch.float32,
                 fuse_bn: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.fuse_bn = fuse_bn
        self._anchor_cache = {}
        eps = config.bn_epsilon
        self.backbone = EfficientNet(config.backbone, eps, fuse_bn)
        self.bifpn = BiFPN(
            config.bifpn_width, config.bifpn_depth, _tap_channels(config.backbone),
            config.weighted_bifpn, eps, fuse_bn,
        )
        a, levels = config.num_anchors_per_cell, config.num_levels
        self.class_net = ClassNet(
            config.bifpn_width, config.head_depth, config.num_classes, a, levels,
            bn_epsilon=eps, fuse_bn=fuse_bn,
        )
        self.box_net = BoxNet(
            config.bifpn_width, config.head_depth, a, levels, eps, fuse_bn,
        )

    def anchors(self, size: int, device: torch.device) -> torch.Tensor:
        """The (A_total, 4) anchors of a size x size image, made once per
        size and device."""
        key = (size, device)
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.from_numpy(
                anchors_for_shape((size, size), self.config.anchor)
            ).to(device)
        return self._anchor_cache[key]

    def features(self, images: torch.Tensor):
        """(B, S, S, 3) normalised -> BiFPN outputs [P3..P7], NCHW."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        return self.bifpn(list(self.backbone(x)))

    def forward(self, images: torch.Tensor, anchor_major: bool = False):
        """images (B, S, S, 3) normalised -> (class out, box out).

        ``anchor_major=False``: (cls_logits (B, A, C), box_deltas (B, A, 4)).
        ``anchor_major=True``: ((z, amax_img, hws), (zb, hws)), the input of
        ops/nms.py's anchor-major front end.
        """
        feats = self.features(images)
        return (self.class_net(feats, anchor_major),
                self.box_net(feats, anchor_major))


@torch.no_grad()
def init_weights(model: EfficientDet, seed: int = 0) -> EfficientDet:
    """Random weights from ``seed``, drawn on the CPU so every device agrees.

    Convs: truncated-normal variance scaling on fan-in, scale 2 in the
    backbone and 1 in the BiFPN and heads. That keeps activations near unit
    scale through a network whose BNs hold their initial statistics, and
    the class logits spread a little around the prior (fan-out scaling, the
    EfficientNet initialiser, makes them vanish, and every logit would equal
    the bias). Biases are zero except the class head's final bias, the
    prior -log(99). BNs: scale 1, bias 0, mean 0, var 1.
    """
    gen = torch.Generator().manual_seed(seed)
    for part, scale in ((model.backbone, 2.0), (model.bifpn, 1.0),
                        (model.class_net, 1.0), (model.box_net, 1.0)):
        for mod in part.modules():
            if isinstance(mod, Conv2d):
                _, in_per_group, kh, kw = mod.weight.shape
                std = (scale / (in_per_group * kh * kw)) ** 0.5 / 0.87962566103423978
                w = torch.empty(mod.weight.shape).normal_(generator=gen).clamp_(-2, 2)
                mod.weight.copy_(w * std)
                if mod.bias is not None:
                    mod.bias.zero_()
    model.class_net.net.final.pointwise.bias.fill_(prior_prob_bias(model.class_net.prior))
    return model


def build_efficientdet(
    phi: int,
    num_classes: int = 90,
    weighted_bifpn: bool | None = None,
    dtype: torch.dtype = torch.float32,
    image_size: int | None = None,
    device=None,
    seed: int = 0,
) -> Tuple[EfficientDet, ModelConfig]:
    """Build EfficientDet-D``phi`` with random weights from ``seed``."""
    config = ModelConfig.for_phi(
        phi, num_classes=num_classes, weighted_bifpn=weighted_bifpn,
        image_size=image_size,
    )
    device = resolve_device(device)
    model = init_weights(EfficientDet(config, dtype), seed)
    return model.to(device).eval(), config


def _named_builder(phi):
    def build(num_classes: int = 90, **kw):
        return build_efficientdet(phi, num_classes=num_classes, **kw)

    build.__name__ = f"efficientdet_d{phi}"
    build.__doc__ = f"Build EfficientDet-D{phi} (see build_efficientdet)."
    return build


efficientdet_d0 = _named_builder(0)
efficientdet_d1 = _named_builder(1)
efficientdet_d2 = _named_builder(2)
efficientdet_d3 = _named_builder(3)
efficientdet_d4 = _named_builder(4)
efficientdet_d5 = _named_builder(5)
efficientdet_d6 = _named_builder(6)
efficientdet_d7 = _named_builder(7)


@torch.inference_mode()
def predict_pipeline(
    model: EfficientDet,
    images: torch.Tensor,
    eval_config: EvalConfig = EvalConfig(),
    preprocess: bool = True,
    front_end: str | None = None,
):
    """[normalise ->] forward -> decode -> NMS, on the model's device.

    ``front_end``: ``"anchor_major"`` (default, through both kernels) or
    ``"concat"`` (reference-shaped (B, A, C) tensors); both give the same
    detections up to tie order.
    """
    size = images.shape[1]
    front_end = front_end or "anchor_major"
    if front_end not in FRONT_ENDS:
        raise ValueError(f"unknown front_end {front_end!r}")
    device = next(model.parameters()).device
    if images.device != device:
        raise ValueError(f"images are on {images.device}, the model on {device}")
    if preprocess:
        images = preprocess_batch_fixed(images, dtype=model.dtype)
    anchors = model.anchors(size, device)
    if front_end == "anchor_major":
        cls_out, box_out = model(images, anchor_major=True)
        return batched_filter_from_anchor_major_levels(
            anchors, box_out, cls_out, (size, size), eval_config
        )
    cls_logits, box_deltas = model(images)
    return batched_filter_from_logits(
        anchors, box_deltas, cls_logits, (size, size), eval_config
    )


def make_predict_fn(
    model: EfficientDet,
    eval_config: EvalConfig = EvalConfig(),
    preprocess: bool = True,
    front_end: str | None = None,
):
    """Return ``predict(images) -> detections`` over ``model``'s weights."""

    def predict(images: torch.Tensor):
        return predict_pipeline(model, images, eval_config, preprocess, front_end)

    return predict


def fuse_for_inference(model: EfficientDet) -> EfficientDet:
    """Fold every BatchNorm into its conv; the same function, no BN ops.

    Head BNs fold into per-level copies of the shared pointwise. Returns a
    new ``fuse_bn=True`` model on the same device, in eval mode.

    The folded conv weights and biases are stored in the compute dtype, the
    values each call would otherwise cast them to, so a call casts none.
    The heads' final pointwise biases stay float32: the head kernel adds
    them to its float32 sums.
    """
    from ..utils.fold_bn import fold_bn_state_dict

    device = next(model.parameters()).device
    fused = EfficientDet(model.config, model.dtype, fuse_bn=True)
    fused.load_state_dict(fold_bn_state_dict(model.state_dict(), eps=model.config.bn_epsilon))
    head_pointwise = {fused.class_net.net.final.pointwise, fused.box_net.net.final.pointwise}
    for mod in fused.modules():
        if isinstance(mod, Conv2d):
            mod.weight.data = mod.weight.data.to(model.dtype)
            if mod.bias is not None and mod not in head_pointwise:
                mod.bias.data = mod.bias.data.to(model.dtype)
    return fused.to(device).eval()

