"""The two sides of a cell from its configuration file: the port's model
(the system under test) and the reference's configuration."""

from __future__ import annotations

import math

import torch

from ..reference.config import Config

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}  # a cell's "precision"

def reference_config(cfg: dict) -> Config:
    """The reference's shapes, read from the configuration file alone (its
    keys are google/automl's ``hparams_config.py`` names)."""
    return Config(
        phi=cfg["phi"], image_size=cfg["image_size"], backbone=cfg["backbone_name"],
        bifpn_width=cfg["fpn_num_filters"], bifpn_depth=cfg["fpn_cell_repeats"],
        head_depth=cfg["box_class_repeats"], anchor_scale=cfg["anchor_scale"],
        weighted_bifpn=cfg["fpn_weight_method"] == "fastattn", num_classes=cfg["num_classes"],
        strides=tuple(2 ** lvl for lvl in range(cfg["min_level"], cfg["max_level"] + 1)),
        ratios=tuple(cfg["aspect_ratios_h_over_w"]),
        scales=tuple(2 ** (i / cfg["num_scales"]) for i in range(cfg["num_scales"])),
        survival_prob=cfg["survival_prob"], bn_momentum=cfg["batch_norm_momentum"],
        bn_epsilon=cfg["batch_norm_epsilon"],
    )


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for the file's phi, checked against the
    file: the port builds D``phi`` at its published widths, and a file that
    says otherwise is refused rather than silently run at other shapes."""
    from efficientdet_tpu_torch import ModelConfig

    mc = ModelConfig.for_phi(cfg["phi"], num_classes=cfg["num_classes"],
                             image_size=cfg["image_size"])
    ref = reference_config(cfg)
    got = (mc.backbone, mc.bifpn_width, mc.bifpn_depth, mc.head_depth, mc.anchor.anchor_scale,
           mc.weighted_bifpn, tuple(mc.anchor.strides), tuple(mc.anchor.ratios),
           mc.survival_prob, mc.bn_momentum, mc.bn_epsilon)
    want = (ref.backbone, ref.bifpn_width, ref.bifpn_depth, ref.head_depth, ref.anchor_scale,
            ref.weighted_bifpn, ref.strides, ref.ratios, ref.survival_prob, ref.bn_momentum,
            ref.bn_epsilon)
    scales_ok = all(math.isclose(a, b, rel_tol=1e-12) for a, b in zip(mc.anchor.scales, ref.scales))
    if got != want or not scales_ok:
        raise ValueError(f"the port's D{cfg['phi']} {got} is not the configuration file's {want}")
    return mc


def port_model(cfg: dict, state_dict, dtype, device, fuse: bool):
    """The port's ``EfficientDet`` with the benchmark's weights, BN folded by
    the port's ``fuse_for_inference`` where ``fuse``."""
    from efficientdet_tpu_torch import EfficientDet, fuse_for_inference

    model = EfficientDet(port_config(cfg), dtype).to(device)
    model.load_state_dict(state_dict)
    model.eval()
    return fuse_for_inference(model) if fuse else model
