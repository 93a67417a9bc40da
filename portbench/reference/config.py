"""The detector's shapes for each phi, the anchors, the NMS settings and the
training hyperparameters (a copy of the port's ``configs.py``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# EfficientNet compound scaling (arXiv 1905.11946 Table 1): width, depth
EFFICIENTNET_PARAMS = {
    "efficientnet-b0": (1.0, 1.0), "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2), "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8), "efficientnet-b5": (1.6, 2.2),
    "efficientnet-b6": (1.8, 2.6), "efficientnet-b7": (2.0, 3.1),
}


@dataclasses.dataclass(frozen=True)
class Block:
    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    strides: int
    se_ratio: float = 0.25


# EfficientNet-B0's stages; C3, C4, C5 are tapped after stages 3, 5 and 7
B0_BLOCKS = (
    Block(3, 1, 32, 16, 1, 1), Block(3, 2, 16, 24, 6, 2), Block(5, 2, 24, 40, 6, 2),
    Block(3, 3, 40, 80, 6, 2), Block(5, 3, 80, 112, 6, 1), Block(5, 4, 112, 192, 6, 2),
    Block(3, 1, 192, 320, 6, 1),
)

# phi -> (image size, backbone, BiFPN width, BiFPN depth, head depth, anchor scale)
PHI = {
    0: (512, "efficientnet-b0", 64, 3, 3, 4.0), 1: (640, "efficientnet-b1", 88, 4, 3, 4.0),
    2: (768, "efficientnet-b2", 112, 5, 3, 4.0), 3: (896, "efficientnet-b3", 160, 6, 4, 4.0),
    4: (1024, "efficientnet-b4", 224, 7, 4, 4.0), 5: (1280, "efficientnet-b5", 288, 7, 4, 4.0),
    6: (1280, "efficientnet-b6", 384, 8, 5, 4.0), 7: (1536, "efficientnet-b6", 384, 8, 5, 5.0),
}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


@dataclasses.dataclass(frozen=True)
class Config:
    """One detector: the published shapes of EfficientDet-D``phi``."""

    phi: int
    image_size: int
    backbone: str
    bifpn_width: int
    bifpn_depth: int
    head_depth: int
    anchor_scale: float
    weighted_bifpn: bool
    num_classes: int = 90
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    ratios: Tuple[float, ...] = (1.0, 0.5, 2.0)
    scales: Tuple[float, ...] = (2 ** 0.0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))
    survival_prob: float = 0.8
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3

    @property
    def num_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)


def config_for(phi: int, image_size: int | None = None, num_classes: int = 90) -> Config:
    size, backbone, width, depth, head_depth, anchor_scale = PHI[phi]
    return Config(phi, image_size or size, backbone, width, depth, head_depth, anchor_scale,
                  weighted_bifpn=phi < 6, num_classes=num_classes)


@dataclasses.dataclass(frozen=True)
class Eval:
    """Detection filtering (the port's ``EvalConfig`` defaults)."""

    score_threshold: float = 0.01
    nms_iou_threshold: float = 0.5
    max_detections: int = 100
    pre_nms_top_k: int = 1024
    per_anchor_top_c: int = 16


@dataclasses.dataclass(frozen=True)
class Train:
    """The training step's hyperparameters (the port's ``TrainConfig``
    defaults that the step reads)."""

    learning_rate: float = 1e-3
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    huber_sigma: float = 3.0
    positive_iou: float = 0.5
    negative_iou: float = 0.4
