"""Typed configuration for the PyTorch port of EfficientDet.

A pure-Python copy of the JAX package's model, anchor and evaluation
configuration, kept field for field so that a configuration names the same
detector in both packages (tests/test_torch_configs.py holds them equal for
phi 0-7). Training configuration arrives with the training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# EfficientNet compound-scaling coefficients (arXiv 1905.11946 Table 1).
# name -> (width_coefficient, depth_coefficient, dropout_rate)
EFFICIENTNET_PARAMS = {
    "efficientnet-tiny": (1.0, 1.0, 0.2),
    "efficientnet-b0": (1.0, 1.0, 0.2),
    "efficientnet-b1": (1.0, 1.1, 0.2),
    "efficientnet-b2": (1.1, 1.2, 0.3),
    "efficientnet-b3": (1.2, 1.4, 0.3),
    "efficientnet-b4": (1.4, 1.8, 0.4),
    "efficientnet-b5": (1.6, 2.2, 0.4),
    "efficientnet-b6": (1.8, 2.6, 0.5),
    "efficientnet-b7": (2.0, 3.1, 0.5),
}


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One EfficientNet MBConv stage."""

    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    strides: int
    se_ratio: float = 0.25


# EfficientNet-B0 baseline stage table (arXiv 1905.11946).
EFFICIENTNET_B0_BLOCKS: Tuple[BlockConfig, ...] = (
    BlockConfig(3, 1, 32, 16, 1, 1),
    BlockConfig(3, 2, 16, 24, 6, 2),
    BlockConfig(5, 2, 24, 40, 6, 2),   # <- C3 tap after this stage (stride 8)
    BlockConfig(3, 3, 40, 80, 6, 2),
    BlockConfig(5, 3, 80, 112, 6, 1),  # <- C4 tap (stride 16)
    BlockConfig(5, 4, 112, 192, 6, 2),
    BlockConfig(3, 1, 192, 320, 6, 1),  # <- C5 tap (stride 32)
)

# Minimal 7-stage table for smoke paths: one block per stage, narrow filters,
# the same stride pattern and tap positions as B0. Not a real model.
EFFICIENTNET_TINY_BLOCKS: Tuple[BlockConfig, ...] = (
    BlockConfig(3, 1, 8, 8, 1, 1),
    BlockConfig(3, 1, 8, 8, 6, 2),
    BlockConfig(5, 1, 8, 16, 6, 2),    # <- C3 tap (stride 8)
    BlockConfig(3, 1, 16, 16, 1, 2),
    BlockConfig(5, 1, 16, 24, 6, 1),   # <- C4 tap (stride 16)
    BlockConfig(5, 1, 24, 24, 1, 2),
    BlockConfig(3, 1, 24, 32, 6, 1),   # <- C5 tap (stride 32)
)

BACKBONE_BLOCK_TABLES = {name: EFFICIENTNET_B0_BLOCKS for name in EFFICIENTNET_PARAMS}
BACKBONE_BLOCK_TABLES["efficientnet-tiny"] = EFFICIENTNET_TINY_BLOCKS


def round_filters(filters: int, width_coefficient: float, divisor: int = 8) -> int:
    """Round number of filters after width scaling."""
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:  # avoid rounding down by >10%
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    """Round number of block repeats after depth scaling."""
    return int(math.ceil(depth_coefficient * repeats))


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor layout; ``sizes`` are ``anchor_scale * stride``."""

    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    ratios: Tuple[float, ...] = (1.0, 0.5, 2.0)
    scales: Tuple[float, ...] = (2 ** 0.0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))
    anchor_scale: float = 4.0

    @property
    def sizes(self) -> Tuple[float, ...]:
        return tuple(self.anchor_scale * s for s in self.strides)

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.ratios) * len(self.scales)


# phi -> (image_size, backbone, bifpn_width, bifpn_depth, head_depth,
#         anchor_scale)
_PHI_CONFIGS = {
    0: (512, "efficientnet-b0", 64, 3, 3, 4.0),
    1: (640, "efficientnet-b1", 88, 4, 3, 4.0),
    2: (768, "efficientnet-b2", 112, 5, 3, 4.0),
    3: (896, "efficientnet-b3", 160, 6, 4, 4.0),
    4: (1024, "efficientnet-b4", 224, 7, 4, 4.0),
    5: (1280, "efficientnet-b5", 288, 7, 4, 4.0),
    6: (1280, "efficientnet-b6", 384, 8, 5, 4.0),
    7: (1536, "efficientnet-b6", 384, 8, 5, 5.0),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full detector configuration for one phi (D0..D7)."""

    phi: int
    image_size: int
    backbone: str
    bifpn_width: int
    bifpn_depth: int
    head_depth: int
    num_classes: int = 90
    weighted_bifpn: bool = True
    freeze_bn: bool = False
    min_level: int = 3
    max_level: int = 7
    anchor: AnchorConfig = AnchorConfig()
    survival_prob: float = 0.8  # drop-connect keep prob at the deepest block
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3

    @classmethod
    def for_phi(
        cls,
        phi: int,
        num_classes: int = 90,
        weighted_bifpn: bool | None = None,
        freeze_bn: bool = False,
        image_size: int | None = None,
    ) -> "ModelConfig":
        """Build the per-phi config.

        ``weighted_bifpn=None`` gives fast-normalised weighted fusion for
        D0-D5 and unweighted sum fusion for D6/D7.
        """
        if phi not in _PHI_CONFIGS:
            raise ValueError(f"phi must be in 0..7, got {phi}")
        size, backbone, w, d, hd, anchor_scale = _PHI_CONFIGS[phi]
        if weighted_bifpn is None:
            weighted_bifpn = phi < 6
        if image_size is not None:
            size = image_size
        if size % 128 != 0:
            raise ValueError(
                f"image_size must be divisible by 128 (stride of P7), got {size}"
            )
        return cls(
            phi=phi,
            image_size=size,
            backbone=backbone,
            bifpn_width=w,
            bifpn_depth=d,
            head_depth=hd,
            num_classes=num_classes,
            weighted_bifpn=weighted_bifpn,
            freeze_bn=freeze_bn,
            anchor=AnchorConfig(anchor_scale=anchor_scale),
        )

    @property
    def num_levels(self) -> int:
        return self.max_level - self.min_level + 1

    @property
    def num_anchors_per_cell(self) -> int:
        return self.anchor.num_anchors_per_cell

    def feature_shapes(self, image_size: int | None = None):
        """(H, W) of P3..P7 for a square input."""
        size = image_size or self.image_size
        return [
            (size // (2 ** lvl), size // (2 ** lvl))
            for lvl in range(self.min_level, self.max_level + 1)
        ]

    def total_anchors(self, image_size: int | None = None) -> int:
        return sum(
            h * w * self.num_anchors_per_cell
            for h, w in self.feature_shapes(image_size)
        )


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Detection filtering: score threshold, per-class NMS, output cap."""

    score_threshold: float = 0.01
    nms_iou_threshold: float = 0.5
    max_detections: int = 100
    pre_nms_top_k: int = 1024
    # Per-anchor class cap before the pair selection. Exact whenever
    # C <= 16; set >= num_classes for strict reference semantics.
    per_anchor_top_c: int = 16
    # The JAX package selects anchors with an approximate top-k on its TPU.
    # The port always selects exactly (a stable sort, which is what the
    # approximate op computes on a CPU); the field is kept so that a
    # configuration means the same in both packages.
    approx_anchor_prefilter: bool = True

    @classmethod
    def exact(cls, num_classes: int = 90, **overrides) -> "EvalConfig":
        """Parity-exact preset: no per-anchor class cap, exact prefilter."""
        return cls(
            per_anchor_top_c=max(num_classes, 1),
            approx_anchor_prefilter=False,
            **overrides,
        )
