"""Anchor generation and box decoding for the PyTorch port.

Anchors for an image size are made once on the host with numpy (the same
arithmetic as the JAX package, so the tables are identical) and moved to the
device by the caller. IoU, decode and clip are torch functions in float32.
All boxes are ``[x1, y1, x2, y2]`` in pixels.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .configs import AnchorConfig
from .utils.cuda_graph import capturable_constant

BOX_MEAN = (0.0, 0.0, 0.0, 0.0)
BOX_STD = (0.2, 0.2, 0.2, 0.2)


def _cell_anchors(size: float, ratios, scales) -> np.ndarray:
    """(R*S, 4) anchors centred at the origin for one pyramid level.

    ``ratio`` is height/width; scales tile fastest (r0s0, r0s1, ..., r1s0).
    """
    ratios = np.asarray(ratios, np.float32)
    scales = np.asarray(scales, np.float32)
    num = len(ratios) * len(scales)
    scale_grid = np.tile(scales, len(ratios))
    ratio_grid = np.repeat(ratios, len(scales))
    base = size * scale_grid
    w = base / np.sqrt(ratio_grid)
    h = base * np.sqrt(ratio_grid)
    anchors = np.zeros((num, 4), np.float32)
    anchors[:, 0] = -w / 2.0
    anchors[:, 1] = -h / 2.0
    anchors[:, 2] = w / 2.0
    anchors[:, 3] = h / 2.0
    return anchors


@functools.lru_cache(maxsize=32)
def anchors_for_shape(
    image_shape: Tuple[int, int],
    config: AnchorConfig = AnchorConfig(),
) -> np.ndarray:
    """All anchors for an image, concatenated over P3..P7.

    Returns (A, 4) float32. Row order is level-major, then row-major over
    cells, then the 9 per-cell anchors: the heads' flattened order. The
    cached array is shared between callers: copy it before writing to it.
    """
    ih, iw = image_shape
    all_levels = []
    for stride, size in zip(config.strides, config.sizes):
        fh = -(-ih // stride)
        fw = -(-iw // stride)
        cell = _cell_anchors(size, config.ratios, config.scales)
        cx = (np.arange(fw, dtype=np.float32) + 0.5) * stride
        cy = (np.arange(fh, dtype=np.float32) + 0.5) * stride
        centers = np.stack(np.meshgrid(cx, cy), axis=-1).reshape(-1, 2)
        shifts = np.concatenate([centers, centers], axis=-1)
        level = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
        all_levels.append(level.astype(np.float32))
    return np.concatenate(all_levels, axis=0)


def iou_matrix(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between (..., N, 4) and (..., K, 4) boxes -> (..., N, K).

    The operations and their order are those of the JAX package's
    ``iou_matrix``, so that float32 results agree bit for bit; degenerate
    boxes give IoU 0.
    """
    boxes = boxes.float()
    query_boxes = query_boxes.float()
    ax1, ay1, ax2, ay2 = (boxes[..., :, i, None] for i in range(4))
    bx1, by1, bx2, by2 = (query_boxes[..., None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
    area_b = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
    union = area_a + area_b - inter
    return torch.where(
        union > 0, inter / union.clamp_min(1e-9), torch.zeros_like(inter)
    )


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Regression outputs (..., 4) -> boxes, in float32."""
    deltas = deltas.float()
    anchors = anchors.float()
    # made by fills, not copied from the host: the serving path captures this
    mean = capturable_constant(BOX_MEAN, deltas.device)
    std = capturable_constant(BOX_STD, deltas.device)
    t = deltas * std + mean
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    return torch.stack(
        [
            anchors[..., 0] + t[..., 0] * aw,
            anchors[..., 1] + t[..., 1] * ah,
            anchors[..., 2] + t[..., 2] * aw,
            anchors[..., 3] + t[..., 3] * ah,
        ],
        dim=-1,
    )


def clip_boxes(boxes: torch.Tensor, image_hw: Tuple[int, int]) -> torch.Tensor:
    """Clamp boxes to the image: x to [0, w-1], y to [0, h-1]."""
    h, w = image_hw
    x1 = boxes[..., 0].clamp(0, w - 1)
    y1 = boxes[..., 1].clamp(0, h - 1)
    x2 = boxes[..., 2].clamp(0, w - 1)
    y2 = boxes[..., 3].clamp(0, h - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)
