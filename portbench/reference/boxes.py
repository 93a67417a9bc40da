"""Anchors, IoU, box coding and the training targets (a copy of the port's
``anchors.py``), in float32 on the caller's device."""

from __future__ import annotations

import numpy as np
import torch

BOX_STD = 0.2


def anchors_for(config, size: int) -> np.ndarray:
    """(A, 4) xyxy anchors of a size x size image: level-major, then cells
    row-major, then the cell's anchors (ratio-major, scale fastest)."""
    ratios = np.asarray(config.ratios, np.float32)
    scales = np.asarray(config.scales, np.float32)
    levels = []
    for stride in config.strides:
        base = config.anchor_scale * stride * np.tile(scales, len(ratios))
        ratio = np.repeat(ratios, len(scales))
        w, h = base / np.sqrt(ratio), base * np.sqrt(ratio)
        cell = np.stack([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0], axis=-1).astype(np.float32)
        n = -(-size // stride)
        c = (np.arange(n, dtype=np.float32) + 0.5) * stride
        centers = np.stack(np.meshgrid(c, c), axis=-1).reshape(-1, 2)
        shifts = np.concatenate([centers, centers], axis=-1)
        levels.append((shifts[:, None, :] + cell[None]).reshape(-1, 4).astype(np.float32))
    return np.concatenate(levels, axis=0)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., K, 4) -> (..., N, K); degenerate boxes give 0."""
    ax1, ay1, ax2, ay2 = (a[..., :, i, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    union = ((ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
             + (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0) - inter)
    return torch.where(union > 0, inter / union.clamp_min(1e-9), torch.zeros_like(inter))


def decode(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    t = deltas.float() * BOX_STD
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    return torch.stack([anchors[..., 0] + t[..., 0] * aw, anchors[..., 1] + t[..., 1] * ah,
                        anchors[..., 2] + t[..., 2] * aw, anchors[..., 3] + t[..., 3] * ah], -1)


def encode(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    return torch.stack([(boxes[..., 0] - anchors[..., 0]) / aw, (boxes[..., 1] - anchors[..., 1]) / ah,
                        (boxes[..., 2] - anchors[..., 2]) / aw, (boxes[..., 3] - anchors[..., 3]) / ah],
                       -1) / BOX_STD


def clip(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0, w - 1), boxes[..., 1].clamp(0, h - 1),
                        boxes[..., 2].clamp(0, w - 1), boxes[..., 3].clamp(0, h - 1)], -1)


def targets(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
            positive_iou: float, negative_iou: float):
    """(labels (B, A) int64, -1 off the positives; box targets (B, A, 4);
    state (B, A) in {-1 ignore, 0 negative, 1 positive}). Each anchor takes
    its highest-IoU box, the first of equals; padding rows (label < 0) never
    match."""
    ious = iou(anchors, gt_boxes.float())  # (B, A, G)
    ious = torch.where((gt_labels >= 0)[:, None, :], ious, torch.full_like(ious, -1.0))
    best_iou, best = ious.amax(dim=-1), ious.argmax(dim=-1)
    positive = best_iou >= positive_iou
    ignore = (best_iou >= negative_iou) & ~positive
    state = torch.where(positive, 1.0, torch.where(ignore, -1.0, 0.0))
    matched = torch.gather(gt_boxes.float(), 1, best[..., None].expand(*best.shape, 4))
    labels = torch.where(positive, torch.gather(gt_labels.long(), 1, best), -1)
    box_t = torch.where(positive[..., None], encode(matched, anchors), 0.0)
    return labels, box_t, state
