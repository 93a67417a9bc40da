"""Anchors, box coding and the training targets for the PyTorch port.

Anchors for an image size are made once on the host with numpy (the same
arithmetic as the JAX package, so the tables are identical) and moved to the
device by the caller. IoU, encode, decode, clip and the anchor-target
assignment are torch functions in float32 on the anchors' device. All boxes
are ``[x1, y1, x2, y2]`` in pixels.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .configs import AnchorConfig
from .utils.cuda_graph import capturable_constant
from .utils.profiling import span

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


def encode_boxes(gt_boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Ground-truth corners -> normalised regression targets (..., 4)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    t = torch.stack(
        [
            (gt_boxes[..., 0] - anchors[..., 0]) / aw,
            (gt_boxes[..., 1] - anchors[..., 1]) / ah,
            (gt_boxes[..., 2] - anchors[..., 2]) / aw,
            (gt_boxes[..., 3] - anchors[..., 3]) / ah,
        ],
        dim=-1,
    )
    mean = capturable_constant(BOX_MEAN, t.device).to(t.dtype)
    std = capturable_constant(BOX_STD, t.device).to(t.dtype)
    return (t - mean) / std


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


# ---------------------------------------------------------------------------
# Anchor-target assignment
# ---------------------------------------------------------------------------


def anchor_targets_compact(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    positive_iou: float = 0.5,
    negative_iou: float = 0.4,
):
    """Assign targets to anchors, on the anchors' device.

    anchors: (A, 4). gt_boxes: (..., G, 4), zero padded; a row whose label
    is negative is padding and never matches. gt_labels: (..., G) integers,
    -1 for padding. Leading dimensions (a batch) broadcast.

    Each anchor matches its highest-IoU box (the first of equals); padding
    rows count as IoU -1. IoU >= ``positive_iou`` is positive, IoU in
    [``negative_iou``, ``positive_iou``) ignored, the rest negative.

    Returns ``cls_labels`` (..., A) int32, the matched class on positives
    and -1 elsewhere; ``box_targets`` (..., A, 4) float32 encoded targets,
    0 off the positives; ``anchor_state`` (..., A) float32 in {-1 ignore,
    0 negative, 1 positive}. The matched row is a gather where the JAX
    package contracts a one-hot matrix: in float32 both select it exactly.
    """
    anchors = anchors.float()
    gt_boxes = gt_boxes.float()
    valid = gt_labels >= 0  # (..., G)
    ious = iou_matrix(anchors, gt_boxes)  # (..., A, G)
    ious = torch.where(valid.unsqueeze(-2), ious, torch.full_like(ious, -1.0))
    best_gt = torch.argmax(ious, dim=-1)  # (..., A), the first index of the max
    best_iou = torch.amax(ious, dim=-1)
    positive = best_iou >= positive_iou
    ignore = (best_iou >= negative_iou) & ~positive
    anchor_state = torch.where(
        positive, 1.0, torch.where(ignore, -1.0, 0.0)
    ).to(torch.float32)
    matched_boxes = torch.gather(
        gt_boxes.expand(best_gt.shape[:-1] + gt_boxes.shape[-2:]), -2,
        best_gt.unsqueeze(-1).expand(best_gt.shape + (4,)),
    )  # (..., A, 4)
    matched_labels = torch.gather(
        gt_labels.expand(best_gt.shape[:-1] + gt_labels.shape[-1:]), -1, best_gt
    )
    cls_labels = torch.where(positive, matched_labels, -1).to(torch.int32)
    box_targets = encode_boxes(matched_boxes, anchors)
    box_targets = torch.where(positive.unsqueeze(-1), box_targets, 0.0)
    return cls_labels, box_targets, anchor_state


def anchor_targets(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    num_classes: int,
    positive_iou: float = 0.5,
    negative_iou: float = 0.4,
):
    """:func:`anchor_targets_compact` with (..., A, C) float32 one-hot class
    targets (all zero off the positives) in place of the labels."""
    cls_labels, box_targets, anchor_state = anchor_targets_compact(
        anchors, gt_boxes, gt_labels, positive_iou, negative_iou
    )
    cls_targets = torch.nn.functional.one_hot(
        torch.where(cls_labels < 0, num_classes, cls_labels).long(), num_classes + 1
    )[..., :num_classes].to(torch.float32)
    return cls_targets, box_targets, anchor_state


def anchor_targets_batch(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    num_classes: int,
    positive_iou: float = 0.5,
    negative_iou: float = 0.4,
):
    """:func:`anchor_targets` over a batch: gt_boxes (B, G, 4), gt_labels (B, G)."""
    if gt_boxes.dim() != 3:
        raise ValueError(f"expected (B, G, 4) boxes, got shape {tuple(gt_boxes.shape)}")
    return anchor_targets(anchors, gt_boxes, gt_labels, num_classes, positive_iou, negative_iou)


def anchor_targets_batch_compact(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    positive_iou: float = 0.5,
    negative_iou: float = 0.4,
):
    """:func:`anchor_targets_compact` over a batch: (cls_labels (B, A),
    box_targets (B, A, 4), anchor_state (B, A)), the train step's form; a
    ``loss.targets`` span while spans are recorded."""
    if gt_boxes.dim() != 3:
        raise ValueError(f"expected (B, G, 4) boxes, got shape {tuple(gt_boxes.shape)}")
    with span("loss.targets"):
        return anchor_targets_compact(anchors, gt_boxes, gt_labels, positive_iou, negative_iou)
