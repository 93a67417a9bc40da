"""Batched, static-shape, per-class NMS in logit space.

Counterpart of the JAX package's ``ops/nms.py``: the readable spec
(:func:`filter_detections`, probability space, plain torch, sharing no code
with the rest), and the production path with its two front ends
(``"anchor_major"``, ``"concat"``) and their shared tail. Pipeline per image:

1. anchor prefilter: the top ``pre_nms_top_k`` anchors by best-class logit;
2. per-anchor class cap (``per_anchor_top_c``), then the score-threshold
   mask in logit space and a stable sort of the (anchor, class) pairs;
3. suppression of the top K pairs (ops/nms_kernel.py);
4. the top ``max_detections`` kept pairs; sigmoid on those only.

The production path holds no host sync and no shape that depends on the
data, so the serving path captures it in a CUDA graph.

Every top-k here is a stable descending sort, so ties keep the lower index
first, as ``lax.top_k`` does. (The JAX package's default prefilter is an
approximate top-k on its TPU, which on a CPU is exactly this sort.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..anchors import clip_boxes, decode_boxes, iou_matrix
from ..configs import EvalConfig
from .nms_kernel import suppression_keep_mask

_NEG_INF = -1e9


def _logit(p: float) -> float:
    """log(p/(1-p)) with p<=0 mapping to an always-true threshold."""
    if p <= 0.0:
        return _NEG_INF / 2
    return float(np.log(p / (1.0 - p)))


def _fixpoint_suppress(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy-NMS keep mask by fixpoint iteration (the spec's, on the host's clock).

    sup: (K, K) bool, sup[j, i] True iff candidate j (higher score, j < i)
    suppresses candidate i when kept. valid: (K,) bool.
    """
    k = valid.shape[0]
    sup_f = sup.float()
    keep, prev = valid, torch.zeros_like(valid)
    it = 0
    while it < k and not torch.equal(keep, prev):
        suppressed = (keep.float() @ sup_f) > 0.5
        keep, prev = valid & ~suppressed, keep
        it += 1
    return keep


def filter_detections(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    score_threshold: float = 0.01,
    nms_iou_threshold: float = 0.5,
    max_detections: int = 100,
    pre_nms_top_k: int = 1000,
):
    """Per-class NMS for one image: the READABLE SPEC, in probability space.

    boxes (A, 4) decoded xyxy, scores (A, C) sigmoid scores. Kept apart
    from the production path on purpose (it shares no code with it and
    reaches no kernel), so the tests can pin one with the other. Returns
    (boxes (D, 4) zero-padded, scores (D,) -1-padded, classes (D,) int32
    -1-padded, num_valid () int32), D = ``max_detections``.
    """

    def top_k(x, k):  # descending, ties to the lower index, as lax.top_k
        vals, idx = torch.sort(x, descending=True, stable=True)
        return vals[:k], idx[:k]

    num_anchors, num_classes = scores.shape
    scores = scores.float()
    boxes = boxes.float()

    # 1. anchor prefilter
    k_anchor = min(pre_nms_top_k, num_anchors)
    _, top_anchor = top_k(scores.amax(dim=1), k_anchor)
    cand_scores = scores[top_anchor]  # (Ka, C)
    cand_boxes_a = boxes[top_anchor]  # (Ka, 4)

    # 2. pair top-k over the prefiltered block
    k = min(pre_nms_top_k, k_anchor * num_classes)
    flat = cand_scores.reshape(-1)
    flat = torch.where(flat > score_threshold, flat, torch.full_like(flat, _NEG_INF))
    top_scores, top_idx = top_k(flat, k)
    pair_anchor = top_idx // num_classes
    pair_class = (top_idx % num_classes).to(torch.int32)
    cand_boxes = cand_boxes_a[pair_anchor]  # (K, 4)
    valid = top_scores > _NEG_INF / 2

    # 3. suppression: a higher-scored, kept, same-class overlapping candidate kills i
    idx = torch.arange(k, device=boxes.device)
    sup = ((iou_matrix(cand_boxes, cand_boxes) > nms_iou_threshold)
           & (pair_class[:, None] == pair_class[None, :]) & (idx[:, None] < idx[None, :]))
    keep = _fixpoint_suppress(sup, valid)

    # 4. the top max_detections kept candidates
    kept_scores = torch.where(keep, top_scores, torch.full_like(top_scores, _NEG_INF))
    n_out = min(max_detections, k)
    det_scores, det_idx = top_k(kept_scores, n_out)
    if n_out < max_detections:
        pad = max_detections - n_out
        det_scores = torch.nn.functional.pad(det_scores, (0, pad), value=_NEG_INF)
        det_idx = torch.nn.functional.pad(det_idx, (0, pad))
    det_valid = det_scores > _NEG_INF / 2
    det_boxes = torch.where(det_valid[:, None], cand_boxes[det_idx], torch.zeros((), device=boxes.device))
    det_classes = torch.where(det_valid, pair_class[det_idx], torch.full_like(pair_class[:1], -1))
    det_scores = torch.where(det_valid, det_scores, torch.full_like(det_scores, -1.0))
    return det_boxes, det_scores, det_classes, det_valid.sum(dtype=torch.int32)


def batched_filter_detections(
    boxes: torch.Tensor, scores: torch.Tensor, config: EvalConfig = EvalConfig()
):
    """:func:`filter_detections` over the batch: boxes (B, A, 4), scores (B, A, C)."""
    outs = [
        filter_detections(b, s, config.score_threshold, config.nms_iou_threshold,
                          config.max_detections, config.pre_nms_top_k)
        for b, s in zip(boxes, scores)
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _topk(x: torch.Tensor, k: int):
    """Top-k along the last dim, descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pairs_and_suppress(
    cand_logits: torch.Tensor,
    cand_boxes_a: torch.Tensor,
    num_classes: int,
    config: EvalConfig,
):
    """Shared NMS tail: pair selection -> suppression -> final top-k.

    cand_logits: (B, Ka, C) model dtype; cand_boxes_a: (B, Ka, 4) float32
    decoded and clipped candidate-anchor boxes.
    Returns (boxes (B,D,4), scores (B,D), classes (B,D), num_valid (B,)).
    """
    bsz, k_anchor, _ = cand_logits.shape
    dev = cand_logits.device
    logit_thr = _logit(config.score_threshold)

    c_keep = min(config.per_anchor_top_c, num_classes)
    if c_keep < num_classes:
        keep_vals, keep_cls = _topk(cand_logits, c_keep)  # (B, Ka, C')
    else:
        keep_vals = cand_logits
        keep_cls = torch.arange(num_classes, device=dev).expand(cand_logits.shape)
    k = min(config.pre_nms_top_k, k_anchor * c_keep)
    flat = keep_vals.reshape(bsz, -1)
    flat = torch.where(flat > logit_thr, flat, torch.full_like(flat, _NEG_INF))
    # stable ascending sort of -flat: the JAX package's payload sort
    sneg, order = torch.sort(-flat, dim=1, stable=True)
    order = order[:, :k]
    top_logits = (-sneg[:, :k]).float()
    pair_anchor = order // c_keep
    pair_class = torch.gather(keep_cls.reshape(bsz, -1), 1, order).to(torch.int32)
    cand_boxes = torch.gather(
        cand_boxes_a, 1, pair_anchor[..., None].expand(bsz, k, 4)
    ).contiguous()
    valid = top_logits > _NEG_INF / 2

    keep = suppression_keep_mask(
        cand_boxes, pair_class.contiguous(), valid, config.nms_iou_threshold
    )

    kept_logits = torch.where(keep, top_logits, torch.full_like(top_logits, _NEG_INF))
    n_out = min(config.max_detections, k)
    det_logits, det_idx = _topk(kept_logits, n_out)
    if n_out < config.max_detections:
        pad = config.max_detections - n_out
        det_logits = torch.nn.functional.pad(det_logits, (0, pad), value=_NEG_INF)
        det_idx = torch.nn.functional.pad(det_idx, (0, pad))
    det_valid = det_logits > _NEG_INF / 2
    det_boxes = torch.where(
        det_valid[..., None],
        torch.gather(cand_boxes, 1, det_idx[..., None].expand(*det_idx.shape, 4)),
        torch.zeros((), device=dev),
    )
    det_classes = torch.where(
        det_valid, torch.gather(pair_class, 1, det_idx), torch.full_like(pair_class[:, :1], -1)
    )
    det_scores = torch.where(
        det_valid, torch.sigmoid(det_logits), torch.full_like(det_logits, -1.0)
    )
    num_valid = det_valid.sum(dim=1, dtype=torch.int32)
    return det_boxes, det_scores, det_classes, num_valid


def batched_filter_from_logits(
    anchors: torch.Tensor,
    box_deltas: torch.Tensor,
    cls_logits: torch.Tensor,
    image_hw: Tuple[int, int],
    config: EvalConfig = EvalConfig(),
):
    """The ``"concat"`` front end: (B, A, 4) deltas and (B, A, C) logits."""
    bsz, num_anchors, num_classes = cls_logits.shape
    k_anchor = min(config.pre_nms_top_k, num_anchors)
    anchor_best = cls_logits.amax(dim=2)
    top_anchor = _topk(anchor_best, k_anchor)[1]  # (B, Ka): the anchor prefilter
    cand_logits = torch.gather(
        cls_logits, 1, top_anchor[..., None].expand(bsz, k_anchor, num_classes)
    )
    cand_anchors = anchors.float()[top_anchor]  # (B, Ka, 4)
    cand_deltas = torch.gather(
        box_deltas, 1, top_anchor[..., None].expand(bsz, k_anchor, 4)
    ).float()
    cand_boxes_a = clip_boxes(decode_boxes(cand_deltas, cand_anchors), image_hw)
    return _pairs_and_suppress(cand_logits, cand_boxes_a, num_classes, config)


def filter_detections_from_logits(
    anchors: torch.Tensor,
    box_deltas: torch.Tensor,
    cls_logits: torch.Tensor,
    image_hw: Tuple[int, int],
    score_threshold: float = 0.01,
    nms_iou_threshold: float = 0.5,
    max_detections: int = 100,
    pre_nms_top_k: int = 1024,
):
    """One image, selection in logit space: (A, 4) deltas, (A, C) logits.

    :func:`batched_filter_from_logits` at batch 1 with the parity-exact
    preset (no per-anchor class cap), so the single-image path can never
    drift from the batched one. The same detections as decoding every
    anchor and :func:`filter_detections` on the sigmoid scores.
    """
    config = EvalConfig.exact(
        cls_logits.shape[-1],
        score_threshold=score_threshold,
        nms_iou_threshold=nms_iou_threshold,
        max_detections=max_detections,
        pre_nms_top_k=pre_nms_top_k,
    )
    boxes, scores, classes, nvalid = batched_filter_from_logits(
        anchors, box_deltas[None], cls_logits[None], image_hw, config
    )
    return boxes[0], scores[0], classes[0], nvalid[0]


def anchor_major_candidates(
    anchors: torch.Tensor,
    box_out,
    cls_out,
    image_hw: Tuple[int, int],
    config: EvalConfig = EvalConfig(),
):
    """Candidate-building stage of the anchor-major front end.

    cls_out = (z (A, Mp_tot, C), amax_img (B, A_total), hws) and
    box_out = (zb (Mp_tot, A*4), hws) from the heads' anchor-major path,
    where row ``level_row_off + b*HW_l + p`` holds pixel (b, p) of level l.
    Returns (cand_logits (B, Ka, C), cand_boxes_a (B, Ka, 4), num_classes).
    """
    z, amax_img, hws = cls_out
    zb, _ = box_out
    a_cell, mp_tot, num_classes = z.shape
    bsz, total = amax_img.shape

    k_anchor = min(config.pre_nms_top_k, total)
    top_anchor = _topk(amax_img, k_anchor)[1]  # (B, Ka): the anchor prefilter

    # decompose each id into (level, anchor-in-cell, pixel): the z row, the
    # box row and the anchors-table id
    zrow = torch.zeros_like(top_anchor)
    brow = torch.zeros_like(top_anchor)
    table_id = torch.zeros_like(top_anchor)
    a_sel = torch.zeros_like(top_anchor)
    b_base = torch.arange(bsz, device=top_anchor.device)[:, None]
    off = 0
    row_off = 0
    for hw in hws:
        n = a_cell * hw
        local = top_anchor - off
        in_lvl = (local >= 0) & (local < n)
        li = local.clamp(0, n - 1)
        a_i = li // hw
        p_i = li % hw
        row = row_off + b_base * hw + p_i
        zrow = torch.where(in_lvl, a_i * mp_tot + row, zrow)
        brow = torch.where(in_lvl, row, brow)
        table_id = torch.where(in_lvl, off + p_i * a_cell + a_i, table_id)
        a_sel = torch.where(in_lvl, a_i, a_sel)
        off += n
        row_off += bsz * hw

    cand_logits = z.reshape(-1, num_classes)[zrow]  # (B, Ka, C)
    cand_rows = zb[brow].reshape(bsz, k_anchor, a_cell, 4)  # (B, Ka, A, 4)
    # the JAX package slices the delta with a one-hot contraction, which is
    # exact; a gather gives the same values
    cand_deltas = torch.gather(
        cand_rows, 2, a_sel[..., None, None].expand(bsz, k_anchor, 1, 4)
    )[:, :, 0].float()
    cand_anchors = anchors.float()[table_id]
    cand_boxes_a = clip_boxes(decode_boxes(cand_deltas, cand_anchors), image_hw)
    return cand_logits, cand_boxes_a, num_classes


def batched_filter_from_anchor_major_levels(
    anchors: torch.Tensor,
    box_out,
    cls_out,
    image_hw: Tuple[int, int],
    config: EvalConfig = EvalConfig(),
):
    """NMS front end over the heads' anchor-major outputs (the main path)."""
    cand_logits, cand_boxes_a, num_classes = anchor_major_candidates(
        anchors, box_out, cls_out, image_hw, config
    )
    return _pairs_and_suppress(cand_logits, cand_boxes_a, num_classes, config)
