"""Decode, select and suppress in logit space (a copy of the port's
``ops/nms.py`` ``"concat"`` front end and shared tail, with the fixpoint
suppression of ``ops/nms_kernel.py``'s plain twin in place of the kernel).

Every top-k is a stable descending sort: ties keep the lower index first.
"""

from __future__ import annotations

import math

import torch

from .boxes import clip, decode, iou

NEG = -1e9


def logit(p: float) -> float:
    return NEG / 2 if p <= 0.0 else math.log(p / (1.0 - p))


def topk(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def suppress(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor, thr: float):
    """Greedy per-class NMS keep mask of score-sorted (B, K) candidates: the
    fixpoint of keep[i] = valid[i] and no kept j < i of i's class overlaps
    it by IoU > thr."""
    k = boxes.shape[1]
    idx = torch.arange(k, device=boxes.device)
    sup = ((iou(boxes, boxes) > thr) & (classes[:, :, None] == classes[:, None, :])
           & (idx[:, None] < idx[None, :])).float()
    keep = valid.clone()
    for _ in range(k):
        new = valid & ~(torch.bmm(keep.float()[:, None, :], sup)[:, 0] > 0.5)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def candidates(anchors, deltas, logits, size: int, ev):
    """The anchor prefilter: (B, Ka, C) logits and (B, Ka, 4) decoded,
    clipped boxes of each image's top ``pre_nms_top_k`` anchors by their
    best class."""
    b, a, c = logits.shape
    ka = min(ev.pre_nms_top_k, a)
    top = topk(logits.amax(dim=2), ka)[1]
    cand = torch.gather(logits, 1, top[..., None].expand(b, ka, c))
    d = torch.gather(deltas, 1, top[..., None].expand(b, ka, 4)).float()
    return cand, clip(decode(d, anchors[top]), size, size)


def pairs(cand_logits: torch.Tensor, ev):
    """The top K (anchor, class) pairs above the threshold: (logits (B, K),
    the candidate anchor of each (B, K), its class (B, K) int32, valid)."""
    b, ka, c = cand_logits.shape
    c_keep = min(ev.per_anchor_top_c, c)
    if c_keep < c:
        vals, cls = topk(cand_logits, c_keep)
    else:
        vals, cls = cand_logits, torch.arange(c, device=cand_logits.device).expand(cand_logits.shape)
    k = min(ev.pre_nms_top_k, ka * c_keep)
    flat = vals.reshape(b, -1)
    flat = torch.where(flat > logit(ev.score_threshold), flat, torch.full_like(flat, NEG))
    sneg, order = torch.sort(-flat, dim=1, stable=True)
    order = order[:, :k]
    top = (-sneg[:, :k]).float()
    return top, order // c_keep, torch.gather(cls.reshape(b, -1), 1, order).to(torch.int32), top > NEG / 2


def detections(anchors, deltas, logits, size: int, ev):
    """(boxes (B, D, 4), scores (B, D), classes (B, D), num_valid (B,)),
    D = ``max_detections``, padded with 0, -1 and -1."""
    cand_logits, cand_boxes_a = candidates(anchors, deltas, logits, size, ev)
    top, anchor_of, cls, valid = pairs(cand_logits, ev)
    b, k = top.shape
    boxes = torch.gather(cand_boxes_a, 1, anchor_of[..., None].expand(b, k, 4))
    keep = suppress(boxes, cls, valid, ev.nms_iou_threshold)
    kept = torch.where(keep, top, torch.full_like(top, NEG))
    n = min(ev.max_detections, k)
    det, idx = topk(kept, n)
    if n < ev.max_detections:
        det = torch.nn.functional.pad(det, (0, ev.max_detections - n), value=NEG)
        idx = torch.nn.functional.pad(idx, (0, ev.max_detections - n))
    ok = det > NEG / 2
    out_boxes = torch.where(ok[..., None], torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4)),
                            torch.zeros((), device=top.device))
    out_cls = torch.where(ok, torch.gather(cls, 1, idx), torch.full_like(cls[:, :1], -1))
    out_scores = torch.where(ok, torch.sigmoid(det), torch.full_like(det, -1.0))
    return out_boxes, out_scores, out_cls, ok.sum(dim=1, dtype=torch.int32)


def same_class_pairs(cand_logits: torch.Tensor, ev) -> torch.Tensor:
    """(B,) pairs of one class among each image's K suppression candidates:
    the pairs whose IoU the suppression has to test."""
    _, _, cls, _ = pairs(cand_logits, ev)
    counts = torch.zeros((cls.shape[0], cand_logits.shape[-1]), device=cls.device)
    counts.scatter_add_(1, cls.long(), torch.ones_like(cls, dtype=counts.dtype))
    return (counts * (counts - 1) / 2).sum(dim=1)
