"""The numbers that decide ``correct``: the port's outputs against the
reference's, each a widest gap over what a run checks.

Detections (one image: the port's boxes in the canvas's pixels, scores and
classes, valid entries only), against the reference's logits (A, C) and
decoded, clipped boxes (A, 4) of every anchor and its own detections. Each
port detection is matched to the anchor whose reference box lies nearest
(corner distances over the box's width and height), the anchor of those
within ``NEAR_REL`` of the nearest whose logit of the detection's class is
closest (clipped boxes of neighbouring large anchors can coincide):

* ``box_rel``: the largest distance of a detection's box from its anchor's
  reference box, in units of that box's width and height;
* ``logit_gap``: the largest distance of a detection's logit from the
  reference's logit of its class at its anchor;
* ``missed``: the selection. Each of the reference's own detections is
  covered by the port's cut (the reference's logit of the port's lowest
  kept detection where the port keeps ``max_detections``, else the score
  threshold) and by every port detection of its class whose box overlaps
  it past the NMS threshold (less ``MISS_IOU_SLACK`` for the boxes'
  rounding), at the reference's logit of that detection. ``missed`` is the
  largest excess of a reference detection's logit over its best cover, or
  0. A port that keeps one of tied logits where the reference keeps another
  reads a tie's width: whatever the port leaves out lies below its cut or
  under a kept box of its class that scores as high. One that scores only
  part of the anchors, or keeps the lower box of an overlapping pair, reads
  the height of what it left out above what it kept.

A detection whose value is out of range, a pair of one class that the port
keeps past the NMS threshold (greedy NMS never does), or a list shorter
than half the reference's, is a fault.

Training, of the port's first steps against the reference's from the same
weights, batches and stochastic-depth draws:

* ``loss_rel``: the largest relative gap of a step's loss;
* ``grad_leaf``: the first step's gradient, by the worst leaf: the gap
  between the two norms of a leaf over the larger of the reference's norm
  of that leaf and of the median leaf;
* ``change_leaf``: the parameters' change over the steps, by the worst
  leaf, measured the same way, leaving out the leaves whose reference
  gradient is under ``ZERO_GRAD`` of the median leaf's (a conv bias under a
  training BN: Adam moves it by round-off alone).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from ..reference.boxes import iou
from ..reference.config import Eval

NEAR_REL = 1e-3
ZERO_GRAD = 1e-3
MISS_IOU_SLACK = 0.05


def logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double().clamp(1e-12, 1 - 1e-12)
    return torch.log(p) - torch.log1p(-p)


class DetectionGaps:
    """The widest gaps over every image compared, and the faults found."""

    def __init__(self):
        self.box_rel = self.logit_gap = self.missed = 0.0
        self.images = 0
        self.bad = []  # structural faults

    def add(self, boxes, scores, classes, ref_boxes, ref_logits, ref_dets, ev: Eval = Eval()):
        """One image: port (D, 4), (D,), (D,) valid detections; reference
        (A, 4) boxes and (A, C) logits of every anchor, and its own
        detections ``ref_dets``: boxes (R, 4), logits (R,), classes (R,)."""
        self.images += 1
        boxes, scores = boxes.float(), scores.float()
        c = ref_logits.shape[1]
        ref_count = len(ref_dets[1])
        if 2 * len(scores) < ref_count:
            self.bad.append(f"{len(scores)} detections where the reference keeps {ref_count}")
            return
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            self.bad.append("non-finite detection")
            return
        if not len(scores):
            return
        if not (((scores >= 0) & (scores <= 1)).all() and ((classes >= 0) & (classes < c)).all()):
            self.bad.append("score or class out of range")
            return
        self._overlaps(boxes, classes, ev.nms_iou_threshold)
        mine = logit(scores)
        w = (ref_boxes[:, 2] - ref_boxes[:, 0]).clamp_min(1.0)
        h = (ref_boxes[:, 3] - ref_boxes[:, 1]).clamp_min(1.0)
        dx = torch.maximum((boxes[:, None, 0] - ref_boxes[:, 0]).abs(),
                           (boxes[:, None, 2] - ref_boxes[:, 2]).abs()) / w
        dy = torch.maximum((boxes[:, None, 1] - ref_boxes[:, 1]).abs(),
                           (boxes[:, None, 3] - ref_boxes[:, 3]).abs()) / h
        dist = torch.maximum(dx, dy)  # (D, A)
        d = dist.amin(dim=1)
        theirs = ref_logits[:, classes.long()].t().double()  # (D, A)
        gap, at = torch.where(dist <= d[:, None] + NEAR_REL, (theirs - mine[:, None]).abs(),
                              math.inf).min(dim=1)
        self.box_rel = max(self.box_rel, float(d.max()))
        self.logit_gap = max(self.logit_gap, float(gap.max()))
        kept = theirs.gather(1, at[:, None])[:, 0]  # the reference's logit of each detection
        self.missed = max(self.missed, missed_excess(boxes, classes, kept, ref_dets, ev))

    def _overlaps(self, boxes, classes, iou_threshold: float) -> None:
        """Greedy NMS keeps no two detections of one class that overlap by
        more than its threshold (the port's own boxes; a millionth of slack
        for the rounding of boxes sent back in source pixels)."""
        same = classes[:, None] == classes[None, :]
        over = (iou(boxes, boxes) > iou_threshold + 1e-6) & same
        over.fill_diagonal_(False)
        if over.any():
            self.bad.append(f"{int(over.sum()) // 2} kept pairs of one class overlap past the "
                            "NMS threshold")

    def numbers(self) -> Dict[str, float]:
        return {"box_rel": self.box_rel, "logit_gap": self.logit_gap, "missed": self.missed}


def missed_excess(boxes, classes, kept, ref_dets, ev: Eval) -> float:
    """The widest excess of a reference detection's logit over what covers
    it in the port's list (``boxes``, ``classes`` and the reference's logit
    ``kept`` of each port detection): see ``missed`` above."""
    ref_boxes, ref_logits, ref_classes = ref_dets
    if not len(ref_logits):
        return 0.0
    if len(kept) >= ev.max_detections:
        cut = float(kept.min())
    else:
        cut = -math.inf if ev.score_threshold <= 0 else math.log(ev.score_threshold
                                                                 / (1 - ev.score_threshold))
    over = ((iou(ref_boxes.float(), boxes) > ev.nms_iou_threshold - MISS_IOU_SLACK)
            & (ref_classes.long()[:, None] == classes.long()[None, :]))
    cover = torch.where(over, kept[None, :], -math.inf).amax(dim=1).clamp_min(cut)
    return max(0.0, float((ref_logits.double() - cover).max()))


def _gap(mine: torch.Tensor, theirs: torch.Tensor) -> float:
    return abs(float(mine) - float(theirs))


def training_numbers(port: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
    """``port`` and ``ref``: ``losses`` (list), ``grad_norm`` and
    ``change_norm`` (leaf name -> norm); ``ref`` also ``grad_norm`` of every
    leaf, which sets the leaves left out of the change."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(port["losses"], ref["losses"]))
    g_ref = ref["grad_norm"]
    med_g = float(torch.tensor(list(g_ref.values())).median())
    grad = max(_gap(port["grad_norm"][k], g) / max(g, med_g) for k, g in g_ref.items())
    moved = {k: v for k, v in ref["change_norm"].items() if g_ref[k] >= ZERO_GRAD * med_g}
    med_c = float(torch.tensor(list(moved.values())).median())
    change = max(_gap(port["change_norm"][k], c) / max(c, med_c) for k, c in moved.items())
    first = abs(port["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    return {"loss_rel": loss_rel, "grad_leaf": grad, "change_leaf": change, "loss_rel_step1": first}


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0,
               minus: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
    """Norm of each leaf (of ``tensors - minus`` where given), times ``scale``."""
    out = {}
    for k, v in tensors.items():
        d = v.detach().double() if minus is None else v.detach().double() - minus[k].double()
        out[k] = float(torch.linalg.vector_norm(d)) * scale
    return out


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> List[list]:
    """[[name, number, limit], ...] in the limits' order; a number that is
    missing or not finite reads as infinite."""
    out = []
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        out.append([name, v if math.isfinite(v) else math.inf, limit])
    return out
