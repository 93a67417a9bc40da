"""The reference's side of an inference cell's check: every anchor's logits
and boxes and the reference's own detections, image by image in blocks, and
the gaps of the port's detections from them (``compare.DetectionGaps``)."""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch

from ..reference import nms
from ..reference.boxes import anchors_for, clip, decode
from ..reference.config import Eval
from ..reference.model import Detector, normalize
from .compare import DetectionGaps, logit

Dets = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # boxes (N, 4), scores (N,), classes (N,)


def reference_model(config, state_dict, device, quant=None) -> Detector:
    model = Detector(config, quant).to(device)
    model.load_state_dict(state_dict)
    return model.eval()


@torch.no_grad()
def reference_outputs(model: Detector, canvases: torch.Tensor, ev: Eval, block: int):
    """Yield, image by image, (boxes (A, 4), logits (A, C), detections
    (boxes, scores, classes), the pairs of one class among its suppression
    candidates) of (N, S, S, 3) uint8 canvases on the model's device."""
    size = model.config.image_size
    anchors = torch.from_numpy(anchors_for(model.config, size)).to(canvases.device)
    for i in range(0, canvases.shape[0], block):
        logits, deltas = model(normalize(canvases[i:i + block]))
        boxes = clip(decode(deltas, anchors), size, size)
        det_boxes, det_scores, det_cls, n = nms.detections(anchors, deltas, logits, size, ev)
        cand, _ = nms.candidates(anchors, deltas, logits, size, ev)
        same = nms.same_class_pairs(cand, ev)
        for j in range(logits.shape[0]):
            k = int(n[j])
            yield (boxes[j], logits[j], (det_boxes[j, :k], det_scores[j, :k], det_cls[j, :k]),
                   float(same[j]))


def gaps(model: Detector, canvases: torch.Tensor, port: List[Dets], ev: Eval, block: int):
    """The gaps of ``port``'s detections of each canvas (boxes in canvas
    pixels), and the mean number of same-class candidate pairs an image."""
    out = DetectionGaps()
    pairs = []
    for (boxes, logits, ref_dets, same), (b, s, c) in zip(
            reference_outputs(model, canvases, ev, block), port):
        dev = boxes.device
        ref_boxes, ref_scores, ref_cls = ref_dets
        out.add(b.to(dev), s.to(dev), c.to(dev), boxes, logits,
                (ref_boxes, logit(ref_scores), ref_cls), ev)
        pairs.append(same)
    return out, sum(pairs) / max(len(pairs), 1)


def valid(dets: Iterable[torch.Tensor], i: int) -> Dets:
    """Image ``i``'s valid detections of a batched (boxes, scores, classes,
    num_valid) output."""
    boxes, scores, classes, n = dets
    k = int(n[i])
    return boxes[i, :k], scores[i, :k], classes[i, :k]


def control_gaps(check: dict, quant):
    """The control's gaps: the reference computed through ``quant`` (one
    precision below the cell's) in the port's place, on the canvases a run
    checked."""
    ev, block, canvases = check["ev"], check["block"], check["canvases"]
    low = reference_model(check["cfg"], check["sd"], canvases.device, quant)
    dets = [d for _, _, d, _ in reference_outputs(low, canvases, ev, block)]
    del low
    ref = reference_model(check["cfg"], check["sd"], canvases.device)
    return gaps(ref, canvases, dets, ev, block)[0].numbers()
