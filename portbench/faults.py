"""Selection faults planted in the port underneath a run, to show that the
check's ``missed`` number catches them (``readings.py --faults``, at a
cell's size on the card, and ``tests/test_portbench_faults.py`` on the CPU).
The benchmark's own runs never plant one.

* ``drop_first_level``: the anchor prefilter scores every level but the
  finest (P3, about three quarters of the anchors) and keeps its top
  anchors from the others alone;
* ``drop_best_level``: the same for each image's level that holds its
  highest-scoring anchor (drawn weights can leave P3 without a detection,
  and then leaving it out changes no answer);
* ``invert_nms``: the suppression walks the candidates from the lowest
  score up, so of two overlapping boxes of one class it keeps the lower.

Each ``plant(name)`` returns a function that takes the fault out again.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _patch(module, name: str, make: Callable) -> Callable[[], None]:
    original = getattr(module, name)
    setattr(module, name, make(original))
    return lambda: setattr(module, name, original)


def drop_first_level() -> Callable[[], None]:
    import efficientdet_tpu_torch.models.detector as det

    def make(original):
        def front_end(anchors, box_out, cls_out, image_hw, config):
            z, amax_img, hws = cls_out
            amax_img = amax_img.clone()
            amax_img[:, :z.shape[0] * hws[0]] = float("-inf")  # the first level's anchors
            return original(anchors, box_out, (z, amax_img, hws), image_hw, config)
        return front_end

    return _patch(det, "batched_filter_from_anchor_major_levels", make)


def drop_best_level() -> Callable[[], None]:
    import efficientdet_tpu_torch.models.detector as det

    def make(original):
        def front_end(anchors, box_out, cls_out, image_hw, config):
            z, amax_img, hws = cls_out
            ends = torch.tensor([z.shape[0] * hw for hw in hws], device=amax_img.device).cumsum(0)
            level = torch.bucketize(amax_img.float().argmax(dim=1), ends, right=True)  # (B,)
            of = torch.bucketize(torch.arange(amax_img.shape[1], device=amax_img.device), ends,
                                 right=True)  # each anchor's level
            amax_img = amax_img.masked_fill(of[None, :] == level[:, None], float("-inf"))
            return original(anchors, box_out, (z, amax_img, hws), image_hw, config)
        return front_end

    return _patch(det, "batched_filter_from_anchor_major_levels", make)


def invert_nms() -> Callable[[], None]:
    import efficientdet_tpu_torch.ops.nms as nms

    def make(original):
        def keep_mask(boxes, classes, valid, iou_threshold=0.5):
            keep = original(boxes.flip(1).contiguous(), classes.flip(1).contiguous(),
                            valid.flip(1).contiguous(), iou_threshold)
            return keep.flip(1)
        return keep_mask

    return _patch(nms, "suppression_keep_mask", make)


FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {
    "drop_first_level": drop_first_level, "drop_best_level": drop_best_level,
    "invert_nms": invert_nms}


def plant(name: str) -> Callable[[], None]:
    return FAULTS[name]()
