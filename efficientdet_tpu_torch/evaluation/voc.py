"""VOC-style mAP evaluation: counterpart of the JAX package's
``evaluation/voc.py`` (``predict_fn(images)`` closes over the model, as in
``coco_eval``).

Per class: collect detections over the dataset (score-sorted), greedily match
against GT at a single IoU threshold, build precision/recall, and compute AP
by continuous integration of the precision envelope (the reference's
``_compute_ap``). The IoU hot loop uses the C++ host op when built
(``cc/compute_overlap``), else the numpy fallback — both exact.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .coco_eval import _numpy
from .host_overlap import compute_overlap


def _compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Continuous VOC AP: area under the precision envelope."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_voc(
    dataset,
    predict_fn,
    image_size: int,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.01,
    max_detections: int = 100,
    batch_size: int = 8,
    max_images: Optional[int] = None,
) -> Dict[int, Tuple[float, int]]:
    """Returns {label: (AP, num_annotations)} (reference evaluate())."""
    from ..data.common import batch_iterator

    n_img = len(dataset) if max_images is None else min(max_images, len(dataset))
    num_classes = dataset.num_classes()

    # _get_detections + _get_annotations
    all_dets: List[List[np.ndarray]] = [
        [None] * num_classes for _ in range(n_img)
    ]
    all_gts: List[List[np.ndarray]] = [[None] * num_classes for _ in range(n_img)]

    seen = set()
    it = batch_iterator(
        dataset, batch_size, target_size=image_size, shuffle=False,
        drop_last=False,
    )
    for batch in it:
        boxes, scores, classes, nvalid = (_numpy(t) for t in predict_fn(batch["images"]))
        for bi, di in enumerate(batch["indices"]):
            di = int(di)
            if di in seen or di >= n_img:
                continue
            seen.add(di)
            scale = float(batch["scales"][bi])
            k = int(nvalid[bi])
            img_boxes = boxes[bi, :k] / scale
            img_scores = scores[bi, :k]
            img_classes = classes[bi, :k]
            keep = img_scores > score_threshold
            img_boxes, img_scores, img_classes = (
                img_boxes[keep][:max_detections],
                img_scores[keep][:max_detections],
                img_classes[keep][:max_detections],
            )
            gt_boxes, gt_labels = dataset.load_annotations(di)
            for c in range(num_classes):
                sel = img_classes == c
                all_dets[di][c] = np.concatenate(
                    [img_boxes[sel], img_scores[sel, None]], -1
                )
                all_gts[di][c] = gt_boxes[gt_labels == c]
        if len(seen) >= n_img:
            break

    aps: Dict[int, Tuple[float, int]] = {}
    for c in range(num_classes):
        fps, tps, scores_c = [], [], []
        num_annotations = 0
        for i in range(n_img):
            gts = all_gts[i][c]
            dets = all_dets[i][c]
            num_annotations += len(gts)
            if dets is None or len(dets) == 0:
                continue
            order = np.argsort(-dets[:, 4], kind="stable")
            dets = dets[order]
            scores_c.extend(dets[:, 4].tolist())
            if len(gts) == 0:
                fps.extend([1] * len(dets))
                tps.extend([0] * len(dets))
                continue
            # ONE IoU matrix per (image, class) — the reference's
            # compute_overlap call shape — then greedy row-wise assignment
            # in score order with each GT matched at most once.
            overlaps = compute_overlap(
                dets[:, :4].astype(np.float64), gts.astype(np.float64)
            )  # (D, G)
            detected = set()
            for row in overlaps:
                gi = int(np.argmax(row))
                if row[gi] >= iou_threshold and gi not in detected:
                    detected.add(gi)
                    tps.append(1)
                    fps.append(0)
                else:
                    fps.append(1)
                    tps.append(0)
        if num_annotations == 0:
            aps[c] = (0.0, 0)
            continue
        if not scores_c:
            aps[c] = (0.0, num_annotations)
            continue
        order = np.argsort(-np.asarray(scores_c), kind="stable")
        fp = np.cumsum(np.asarray(fps)[order])
        tp = np.cumsum(np.asarray(tps)[order])
        recall = tp / num_annotations
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        aps[c] = (_compute_ap(recall, precision), num_annotations)
    return aps


def mean_ap(aps: Dict[int, Tuple[float, int]]) -> float:
    """Unweighted mean AP over classes that have annotations (the
    reference's default ``weighted_average=False`` semantics: each present
    class counts equally, regardless of its annotation count)."""
    present = [(ap, n) for ap, n in aps.values() if n > 0]
    if not present:
        return 0.0
    return float(np.mean([ap for ap, _ in present]))
