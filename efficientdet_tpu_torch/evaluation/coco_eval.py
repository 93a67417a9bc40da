"""COCO detection evaluation in numpy (pycocotools' COCOeval 'bbox'
protocol), and the collection of a model's detections over a dataset.

Counterpart of the JAX package's ``evaluation/coco_eval.py``; the evaluator
is a numpy copy of it, so the same detections give the same statistics:

* 10 IoU thresholds 0.50:0.05:0.95; 101-point interpolated precision at
  recall thresholds 0:0.01:1.
* Area ranges all/small/medium/large = [0,1e10]/[0,32^2]/[32^2,96^2]/
  [96^2,1e10] on the *annotation* area field (segmentation area when
  present, else box area).
* maxDets 1/10/100; greedy per-image matching in descending score order,
  each non-crowd GT used once; crowd GTs use intersection-over-det-area
  ("iof") and may absorb multiple detections; ignored GTs (crowd or
  out-of-area) don't count as FP absorbers for npig.
* The 12 summary statistics in the official order.

Detections arrive as the standard results format:
``{"image_id", "category_id", "bbox": [x, y, w, h], "score"}``.

In PyTorch's idiom the model holds its weights, so the prediction function
is ``predict_fn(images)``, closing over the model, in place of the JAX
package's ``predict_fn(variables, images)``: it takes a batch's (B, S, S, 3)
uint8 numpy canvases and returns (boxes, scores, classes, num_valid) as
tensors (on any device) or arrays. ``make_batch_predict_fn`` makes one from a
model.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)

STAT_NAMES = (
    "AP", "AP50", "AP75", "APs", "APm", "APl",
    "AR1", "AR10", "AR100", "ARs", "ARm", "ARl",
)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU (D, G) on xywh boxes; crowd gt -> intersection/det_area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), np.float64)
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.clip(
        np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]),
        0, None,
    )
    iy = np.clip(
        np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]),
        0, None,
    )
    inter = ix * iy
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class CocoEvaluator:
    """Accumulating evaluator over (gt annotations, detection results)."""

    def __init__(
        self,
        gt_annotations: Iterable[dict],
        image_ids: Sequence[int],
        category_ids: Sequence[int],
    ):
        """gt_annotations: COCO 'annotations' dicts (bbox xywh, category_id,
        image_id, optional area/iscrowd/ignore)."""
        self.image_ids = list(image_ids)
        self.category_ids = list(category_ids)
        self._gts: Dict[Tuple[int, int], List[dict]] = defaultdict(list)
        for ann in gt_annotations:
            self._gts[(ann["image_id"], ann["category_id"])].append(ann)
        self._dets: Dict[Tuple[int, int], List[dict]] = defaultdict(list)
        self._iou_cache: Dict[Tuple[int, int], np.ndarray] = {}

    def add_detections(self, results: Iterable[dict]) -> None:
        self._iou_cache.clear()
        for r in results:
            self._dets[(r["image_id"], r["category_id"])].append(r)

    # -- per-image matching ------------------------------------------------
    #
    # Matching runs once per (image, category, area) at the LARGEST maxDets;
    # smaller maxDets are exact truncations (greedy matching processes
    # detections in score order, so earlier assignments don't depend on
    # later detections) — the same factorisation pycocotools uses. The IoU
    # matrix is additionally cached per (image, category) across areas.

    def _ious(self, img_id: int, cat_id: int, gts, dts):
        key = (img_id, cat_id)
        got = self._iou_cache.get(key)
        if got is not None:
            return got
        g_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        d_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        g_crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])
        out = _iou_xywh(d_boxes, g_boxes, g_crowd)
        self._iou_cache[key] = out
        return out

    def _evaluate_image(
        self, img_id: int, cat_id: int, area_rng: Tuple[float, float], max_det: int
    ) -> Optional[dict]:
        gts = self._gts.get((img_id, cat_id), [])
        dts = self._dets.get((img_id, cat_id), [])
        if not gts and not dts:
            return None

        ious_raw = self._ious(img_id, cat_id, gts, dts)

        g_ignore = np.array(
            [
                bool(g.get("ignore", 0))
                or bool(g.get("iscrowd", 0))
                or not (
                    area_rng[0]
                    <= g.get("area", g["bbox"][2] * g["bbox"][3])
                    <= area_rng[1]
                )
                for g in gts
            ],
            bool,
        )
        # sort gts: non-ignored first (pycocotools convention)
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        g_crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])

        d_scores = np.array([d["score"] for d in dts], np.float64)
        d_order = np.argsort(-d_scores, kind="stable")[:max_det]
        dts = [dts[i] for i in d_order]
        d_scores = d_scores[d_order]

        d_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        ious = ious_raw[np.ix_(d_order, g_order)] if len(gts) and len(dts) else (
            np.zeros((len(dts), len(gts)))
        )

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dtm = np.zeros((T, D), np.int64)  # matched gt index + 1, 0 = none
        gtm = np.zeros((T, G), np.int64)
        dt_ig = np.zeros((T, D), bool)

        for ti, t in enumerate(IOU_THRS):
            for di in range(D):
                best_iou = min(t, 1 - 1e-10)
                best_g = -1
                for gi in range(G):
                    if gtm[ti, gi] > 0 and not g_crowd[gi]:
                        continue  # gt already used (crowd may absorb more)
                    if best_g > -1 and not g_ignore[best_g] and g_ignore[gi]:
                        break  # gts sorted: only ignored remain, keep match
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dt_ig[ti, di] = g_ignore[best_g]
                dtm[ti, di] = best_g + 1
                gtm[ti, best_g] = di + 1

        # unmatched detections outside the area range are ignored
        d_areas = d_boxes[:, 2] * d_boxes[:, 3]
        d_out = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
        dt_ig = dt_ig | ((dtm == 0) & d_out[None])

        return {
            "scores": d_scores,
            "dtm": dtm,
            "dt_ignore": dt_ig,
            "num_gt": int((~g_ignore).sum()),
        }

    # -- accumulation --------------------------------------------------------

    def accumulate(self) -> dict:
        T = len(IOU_THRS)
        R = len(REC_THRS)
        K = len(self.category_ids)
        A = len(AREA_RANGES)
        M = len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for ki, cat in enumerate(self.category_ids):
            for ai, area_rng in enumerate(AREA_RANGES.values()):
                all_img = [
                    self._evaluate_image(img, cat, area_rng, MAX_DETS[-1])
                    for img in self.image_ids
                ]
                all_img = [e for e in all_img if e is not None]
                if not all_img:
                    continue
                npig = sum(e["num_gt"] for e in all_img)
                if npig == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    # exact per-image truncation of the maxDets[-1] matching
                    per_img = all_img
                    scores = np.concatenate(
                        [e["scores"][:max_det] for e in per_img]
                    )
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dtm"][:, :max_det] for e in per_img], 1
                    )[:, order]
                    dt_ig = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in per_img], 1
                    )[:, order]
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, 1).astype(np.float64)
                    fp_sum = np.cumsum(fps, 1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # precision envelope (monotone non-increasing)
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        return {"precision": precision, "recall": recall}

    def summarize(self, accumulated: Optional[dict] = None) -> Dict[str, float]:
        acc = accumulated or self.accumulate()
        p, r = acc["precision"], acc["recall"]

        def ap(iou=None, area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = p[:, :, :, ai, mi]
            if iou is not None:
                s = s[np.isclose(IOU_THRS, iou)]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        def ar(area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = r[:, :, ai, mi]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        return {
            "AP": ap(),
            "AP50": ap(iou=0.5),
            "AP75": ap(iou=0.75),
            "APs": ap(area="small"),
            "APm": ap(area="medium"),
            "APl": ap(area="large"),
            "AR1": ar(max_det=1),
            "AR10": ar(max_det=10),
            "AR100": ar(max_det=100),
            "ARs": ar(area="small"),
            "ARm": ar(area="medium"),
            "ARl": ar(area="large"),
        }


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def make_batch_predict_fn(model, eval_config=None, mesh=None):
    """``predict_fn(images)`` for the evaluators over ``model`` (its device,
    its current weights and mode): the numpy canvases go to the model's
    device and through ``make_predict_fn``'s ``"anchor_major"`` front end
    (normalise, forward, decode, NMS: the head and NMS kernels on the GPU).
    Through ``make_sharded_predict_fn`` over ``mesh`` (parallel/mesh.py;
    None: this process alone): each rank predicts its rows of the batch and
    every rank gets all the detections."""
    import torch

    from ..parallel import Mesh, make_sharded_predict_fn

    device = next(model.parameters()).device
    predict = make_sharded_predict_fn(model, mesh or Mesh(0, 1, device), eval_config)

    def predict_fn(images):
        return predict(torch.as_tensor(images).to(device, non_blocking=True))

    return predict_fn


def collect_detections(
    dataset,
    predict_fn,
    image_size: int,
    batch_size: int = 8,
    score_threshold: float = 0.05,
    max_images: Optional[int] = None,
    label_to_cat: Optional[Dict[int, int]] = None,
) -> List[dict]:
    """Run batched prediction over a dataset -> COCO results list.

    ``predict_fn(images_uint8) -> (boxes, scores, classes, n)`` (see the
    module docstring).
    Boxes come back in model-input coords and are rescaled to source pixels
    by the per-image letterbox scale (reference SS3.3: "rescale boxes").

    ``label_to_cat``: optional override of the dataset's label->category-id
    mapping, for models whose class space differs from the dataset's (e.g.
    official automl checkpoints are 90-class over the 91-id COCO space:
    category_id = label + 1, while the dataset maps its 80 actual
    categories contiguously). Labels absent from the mapping are DROPPED —
    they have no annotations to match and unknown category ids would make
    the saved results JSON unloadable by pycocotools.
    """
    from ..data.common import batch_iterator

    to_cat = (
        label_to_cat
        if label_to_cat is not None
        else getattr(dataset, "label_to_coco_label", None)
    )
    seen = set()
    results: List[dict] = []
    n_limit = len(dataset) if max_images is None else min(max_images, len(dataset))
    it = batch_iterator(
        dataset, batch_size, target_size=image_size, shuffle=False,
        drop_last=False, augment=None,
    )
    for batch in it:
        boxes, scores, classes, nvalid = (_numpy(t) for t in predict_fn(batch["images"]))
        for bi, di in enumerate(batch["indices"]):
            di = int(di)
            if di in seen or di >= n_limit:
                continue  # wrap-padded duplicate from the last batch
            seen.add(di)
            img_id = dataset.image_id(di)
            scale = float(batch["scales"][bi])
            for k in range(int(nvalid[bi])):
                if scores[bi, k] < score_threshold:
                    continue
                x1, y1, x2, y2 = boxes[bi, k] / scale
                label = int(classes[bi, k])
                cat = to_cat.get(label) if to_cat is not None else label
                if to_cat is not None and cat is None:
                    continue  # class outside the dataset's category set
                results.append(
                    {
                        "image_id": img_id,
                        "category_id": cat,
                        "bbox": [
                            float(x1), float(y1),
                            float(x2 - x1), float(y2 - y1),
                        ],
                        "score": float(scores[bi, k]),
                    }
                )
        if len(seen) >= n_limit:
            break
    return results


def evaluate_coco(
    dataset,
    predict_fn,
    image_size: int,
    batch_size: int = 8,
    score_threshold: float = 0.05,
    max_images: Optional[int] = None,
    save_detections: Optional[str] = None,
    label_to_cat: Optional[Dict[int, int]] = None,
) -> Dict[str, float]:
    """End-to-end COCO eval (reference ``eval/coco.py`` Evaluate callback).

    ``save_detections``: optional path; writes the raw detection dicts
    ({image_id, category_id, bbox xywh, score}) as a COCO results JSON —
    the file ``COCO.loadRes`` consumes and the test-dev server accepts
    (the reference workflow's submission artifact).
    ``label_to_cat``: see :func:`collect_detections`.
    """
    results = collect_detections(
        dataset, predict_fn, image_size, batch_size,
        score_threshold, max_images, label_to_cat=label_to_cat,
    )
    if save_detections:
        import json as _json

        with open(save_detections, "w") as f:
            _json.dump(results, f)
    image_ids = [
        dataset.image_id(i)
        for i in range(
            len(dataset) if max_images is None else min(max_images, len(dataset))
        )
    ]
    ev = CocoEvaluator(
        dataset.coco.dataset.get("annotations", []),
        image_ids,
        dataset.cat_ids,
    )
    ev.add_detections(results)
    return ev.summarize()
