"""The port's evaluators against the JAX package's.

``CocoEvaluator``, ``_compute_ap``, ``evaluate_voc`` and ``compute_overlap``
(the C++ library and numpy) on tests/test_eval.py's hand fixtures and on
random fixtures: every statistic within 1e-12, the IoU matrices exact.
``collect_detections`` with a fake prediction function (the port's
``predict_fn(images)``, JAX's ``predict_fn(variables, images)``) gives
identical result lists; ``resolve_model_args`` behaves as JAX's.
"""

import json

import numpy as np
import pytest
import torch

from efficientdet_tpu.evaluate import resolve_model_args as j_resolve
from efficientdet_tpu.evaluation import coco_eval as JC
from efficientdet_tpu.evaluation import host_overlap as JH
from efficientdet_tpu.evaluation import voc as JV
from efficientdet_tpu_torch.evaluate import resolve_model_args
from efficientdet_tpu_torch.evaluation import coco_eval as PC
from efficientdet_tpu_torch.evaluation import host_overlap as PH
from efficientdet_tpu_torch.evaluation import voc as PV
from efficientdet_tpu_torch.data import DetectionDataset

TOL = 1e-12


def gt(img, cat, x, y, w, h, crowd=0):
    return {"image_id": img, "category_id": cat, "bbox": [x, y, w, h], "area": w * h, "iscrowd": crowd}


def det(img, cat, x, y, w, h, score):
    return {"image_id": img, "category_id": cat, "bbox": [x, y, w, h], "score": score}


# tests/test_eval.py's fixtures: (gts, image ids, category ids, detections)
HAND = {
    "perfect": ([gt(1, 1, 10, 10, 50, 60), gt(1, 1, 200, 200, 40, 40), gt(2, 1, 5, 5, 30, 30)], [1, 2], [1],
                [det(1, 1, 10, 10, 50, 60, 0.9), det(1, 1, 200, 200, 40, 40, 0.9), det(2, 1, 5, 5, 30, 30, 0.9)]),
    "half_recall": ([gt(1, 1, 10, 10, 50, 50), gt(1, 1, 200, 200, 50, 50)], [1], [1],
                    [det(1, 1, 10, 10, 50, 50, 0.9)]),
    "fp_after_tp": ([gt(1, 1, 10, 10, 50, 50)], [1], [1],
                    [det(1, 1, 10, 10, 50, 50, 0.9), det(1, 1, 300, 300, 50, 50, 0.5)]),
    "iou_sweep": ([gt(1, 1, 0, 0, 100, 100)], [1], [1], [det(1, 1, 25, 0, 100, 100, 0.9)]),
    "crowd": ([gt(1, 1, 0, 0, 100, 100, crowd=1), gt(1, 1, 300, 300, 50, 50)], [1], [1],
              [det(1, 1, 10, 10, 50, 50, 0.9), det(1, 1, 300, 300, 50, 50, 0.8)]),
    "areas": ([gt(1, 1, 0, 0, 10, 10), gt(1, 1, 100, 100, 200, 200)], [1], [1],
              [det(1, 1, 0, 0, 10, 10, 0.9), det(1, 1, 100, 100, 200, 200, 0.8)]),
    "max_dets": ([gt(1, 1, 0, 0, 50, 50), gt(1, 1, 200, 200, 50, 50)], [1], [1],
                 [det(1, 1, 0, 0, 50, 50, 0.9), det(1, 1, 200, 200, 50, 50, 0.8)]),
    "duplicate": ([gt(1, 1, 0, 0, 100, 100)], [1], [1],
                  [det(1, 1, 0, 0, 100, 100, 0.9), det(1, 1, 1, 1, 100, 100, 0.8)]),
}


def _random_fixture(seed, images=12, cats=(1, 3, 7)):
    """Ground truth of every size range (a few crowd), detections near it
    and elsewhere, with tied and distinct scores."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for img in range(images):
        for _ in range(rng.randint(0, 8)):
            w, h = rng.uniform(4, 200, 2)
            x, y = rng.uniform(0, 400, 2)
            c = int(rng.choice(cats))
            gts.append(gt(img, c, float(x), float(y), float(w), float(h), crowd=int(rng.uniform() < 0.08)))
            for _ in range(rng.randint(0, 3)):
                jit = rng.normal(0, [w * 0.15, h * 0.15, w * 0.1, h * 0.1])
                dets.append(det(img, c, *(float(v) for v in np.array([x, y, w, h]) + jit),
                                float(np.round(rng.uniform(), 2))))
        for _ in range(rng.randint(0, 5)):
            dets.append(det(img, int(rng.choice(cats)), *(float(v) for v in rng.uniform(0, 300, 4)),
                            float(rng.uniform())))
    return gts, list(range(images)), list(cats), dets


FIXTURES = dict(HAND, **{f"random{s}": _random_fixture(s) for s in range(4)})


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_coco_evaluator_matches_jax(name):
    gts, image_ids, cats, dets = FIXTURES[name]
    stats = []
    for mod in (JC, PC):
        ev = mod.CocoEvaluator(gts, image_ids, cats)
        ev.add_detections(dets)
        acc = ev.accumulate()
        stats.append((ev.summarize(acc), acc))
    (js, jacc), (ps, pacc) = stats
    assert list(ps) == list(js) == list(PC.STAT_NAMES)
    for k in js:
        assert abs(ps[k] - js[k]) <= TOL, (k, ps[k], js[k])
    np.testing.assert_allclose(pacc["precision"], jacc["precision"], rtol=0, atol=TOL)
    np.testing.assert_allclose(pacc["recall"], jacc["recall"], rtol=0, atol=TOL)


def test_compute_ap_matches_jax():
    rng = np.random.RandomState(0)
    cases = [(np.array([1.0]), np.array([1.0])), (np.array([0.5]), np.array([1.0])),
             (np.array([0.5, 1.0]), np.array([1.0, 0.5]))]
    for _ in range(20):
        n = rng.randint(1, 40)
        tp = np.cumsum(rng.uniform(size=n) < 0.6)
        cases.append((tp / max(tp[-1], 1) * rng.uniform(0.3, 1), tp / np.arange(1, n + 1)))
    for rec, prec in cases:
        assert abs(PV._compute_ap(rec, prec) - JV._compute_ap(rec, prec)) <= TOL


def _boxes(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(-2, 60, (n, 2))], 1)  # some degenerate


def test_compute_overlap_matches_jax():
    assert PH.using_native(), PH.build_error
    rng = np.random.RandomState(1)
    for n, k in ((1, 1), (7, 3), (50, 40), (0, 5), (5, 0)):
        a, b = _boxes(rng, n), _boxes(rng, k)
        want = JH.compute_overlap_numpy(a, b)
        np.testing.assert_array_equal(PH.compute_overlap(a, b), want)
        np.testing.assert_array_equal(PH.compute_overlap_numpy(a, b), want)
        # the JAX package's library is built with -march=native, so its
        # multiply-adds may be fused: within an ulp of numpy, not equal
        np.testing.assert_allclose(JH.compute_overlap(a, b), want, rtol=1e-15, atol=0)
    assert PH._lib_path().endswith(".so") and "/_build/" in PH._lib_path().replace("\\", "/")


class FixedDataset(DetectionDataset):
    """Images of three shapes with ground truth; ``coco`` and ``cat_ids``
    as evaluate_coco reads them."""

    def __init__(self, n=7, seed=0):
        rng = np.random.RandomState(seed)
        self.shapes = [[(40, 60), (64, 32), (50, 50)][i % 3] for i in range(n)]
        self.anns = []
        for h, w in self.shapes:
            k = rng.randint(1, 4)
            xy = rng.uniform(0, [w * 0.5, h * 0.5], (k, 2))
            boxes = np.concatenate([xy, xy + rng.uniform(3, [w * 0.5, h * 0.5], (k, 2))], 1)
            self.anns.append((boxes.astype(np.float32), rng.randint(0, 3, k).astype(np.int32)))
        self.cat_ids = [1, 2, 5]
        self.label_to_coco_label = dict(enumerate(self.cat_ids))
        annotations = [{"image_id": i, "category_id": self.cat_ids[int(c)],
                        "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])],
                        "area": float((b[2] - b[0]) * (b[3] - b[1])), "iscrowd": 0}
                       for i, (bs, cs) in enumerate(self.anns) for b, c in zip(bs, cs)]
        self.coco = type("Index", (), {"dataset": {"annotations": annotations}})()

    def __len__(self):
        return len(self.shapes)

    def load_image(self, index):
        return np.full(self.shapes[index] + (3,), index * 20, np.uint8)

    def load_annotations(self, index):
        return self.anns[index]

    def num_classes(self):
        return 3


def _fake_predict(size):
    """Detections from each canvas's first pixel (its dataset index): the
    ground truth in canvas pixels, jittered, plus a false positive."""
    ds = FixedDataset()

    def predict(images):
        b = len(images)
        boxes = np.zeros((b, 10, 4), np.float32)
        scores = np.zeros((b, 10), np.float32)
        classes = np.zeros((b, 10), np.int32)
        n = np.zeros((b,), np.int32)
        for i, img in enumerate(images):
            di = int(img[0, 0, 0]) // 20
            h, w = ds.shapes[di]
            scale = size / max(h, w)
            gb, gl = ds.anns[di]
            k = len(gb)
            boxes[i, :k] = gb * scale + (di % 3) * 0.7
            boxes[i, k] = [1, 1, 9, 9]
            scores[i, :k + 1] = np.linspace(0.9, 0.02, k + 1)
            classes[i, :k] = gl
            classes[i, k] = 2
            n[i] = k + 1
        return torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes), torch.from_numpy(n)

    return predict


@pytest.mark.parametrize("batch_size, max_images", [(3, None), (4, 5), (8, None)])
def test_collect_and_evaluate_match_jax(batch_size, max_images):
    """The last batch's wrap-padded duplicates are dropped, the boxes scaled
    back by each image's letterbox scale: the same results as JAX's."""
    ds, size = FixedDataset(), 64
    p_predict = _fake_predict(size)

    def j_predict(variables, images):
        return tuple(t.numpy() for t in p_predict(images))

    kw = dict(batch_size=batch_size, max_images=max_images)
    want = JC.collect_detections(ds, j_predict, None, size, **kw)
    got = PC.collect_detections(ds, p_predict, size, **kw)
    assert got == want and len(got) > 0
    assert PC.evaluate_coco(ds, p_predict, size, **kw) == JC.evaluate_coco(ds, j_predict, None, size, **kw)
    for thr in (0.5, 0.75):
        want_aps = JV.evaluate_voc(ds, j_predict, None, size, iou_threshold=thr, **kw)
        got_aps = PV.evaluate_voc(ds, p_predict, size, iou_threshold=thr, **kw)
        assert got_aps.keys() == want_aps.keys()
        for c in want_aps:
            assert abs(got_aps[c][0] - want_aps[c][0]) <= TOL and got_aps[c][1] == want_aps[c][1]
        assert abs(PV.mean_ap(got_aps) - JV.mean_ap(want_aps)) <= TOL


def test_save_detections_and_label_map(tmp_path):
    ds, size = FixedDataset(), 64
    path = tmp_path / "dets.json"
    PC.evaluate_coco(ds, _fake_predict(size), size, batch_size=4, save_detections=str(path))
    saved = json.loads(path.read_text())
    assert saved == PC.collect_detections(ds, _fake_predict(size), size, batch_size=4)
    # a label outside the map is dropped
    got = PC.collect_detections(ds, _fake_predict(size), size, batch_size=4, label_to_cat={0: 11, 1: 12})
    assert {r["category_id"] for r in got} == {11, 12}


@pytest.mark.parametrize("saved, cli", [
    (None, (0, None, None, 3)),
    ({"model": {"phi": 2, "weighted_bifpn": False, "image_size": 256, "num_classes": 3}}, (0, None, None, 3)),
    ({"model": {"phi": 2, "weighted_bifpn": False, "image_size": 256, "num_classes": 3}}, (2, True, 384, 3)),
    ({"model": {"phi": 1, "num_classes": 90}}, (None, None, None, 3)),
    ({"train": {}}, (4, True, 128, 3)),
])
def test_resolve_model_args_matches_jax(saved, cli, capsys):
    want = j_resolve(saved, *cli)
    j_out = capsys.readouterr().out
    assert resolve_model_args(saved, *cli) == want
    assert capsys.readouterr().out == j_out
