"""utils/detections.detection_mismatch: one image's detections against another's."""

import numpy as np
import pytest

from efficientdet_tpu_torch.utils.detections import detection_mismatch


def _dets():
    boxes = np.array([[0, 0, 10, 10], [5, 5, 20, 20], [1, 2, 3, 4], [7, 7, 9, 9]], np.float32)
    scores = np.array([0.9, 0.5, 0.5 - 1e-6, 0.1], np.float32)
    classes = np.array([3, 1, 2, 3], np.int32)
    return boxes, scores, classes


def _swap(dets, i, j):
    out = [t.copy() for t in dets]
    for t in out[::2]:  # boxes and classes trade places; the scores stay sorted
        t[[i, j]] = t[[j, i]]
    return out


def _nudge(dets, which, index, by):
    out = [t.copy() for t in dets]
    out[which][index] += by
    return out


@pytest.mark.parametrize("case,got,agrees", [
    ("equal", _dets(), True),
    ("a near-tie swapped", _swap(_dets(), 1, 2), True),
    ("box within 1e-3 px", _nudge(_dets(), 0, 0, 5e-4), True),
    ("score within 1e-5", _nudge(_dets(), 1, 0, 5e-6), True),
    ("two far-apart scores swapped", _swap(_dets(), 0, 1), False),
    ("box past 1e-3 px", _nudge(_dets(), 0, 3, 2e-3), False),
    ("score past 1e-5", _nudge(_dets(), 1, 3, 2e-5), False),
    ("another class", _nudge(_dets(), 2, 0, 1), False),
    ("one fewer", [t[:3] for t in _dets()], False),
])
def test_detection_mismatch(case, got, agrees):
    fault = detection_mismatch(got, _dets(), box_px=1e-3, score_atol=1e-5)
    assert (fault is None) == agrees, (case, fault)


def test_no_detections_is_a_mismatch():
    empty = [t[:0] for t in _dets()]
    assert detection_mismatch(empty, empty, 1e-3, 1e-5) == "counts 0 and 0"


def test_relative_score_tolerance_widens_the_tie():
    """score_rtol: the scores' tolerance and the width of a tie grow with
    |want|."""
    got = _nudge(_dets(), 1, 0, 4e-3)
    assert detection_mismatch(got, _dets(), 1e-3, 1e-5) is not None
    assert detection_mismatch(got, _dets(), 1e-3, 1e-5, score_rtol=5e-3) is None
