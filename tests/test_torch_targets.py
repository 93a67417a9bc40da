"""The port's anchor-target assignment against the JAX package's, on the CPU.

``encode_boxes``, ``anchor_targets_compact``, ``anchor_targets`` (one-hot)
and their batch forms on the anchors of a 128 px image, with ground truth
drawn with numpy from a seed: labels and anchor states exactly equal, box
targets within 1e-6. The cases: padding rows (whose boxes are not zero, so
only the mask keeps them out), an image with no ground truth, two boxes
with equal IoU at an anchor (the first index wins), boxes on the image
border, and a random batch. ``encode_boxes`` alone, on deltas up to ~10,
agrees within 1e-6 relative.
"""

import jax
import numpy as np
import pytest
import torch

import efficientdet_tpu.anchors as ja
import efficientdet_tpu_torch.anchors as ta

SIZE = 128
BOX_TOL = 1e-6
ANCHORS = ja.anchors_for_shape((SIZE, SIZE))


def _random_boxes(rng, n, size=SIZE):
    x1 = rng.uniform(0, size * 0.7, n)
    y1 = rng.uniform(0, size * 0.7, n)
    w = rng.uniform(8, size * 0.5, n)
    h = rng.uniform(8, size * 0.5, n)
    return np.stack([x1, y1, np.minimum(x1 + w, size - 1), np.minimum(y1 + h, size - 1)], -1).astype(np.float32)


def _cases():
    rng = np.random.RandomState(0)
    g = 6
    # padding rows: three real boxes, three padding rows with real-looking boxes
    pad_boxes = _random_boxes(rng, g)
    pad_labels = np.array([2, 0, 5, -1, -1, -1], np.int32)
    # no ground truth at all
    none_boxes = np.zeros((g, 4), np.float32)
    none_labels = np.full((g,), -1, np.int32)
    # the same box twice with two labels: every anchor ties, the first wins
    tie = _random_boxes(rng, 1)[0]
    tie_boxes = np.stack([tie, tie] + list(_random_boxes(rng, g - 2)))
    tie_labels = np.array([3, 1, 4, -1, -1, -1], np.int32)
    # boxes on the image border
    border_boxes = np.array([[0, 0, 40, 40], [90, 0, 127, 60], [0, 100, 50, 127],
                             [64, 64, 127, 127], [0, 0, 127, 127], [0, 0, 0, 0]], np.float32)
    border_labels = np.array([0, 1, 2, 3, 4, -1], np.int32)
    return {"padding": (pad_boxes, pad_labels), "no_gt": (none_boxes, none_labels),
            "equal_iou": (tie_boxes, tie_labels), "border": (border_boxes, border_labels)}


CASES = _cases()


@pytest.fixture(scope="module")
def jax_fns():
    compact = jax.jit(lambda a, b, l: ja.anchor_targets_compact(a, b, l, 0.5, 0.4))
    onehot = jax.jit(lambda a, b, l: ja.anchor_targets(a, b, l, 6, 0.5, 0.4))
    batch_compact = jax.jit(lambda a, b, l: ja.anchor_targets_batch_compact(a, b, l, 0.5, 0.4))
    batch_onehot = jax.jit(lambda a, b, l: ja.anchor_targets_batch(a, b, l, 6, 0.5, 0.4))
    return compact, onehot, batch_compact, batch_onehot


def _check(got, want):
    labels, boxes, state = (np.asarray(t) for t in want)
    g_labels, g_boxes, g_state = (t.numpy() for t in got)
    assert g_labels.dtype == labels.dtype
    np.testing.assert_array_equal(g_labels, labels)
    np.testing.assert_array_equal(g_state, state)
    np.testing.assert_allclose(g_boxes, boxes, rtol=0, atol=BOX_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_targets_match_jax(case, jax_fns):
    boxes, labels = CASES[case]
    want = jax_fns[0](ANCHORS, boxes, labels)
    got = ta.anchor_targets_compact(torch.from_numpy(ANCHORS), torch.from_numpy(boxes),
                                    torch.from_numpy(labels))
    _check(got, want)
    state = got[2].numpy()
    if case == "no_gt":
        assert (state == 0).all() and (got[0].numpy() == -1).all()
    else:
        assert (state == 1).any() and (state == -1).any()
    if case == "equal_iou":
        # the tied box's anchors take the first row's label, never the second's
        assert 3 in got[0].numpy() and 1 not in got[0].numpy()
    if case == "padding":
        assert set(np.unique(got[0].numpy())) <= {-1, 0, 2, 5}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_hot_targets_match_jax(case, jax_fns):
    boxes, labels = CASES[case]
    want = jax_fns[1](ANCHORS, boxes, labels)
    got = ta.anchor_targets(torch.from_numpy(ANCHORS), torch.from_numpy(boxes),
                            torch.from_numpy(labels), num_classes=6)
    assert got[0].dtype == torch.float32 and got[0].shape == (len(ANCHORS), 6)
    _check(got, want)


def test_batch_forms_match_jax(jax_fns):
    rng = np.random.RandomState(1)
    b, g = 3, 8
    boxes = np.stack([_random_boxes(rng, g) for _ in range(b)])
    labels = rng.randint(0, 6, (b, g)).astype(np.int32)
    labels[0, 5:] = -1
    labels[2, :] = -1  # an image without ground truth inside the batch
    tb, tl, tanc = torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(ANCHORS)
    _check(ta.anchor_targets_batch_compact(tanc, tb, tl), jax_fns[2](ANCHORS, boxes, labels))
    _check(ta.anchor_targets_batch(tanc, tb, tl, 6), jax_fns[3](ANCHORS, boxes, labels))
    got = ta.anchor_targets_batch_compact(tanc, tb, tl)
    for i in range(b):  # the batch form is the single-image form per image
        for x, y in zip(got, ta.anchor_targets_compact(tanc, tb[i], tl[i])):
            assert torch.equal(x[i], y)
    with pytest.raises(ValueError, match="expected"):
        ta.anchor_targets_batch_compact(tanc, tb[0], tl[0])


def test_encode_boxes_matches_jax():
    rng = np.random.RandomState(2)
    gt = _random_boxes(rng, len(ANCHORS))
    want = np.asarray(jax.jit(ja.encode_boxes)(gt, ANCHORS))
    got = ta.encode_boxes(torch.from_numpy(gt), torch.from_numpy(ANCHORS)).numpy()
    # deltas up to ~10 between unrelated boxes and anchors: XLA may divide by
    # a reciprocal, so one float32 ulp (1e-6 relative) apart
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=BOX_TOL)
    # encode inverts decode
    back = ta.decode_boxes(torch.from_numpy(got), torch.from_numpy(ANCHORS)).numpy()
    np.testing.assert_allclose(back, gt, rtol=1e-5, atol=1e-3)
