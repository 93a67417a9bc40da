"""The port's anchors, IoU, decode and clip against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import efficientdet_tpu.anchors as ja
import efficientdet_tpu.configs as jc
import efficientdet_tpu_torch.anchors as ta
import efficientdet_tpu_torch.configs as tc


@pytest.mark.parametrize("size,scale", [(512, 4.0), (128, 4.0), (1536, 5.0), (640, 4.0)])
def test_anchors_for_shape(size, scale):
    t = ta.anchors_for_shape((size, size), tc.AnchorConfig(anchor_scale=scale))
    j = ja.anchors_for_shape((size, size), jc.AnchorConfig(anchor_scale=scale))
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t, j)  # same numpy arithmetic: identical


def test_d0_anchor_count():
    assert ta.anchors_for_shape((512, 512)).shape == (49104, 4)


def _boxes(rng, n):
    xy = rng.uniform(-20, 300, (n, 2))
    wh = rng.uniform(-5, 120, (n, 2))  # some degenerate (negative extent)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_matrix_bitwise(seed):
    rng = np.random.RandomState(seed)
    a, b = _boxes(rng, 57), _boxes(rng, 131)
    b[:5] = a[:5]  # identical pairs: IoU exactly 1 where not degenerate
    want = np.asarray(ja.iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = ta.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    batched = ta.iou_matrix(torch.from_numpy(np.stack([a, a])), torch.from_numpy(np.stack([b, b])))
    np.testing.assert_array_equal(batched.numpy(), np.stack([want, want]))


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_and_clip(seed):
    rng = np.random.RandomState(seed)
    anchors = ta.anchors_for_shape((128, 128))
    deltas = rng.normal(0, 2.0, (3, anchors.shape[0], 4)).astype(np.float32)
    want = np.asarray(ja.clip_boxes(ja.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors)), (96, 128)))
    dec = ta.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors))
    got = ta.clip_boxes(dec, (96, 128)).numpy()
    # decode is a*b+c per coordinate; float32 rounding order is the same,
    # so only a contracted multiply-add could move a value by one ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[..., 0].max() <= 127 and got[..., 1].max() <= 95 and got.min() >= 0
    np.testing.assert_allclose(
        dec.numpy(),
        np.asarray(ja.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors))),
        rtol=1e-6, atol=1e-4,
    )
