"""The port's host and device augmentation against the JAX package's.

Host (``data/augment.py``), from the same RandomState seeds:
* the matrices within 1e-12;
* the warp (``warp_affine``, no cv2) against the JAX path's
  ``cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT)``: at most one grey level,
  on at most 0.1% of the values (measured with cv2 5.0: 0.0001-0.09%, median
  0.03%, over 80 warps of 40 random sizes); the boxes within 1e-4 px;
* the contrast/brightness table, the channel mean and cv2's uint8 RGB <-> HSV
  round trip exact (the conversions on every input), so the visual effect,
  hue wrap at 180 included, equals the JAX one bit for bit;
* crop and expand exact.

Device (``ops/augment.py``) against ``efficientdet_tpu.ops.augment`` on
identical matrices and colour factors (drawn by JAX, applied by both): float32
within 1e-3 on the [0, 255] scale, boxes within 1e-5, labels exact; the
sampler by its ranges, its flip share and the extent clip.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import efficientdet_tpu.data.augment as J
import efficientdet_tpu.ops.augment as JD
import efficientdet_tpu_torch.data.augment as P
import efficientdet_tpu_torch.ops.augment as PD

WARP_MAX = 1
WARP_SHARE = 1e-3
BOX_TOL = 1e-4
DEV_TOL = 1e-3
DEV_BOX_TOL = 1e-5

SHAPES = [(480, 640), (97, 203), (300, 200), (64, 64)]


def _image(seed, hw):
    return np.random.RandomState(seed).randint(0, 256, hw + (3,)).astype(np.uint8)


def _boxes(seed, hw, n=6):
    rng = np.random.RandomState(seed)
    h, w = hw
    xy = rng.uniform(0, [w * 0.7, h * 0.7], (n, 2))
    wh = rng.uniform(2, [w * 0.3, h * 0.3], (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_matrices_match_jax(seed):
    cfg = J.TransformConfig(flip_y_chance=0.3)
    for hw in SHAPES:
        want = J.random_transform_matrix(np.random.RandomState(seed), hw, cfg)
        got = P.random_transform_matrix(np.random.RandomState(seed), hw, P.TransformConfig(flip_y_chance=0.3))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert got.dtype == want.dtype
    assert P.TransformConfig() == P.TransformConfig(**vars(J.TransformConfig()))


def _warp_diff(got, want):
    d = np.abs(got.astype(int) - want)
    return d.max(), (d > 0).mean()


@pytest.mark.parametrize("hw", SHAPES)
def test_warp_matches_cv2(hw):
    img = _image(1, hw)
    boxes = _boxes(2, hw)
    for seed in range(3):
        m = J.random_transform_matrix(np.random.RandomState(seed), hw)
        want_img, want_boxes = J.apply_transform(m, img, boxes)
        got_img, got_boxes = P.apply_transform(m, img, boxes)
        dmax, share = _warp_diff(got_img, want_img)
        assert dmax <= WARP_MAX and share <= WARP_SHARE, (dmax, share)
        np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=BOX_TOL)
    # a large rotation and an enlarging, shifted warp: the borders read 0
    for m in (np.array([[0.6, -0.8, 40.0], [0.8, 0.6, -20.0], [0, 0, 1]]),
              np.array([[1.7, 0.1, -13.5], [-0.05, 2.2, 7.25], [0, 0, 1]])):
        want = cv2.warpAffine(img, m[:2], (hw[1] + 9, hw[0] - 5), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        dmax, share = _warp_diff(P.warp_affine(img, m, (hw[0] - 5, hw[1] + 9)), want)
        assert dmax <= WARP_MAX and share <= WARP_SHARE, (dmax, share)


def test_identity_warp_is_exact():
    img = _image(3, (50, 70))
    np.testing.assert_array_equal(P.warp_affine(img, np.eye(3), (50, 70)), img)


@pytest.mark.parametrize("hw", SHAPES)
def test_fused_augmenter_matches_jax(hw):
    """Colour, then the affine composed with the letterbox, warped once into
    the canvas: the same draws, the image within the warp's tolerance."""
    img, boxes = _image(4, hw), _boxes(5, hw)
    for seed in range(2):
        for visual in (False, True):
            want = J.make_augmenter(visual=visual)(np.random.RandomState(seed), img, boxes, target_size=128)
            got = P.make_augmenter(visual=visual)(np.random.RandomState(seed), img, boxes, target_size=128)
            dmax, share = _warp_diff(got[0], want[0])
            assert dmax <= WARP_MAX and share <= WARP_SHARE, (dmax, share)
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=BOX_TOL)
            assert got[2] == want[2]
        # without target_size: the warp at the image's own size
        want = J.make_augmenter()(np.random.RandomState(seed), img, boxes)
        got = P.make_augmenter()(np.random.RandomState(seed), img, boxes)
        dmax, share = _warp_diff(got[0], want[0])
        assert dmax <= WARP_MAX and share <= WARP_SHARE
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=BOX_TOL)


def test_rgb_to_hsv_equals_cv2_on_every_colour():
    c = np.arange(1 << 24)
    every = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(P.rgb_to_hsv(every), cv2.cvtColor(every, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [256, 40, 13])
def test_hsv_to_rgb_equals_cv2_on_every_input(width):
    """Every (H < 180, S, V), in rows whose width is a multiple of the
    32-pixel block (256), has a remainder (40) or is all remainder (13)."""
    c = np.arange(180 * 256 * 256)
    every = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1)
    every = every[: len(every) // width * width].reshape(-1, width, 3).astype(np.uint8)
    np.testing.assert_array_equal(P.hsv_to_rgb(every), cv2.cvtColor(every, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("hw", SHAPES + [(1080, 1920)])
def test_visual_effect_matches_jax_exactly(hw):
    img = _image(6, hw)
    for seed in range(3):
        want = J.random_visual_effect(np.random.RandomState(seed), img)
        np.testing.assert_array_equal(P.random_visual_effect(np.random.RandomState(seed), img), want)
    # the contrast/brightness table and the channel mean alone
    mean = np.asarray(cv2.mean(img)[:3])
    np.testing.assert_array_equal(P.channel_mean(img), mean)
    lut = P.contrast_brightness_table(mean, 1.07, -0.04)
    np.testing.assert_array_equal(P._lut(img, lut), cv2.LUT(img, lut.reshape(1, 256, 3)))


def test_single_effects_and_the_hue_wrap_match_jax():
    """Saturated colours across the hue wrap at 180: a hue one bin off there
    would be a large RGB jump, and none is."""
    h = np.arange(180, dtype=np.uint8)
    hsv = np.stack(np.broadcast_arrays(h[:, None], np.uint8(255), np.arange(0, 256, 5, dtype=np.uint8)[None]),
                   -1).astype(np.uint8)
    img = cv2.cvtColor(np.ascontiguousarray(hsv), cv2.COLOR_HSV2RGB)
    for delta in (-0.05, -0.011, 0.013, 0.05, 0.5):
        np.testing.assert_array_equal(P.adjust_hue(img, delta), J.adjust_hue(img, delta))
    for factor in (0.9, 1.05):
        np.testing.assert_array_equal(P.adjust_saturation(img, factor), J.adjust_saturation(img, factor))
        np.testing.assert_array_equal(P.adjust_contrast(img, factor), J.adjust_contrast(img, factor))
    np.testing.assert_array_equal(P.adjust_brightness(img, 0.07), J.adjust_brightness(img, 0.07))


@pytest.mark.parametrize("fn", ["random_crop", "random_expand"])
def test_crop_and_expand_match_jax(fn):
    img, boxes = _image(7, (90, 130)), _boxes(8, (90, 130))
    for seed in range(4):
        want = getattr(J, fn)(np.random.RandomState(seed), img, boxes)
        got = getattr(P, fn)(np.random.RandomState(seed), img, boxes)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for kw in (dict(crop_chance=1.0), dict(expand_chance=1.0)):
        want = J.make_augmenter(**kw)(np.random.RandomState(1), img, boxes, target_size=96)
        got = P.make_augmenter(**kw)(np.random.RandomState(1), img, boxes, target_size=96)
        assert _warp_diff(got[0], want[0])[0] <= WARP_MAX
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=BOX_TOL)


# ---------------------------------------------------------------------------
# Device augmentation
# ---------------------------------------------------------------------------

B, S, G = 3, 48, 5
EXTENTS = np.array([[48, 36], [30, 48], [48, 48]], np.float32)


def _device_batch(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    for i, (h, w) in enumerate(EXTENTS.astype(int)):
        images[i, h:] = 0
        images[i, :, w:] = 0
    xy = rng.uniform(0, 30, (B, G, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 20, (B, G, 2))], -1).astype(np.float32)
    labels = rng.randint(0, 5, (B, G)).astype(np.int32)
    labels[:, -1] = -1
    return images, boxes, labels


def _jax_draws(key):
    """The matrices and colour factors augment_batch_device draws from key."""
    k_geo, k_col = jax.random.split(key)
    mats = JD.sample_transform_matrices(k_geo, B, S, JD.TransformConfig(), extents=jnp.asarray(EXTENTS))
    mats = np.array(mats)
    c = JD.ColorConfig()
    keys = jax.random.split(k_col, 4)
    factors = {name: np.asarray(jax.random.uniform(k, (B,), jnp.float32, *rng))
               for name, k, rng in zip(("contrast", "brightness", "hue", "saturation"), keys,
                                       (c.contrast_range, c.brightness_range, c.hue_range, c.saturation_range))}
    return mats, factors


@pytest.mark.parametrize("seed", range(3))
def test_warp_and_boxes_match_jax(seed):
    images, boxes, _ = _device_batch(seed)
    mats, _ = _jax_draws(jax.random.PRNGKey(seed))
    want = np.asarray(JD.affine_warp_batch(jnp.asarray(images), jnp.asarray(mats)))
    got = PD.affine_warp_batch(torch.from_numpy(images), torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DEV_TOL)
    want_b = np.asarray(JD.transform_boxes_batch(jnp.asarray(mats), jnp.asarray(boxes)))
    got_b = PD.transform_boxes_batch(torch.from_numpy(mats), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=0, atol=DEV_BOX_TOL)


def test_hsv_conversions_match_jax():
    rgb = np.random.RandomState(0).uniform(0, 1, (4000, 3)).astype(np.float32)
    rgb[:100] = np.round(rgb[:100] * 4) / 4  # ties between channels, greys
    want = np.asarray(JD._rgb_to_hsv(jnp.asarray(rgb)))
    got = PD._rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DEV_TOL / 255)
    np.testing.assert_allclose(PD._hsv_to_rgb(torch.from_numpy(want.copy())).numpy(),
                               np.asarray(JD._hsv_to_rgb(jnp.asarray(want))), rtol=0, atol=DEV_TOL / 255)


@pytest.mark.parametrize("masked", [False, True])
def test_color_apply_matches_jax(masked, monkeypatch):
    images, _, _ = _device_batch(1)
    x = images.astype(np.float32)
    _, factors = _jax_draws(jax.random.PRNGKey(5))
    mask = (np.random.RandomState(2).uniform(size=(B, S, S, 1)) > 0.3).astype(np.float32) if masked else None
    # JAX's random_color_batch draws its own factors: hand it ours
    draws = iter([factors[k][:, None, None] for k in ("contrast", "brightness", "hue", "saturation")])
    monkeypatch.setattr(JD.jax.random, "uniform", lambda *a, **k: jnp.asarray(next(draws)))
    want = np.asarray(JD.random_color_batch(jax.random.PRNGKey(0), jnp.asarray(x),
                                            mask=None if mask is None else jnp.asarray(mask)))
    got = PD.apply_color_batch(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in factors.items()},
                               None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DEV_TOL)


@pytest.mark.parametrize("geometric, color", [(True, True), (True, False), (False, True)])
def test_augment_batch_matches_jax(geometric, color):
    """augment_batch_device of JAX against the port's apply on JAX's draws."""
    images, boxes, labels = _device_batch(3)
    key = jax.random.PRNGKey(11)
    mats, factors = _jax_draws(key)
    want = JD.augment_batch_device(key, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(labels),
                                   extents=jnp.asarray(EXTENTS), geometric=geometric, color=color)
    got = PD.apply_augment(torch.from_numpy(images), torch.from_numpy(boxes), torch.from_numpy(labels),
                           torch.from_numpy(EXTENTS), torch.from_numpy(mats) if geometric else None,
                           {k: torch.from_numpy(v) for k, v in factors.items()} if color else None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=DEV_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=DEV_BOX_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[0].dtype == torch.float32


def test_sampler_ranges_and_flip_share():
    n = 4000
    g = torch.Generator().manual_seed(0)
    cfg = P.TransformConfig()
    mats = PD.sample_transform_matrices(g, n, 64, cfg, device="cpu")
    assert mats.shape == (n, 3, 3) and torch.equal(mats[:, 2], torch.tensor([0.0, 0.0, 1.0]).expand(n, 3))
    # the linear part is rot @ shear @ scale @ flip: its determinant is
    # sx * sy * cos(shear) * flip, its sign the flip
    det = torch.linalg.det(mats[:, :2, :2])
    flips = (det < 0).float().mean().item()
    assert abs(flips - cfg.flip_x_chance) < 4 * (0.25 / n) ** 0.5
    scale = det.abs()
    assert scale.min() >= 0.9 * 0.9 * np.cos(0.1) - 1e-5 and scale.max() <= 1.1 * 1.1 + 1e-5
    f = PD.sample_color_factors(g, n, device="cpu")
    c = PD.ColorConfig()
    for name, (lo, hi) in (("contrast", c.contrast_range), ("brightness", c.brightness_range),
                           ("hue", c.hue_range), ("saturation", c.saturation_range)):
        assert lo <= f[name].min() and f[name].max() <= hi and f[name].std() > (hi - lo) / 4
    # the same generator state gives the same draws
    a = PD.sample_transform_matrices(torch.Generator().manual_seed(3), 4, 64, device="cpu")
    b = PD.sample_transform_matrices(torch.Generator().manual_seed(3), 4, 64, device="cpu")
    assert torch.equal(a, b)


def test_extent_clip_and_degenerate_labels():
    images, boxes, labels = _device_batch(4)
    boxes[0, 0] = [30, 5, 45, 20]      # past the first image's width (36): clipped
    boxes[1, 1] = [5, 31, 20, 40]      # below the second image's height (30): degenerate
    boxes[2, 2] = [10, 10, 10.5, 30]   # half a pixel wide: degenerate
    out, b, lab = PD.augment_batch_device(torch.Generator().manual_seed(0), torch.from_numpy(images),
                                          torch.from_numpy(boxes), torch.from_numpy(labels),
                                          torch.from_numpy(EXTENTS), geometric=False, color=False)
    np.testing.assert_array_equal(out.numpy(), images.astype(np.float32))
    assert b[0, 0].tolist() == [30, 5, 36, 20] and lab[0, 0] == labels[0, 0]
    assert lab[1, 1] == -1 and lab[2, 2] == -1
    assert (lab[:, -1] == -1).all()
    ext = torch.from_numpy(EXTENTS)
    out, b, lab = PD.augment_batch_device(torch.Generator().manual_seed(1), torch.from_numpy(images),
                                          torch.from_numpy(boxes), torch.from_numpy(labels), ext)
    assert (b >= 0).all() and (b[..., 2] <= ext[:, 1, None]).all() and (b[..., 3] <= ext[:, 0, None]).all()
    valid = lab >= 0
    assert ((b[..., 2] - b[..., 0])[valid] >= 1).all() and ((b[..., 3] - b[..., 1])[valid] >= 1).all()
    # the letterbox padding stays black, the values in [0, 255]
    assert out[0, :, 36:].abs().max() == 0 and out[1, 30:].abs().max() == 0
    assert out.min() >= 0 and out.max() <= 255
