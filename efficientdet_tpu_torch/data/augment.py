"""Host augmentation on uint8 images: random affine, colour, crop and expand.

Counterpart of the JAX package's ``data/augment.py``, with the same
``numpy.random.RandomState`` draws in the same order, so a seed gives the
same matrices (and the same crops, expands and colour factors). The JAX
version calls cv2 for the warp, the channel mean, the lookup tables and the
RGB <-> HSV round trip; the machine that runs the port on the card need not
have cv2, so those are written here with torch on CPU tensors:

* ``warp_affine`` is ``cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT, 0)``:
  the destination pixel (x, y) samples the source at M^-1 (x, y) (pixel
  centres on the integers), bilinearly, with taps outside the image read as
  0. The coordinates are float32 with cv2's multiply-adds (each rounded
  once), the interpolation float32, the result rounded half to even.
  Against cv2 5.0 it differs by at most one grey level, on 0.0001-0.09% of
  the values (median 0.03%, 80 warps of 40 random sizes;
  ``tests/test_torch_augment.py`` holds one level and 0.1%).
* ``rgb_to_hsv`` / ``hsv_to_rgb`` are cv2's uint8 conversions (H in
  [0, 180)): RGB -> HSV in cv2's 12-bit fixed point, HSV -> RGB in float32
  with its multiply-adds, stored truncated in cv2's 32-pixel blocks and
  rounded in a row's remainder, as cv2 5.0 does on an AVX2 host. Both equal
  it on every input (the tests walk all of them); each is one lookup in a
  table of every 24-bit colour, made at first use.
* the contrast/brightness table and the channel mean are exact.

Matrices are 3x3 homogeneous, applied to the image (``warp_affine``) and to
the boxes (the four corners mapped, then re-axis-aligned).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------


def rotation_matrix(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def translation_matrix(tx: float, ty: float) -> np.ndarray:
    return np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float32)


def shear_matrix(angle: float) -> np.ndarray:
    return np.array([[1, -np.sin(angle), 0], [0, np.cos(angle), 0], [0, 0, 1]], np.float32)


def scaling_matrix(sx: float, sy: float) -> np.ndarray:
    return np.array([[sx, 0, 0], [0, sy, 0], [0, 0, 1]], np.float32)


def flip_matrix(flip_x: bool, flip_y: bool) -> np.ndarray:
    return scaling_matrix(-1.0 if flip_x else 1.0, -1.0 if flip_y else 1.0)


def center_transform(matrix: np.ndarray, image_hw: Tuple[int, int]) -> np.ndarray:
    """Apply ``matrix`` about the image centre."""
    h, w = image_hw
    center = translation_matrix(0.5 * w, 0.5 * h)
    uncenter = translation_matrix(-0.5 * w, -0.5 * h)
    return center @ matrix @ uncenter


def transform_boxes(matrix: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Transform xyxy boxes: map all four corners, re-axis-align."""
    if len(boxes) == 0:
        return boxes
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack(
        [np.stack([x1, y1], -1), np.stack([x2, y1], -1),
         np.stack([x1, y2], -1), np.stack([x2, y2], -1)],
        axis=1,
    )  # (N, 4, 2)
    ones = np.ones((*corners.shape[:2], 1), np.float32)
    hom = np.concatenate([corners, ones], -1) @ matrix.T  # (N, 4, 3)
    pts = hom[..., :2]
    out = np.concatenate([pts.min(axis=1), pts.max(axis=1)], -1)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Random geometric augmentation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """Ranges of the random affine; fields and defaults equal the JAX package's."""

    min_rotation: float = -0.1
    max_rotation: float = 0.1
    min_translation: Tuple[float, float] = (-0.1, -0.1)
    max_translation: Tuple[float, float] = (0.1, 0.1)
    min_shear: float = -0.1
    max_shear: float = 0.1
    min_scaling: Tuple[float, float] = (0.9, 0.9)
    max_scaling: Tuple[float, float] = (1.1, 1.1)
    flip_x_chance: float = 0.5
    flip_y_chance: float = 0.0


def random_transform_matrix(
    rng: np.random.RandomState,
    image_hw: Tuple[int, int],
    config: TransformConfig = TransformConfig(),
) -> np.ndarray:
    """rotation @ translation @ shear @ scaling @ flip about the image centre
    (the flip acts on points first; the translation is in pixels), drawn in
    that order."""
    c = config
    h, w = image_hw
    r = rotation_matrix(rng.uniform(c.min_rotation, c.max_rotation))
    tx = rng.uniform(c.min_translation[0], c.max_translation[0]) * w
    ty = rng.uniform(c.min_translation[1], c.max_translation[1]) * h
    t = translation_matrix(tx, ty)
    sh = shear_matrix(rng.uniform(c.min_shear, c.max_shear))
    sc = scaling_matrix(
        rng.uniform(c.min_scaling[0], c.max_scaling[0]),
        rng.uniform(c.min_scaling[1], c.max_scaling[1]),
    )
    f = flip_matrix(rng.uniform() < c.flip_x_chance, rng.uniform() < c.flip_y_chance)
    m = r @ t @ sh @ sc @ f
    return center_transform(m, image_hw)


def _invert_affine(matrix: np.ndarray) -> np.ndarray:
    """The (2, 3) inverse of an affine's top rows, in float64, as
    ``cv2.invertAffineTransform`` computes it."""
    m = np.asarray(matrix, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a`` (copied when it is not contiguous or not
    writable, as a decoded image may be)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _f32(t: torch.Tensor) -> torch.Tensor:
    """Round float64 values to float32, kept in float64."""
    return t.to(torch.float32).to(torch.float64)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product of two float32 values
    is exact in float64), as a fused multiply-add."""
    return _f32(a * b + c)


def _rgbx(image: np.ndarray, ring: int = 0) -> torch.Tensor:
    """(H, W, 3) uint8 -> (H + 2 ring, W + 2 ring, 4) uint8, zero padded,
    whose pixels read as one int32 each (``.view(torch.int32)``)."""
    h, w = image.shape[:2]
    out = torch.zeros((h + 2 * ring, w + 2 * ring, 4), dtype=torch.uint8)
    out[ring:ring + h, ring:ring + w, :3] = _tensor(image)
    return out


def warp_affine(image: np.ndarray, matrix: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(image, matrix[:2], (w, h), flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=0)`` for an (H, W, 3) uint8
    image, into an ``out_hw`` = (h, w) uint8 image.

    The sample coordinates are computed explicitly (no normalised grid):
    the destination pixel (x, y) reads the source at M^-1 (x, y), in float32
    with cv2's multiply-adds; the interpolation is float32.
    """
    h_out, w_out = out_hw
    h, w = image.shape[:2]
    m = torch.from_numpy(_invert_affine(matrix).astype(np.float32)).double()
    x = torch.arange(w_out, dtype=torch.float64)
    y = torch.arange(h_out, dtype=torch.float64)[:, None]
    sx = _fma(m[0, 0], x, _fma(m[0, 1], y, m[0, 2]))  # (h_out, w_out)
    sy = _fma(m[1, 0], x, _fma(m[1, 1], y, m[1, 2]))
    ix, iy = torch.floor(sx), torch.floor(sy)
    a = (sx - ix).float()[..., None]
    b = (sy - iy).float()[..., None]
    # taps on a zero ring around the image (any tap outside reads 0), one
    # int32 gather a tap
    flat = _rgbx(image, ring=1).view(torch.int32).view(-1)
    x0 = (ix.clamp(-1, w) + 1).int()
    x1 = (ix.clamp(-2, w - 1) + 2).int()
    r0 = (iy.clamp(-1, h) + 1).int() * (w + 2)
    r1 = (iy.clamp(-2, h - 1) + 2).int() * (w + 2)

    def tap(r, c):
        return flat.index_select(0, (r + c).view(-1)).view(torch.uint8).view(h_out, w_out, 4).float()

    v0 = torch.lerp(tap(r0, x0), tap(r0, x1), a)
    v1 = torch.lerp(tap(r1, x0), tap(r1, x1), a)
    out = torch.lerp(v0, v1, b).round_().clamp_(0, 255).to(torch.uint8)
    return out[..., :3].numpy()


def apply_transform(matrix: np.ndarray, image: np.ndarray, boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    h, w = image.shape[:2]
    return warp_affine(image, matrix, (h, w)), transform_boxes(matrix, boxes)


# ---------------------------------------------------------------------------
# Colour: cv2's uint8 HSV conversions, and the visual effects
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12
# cv2's tables: round((255 << 12) / v) and round((180 << 12) / (6 d)), 0 at 0
_SDIV = torch.tensor([0] + [int(np.rint((255 << _HSV_SHIFT) / i)) for i in range(1, 256)])
_HDIV = torch.tensor([0] + [int(np.rint((180 << _HSV_SHIFT) / (6.0 * i))) for i in range(1, 256)])
# (b, g, r) picks among (v, p, q, t) for each sector of the hue circle
_SECTOR = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
# cv2 5.0 (on an AVX2 host) converts HSV -> RGB in blocks of 32 pixels a
# row, whose stores truncate, and the rest of the row one pixel at a time,
# whose stores round half to even
HSV_BLOCK = 32


def _rgb_to_hsv_formula(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) int64 RGB -> HSV in cv2's 12-bit fixed point."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8)


def _hsv_to_rgb_formula(x: torch.Tensor, store) -> torch.Tensor:
    """(..., 3) HSV -> RGB in float32 with cv2's multiply-adds; ``store``
    (torch.trunc or torch.round) makes the uint8."""
    x = x.double()
    one = torch.ones((), dtype=torch.float64)
    s = _f32(x[..., 1] * _f32(torch.tensor(1.0 / 255)))
    v = _f32(x[..., 2] * _f32(torch.tensor(1.0 / 255)))
    hs = torch.fmod(_f32(x[..., 0] * _f32(torch.tensor(6.0 / 180))), 6.0)
    sector = torch.floor(hs)
    hf = _f32(hs - sector)
    outside = (sector < 0) | (sector >= 6)
    sector = torch.where(outside, 0.0, sector).long()
    hf = torch.where(outside, 0.0, hf)
    tab = torch.stack([v, _f32(v * _f32(one - s)), _f32(v * _fma(-s, hf, one)),
                       _f32(v * _fma(-s, _f32(one - hf), one))], -1)
    bgr = torch.gather(tab, -1, _SECTOR[sector])
    bgr = torch.where((s == 0)[..., None], v[..., None], bgr)
    return store(_f32(bgr.flip(-1) * 255.0)).clamp_(0, 255).to(torch.uint8)


_tables = {}
_tables_lock = threading.Lock()


def _table(name: str) -> torch.Tensor:
    """(2**24,) int32: the conversion of every 24-bit colour, indexed and
    stored as a pixel of ``_rgbx`` reads (bytes c0, c1, c2, 0 of a
    little-endian int32); made at first use (64 MB each)."""
    with _tables_lock:
        if name not in _tables:
            if sys.byteorder != "little":
                raise RuntimeError("the colour tables assume a little-endian host")
            c = torch.arange(1 << 24)
            every = torch.stack([c & 255, (c >> 8) & 255, c >> 16], -1)
            out = (_rgb_to_hsv_formula(every) if name == "rgb2hsv"
                   else _hsv_to_rgb_formula(every, torch.trunc)).int()
            _tables[name] = out[:, 0] | (out[:, 1] << 8) | (out[:, 2] << 16)
        return _tables[name]


def _convert(x: torch.Tensor, name: str) -> torch.Tensor:
    """(H, W, 4) uint8 -> (H, W, 4) uint8 through table ``name``."""
    return _table(name).index_select(0, x.view(torch.int32).view(-1)).view(torch.uint8).view(x.shape)


def _hsv_to_rgbx(hsv: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 HSV -> RGB as cv2 5.0 computes it on an AVX2 host
    (``HSV_BLOCK``)."""
    out = _convert(hsv, "hsv2rgb")
    tail = hsv.shape[1] - hsv.shape[1] % HSV_BLOCK
    if tail < hsv.shape[1]:
        out[:, tail:, :3] = _hsv_to_rgb_formula(hsv[:, tail:, :3], torch.round)
    return out


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_RGB2HSV)`` for (H, W, 3) uint8: H in
    [0, 180), S and V in [0, 255], in cv2's fixed point."""
    return _convert(_rgbx(image), "rgb2hsv")[..., :3].numpy()


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` for (H, W, 3) uint8 (H in
    [0, 180)), as cv2 5.0 computes it on an AVX2 host (``HSV_BLOCK``)."""
    return _hsv_to_rgbx(_rgbx(hsv))[..., :3].numpy()


def _lut_packed(px: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """``cv2.LUT`` with a (256, 3) table on pixels packed as ``_rgbx`` reads
    them (int32): byte c of each pixel through column c."""
    t = _tensor(table).int()
    out = t[:, 0].index_select(0, px & 255)
    out |= t[:, 1].index_select(0, (px >> 8) & 255) << 8
    out |= t[:, 2].index_select(0, px >> 16) << 16
    return out


def _lut(image: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``cv2.LUT`` with a (256, 3) table: channel c of each pixel through
    column c."""
    x = _rgbx(image)
    return _lut_packed(x.view(torch.int32).view(-1), table).view(torch.uint8).view(x.shape)[..., :3].numpy()


def adjust_brightness(image: np.ndarray, delta: float) -> np.ndarray:
    return np.clip(image.astype(np.float32) + delta * 255.0, 0, 255).astype(np.uint8)


def adjust_contrast(image: np.ndarray, factor: float) -> np.ndarray:
    mean = image.mean(axis=(0, 1), keepdims=True)
    return np.clip((image.astype(np.float32) - mean) * factor + mean, 0, 255).astype(np.uint8)


def adjust_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    hsv = rgb_to_hsv(image).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * factor, 0, 255)
    return hsv_to_rgb(hsv.astype(np.uint8))


def adjust_hue(image: np.ndarray, delta: float) -> np.ndarray:
    hsv = rgb_to_hsv(image).astype(np.int32)
    hsv[..., 0] = (hsv[..., 0] + int(delta * 180)) % 180
    return hsv_to_rgb(hsv.astype(np.uint8))


def _packed_mean(px: torch.Tensor) -> np.ndarray:
    sums = np.array([float(((px >> (8 * c)) & 255).sum(dtype=torch.int64)) for c in range(3)])
    return sums * (1.0 / px.numel())


def channel_mean(image: np.ndarray) -> np.ndarray:
    """(3,) float64 per-channel mean as ``cv2.mean`` computes it: the exact
    integer sum times the reciprocal of the pixel count."""
    return _packed_mean(_rgbx(image).view(torch.int32).view(-1))


def contrast_brightness_table(mean: np.ndarray, contrast: float, brightness: float) -> np.ndarray:
    """(256, 3) uint8: clip(clip((v - m) * contrast + m) + brightness * 255)
    per channel, both clips included, as the JAX package tabulates it."""
    v = np.arange(256, dtype=np.float32)[:, None]
    lut = np.clip((v - mean) * contrast + mean, 0, 255)
    return np.clip(lut + brightness * 255.0, 0, 255).astype(np.uint8)


def hue_saturation_table(hue: float, saturation: float) -> np.ndarray:
    """(256, 3) uint8 over an HSV image: H + hue * 180 mod 180, S scaled and
    clipped, V unchanged."""
    vi = np.arange(256, dtype=np.int32)
    return np.stack(
        [((vi + int(hue * 180)) % 180).astype(np.uint8),
         np.clip(vi.astype(np.float32) * saturation, 0, 255).astype(np.uint8),
         vi.astype(np.uint8)],
        axis=1,
    )


def random_visual_effect(
    rng: np.random.RandomState,
    image: np.ndarray,
    contrast_range=(0.9, 1.1),
    brightness_range=(-0.1, 0.1),
    hue_range=(-0.05, 0.05),
    saturation_range=(0.95, 1.05),
) -> np.ndarray:
    """contrast -> brightness -> hue -> saturation: contrast and brightness
    as one per-channel table of uint8 values, hue and saturation as one
    table over a single HSV round trip, as the JAX package fuses them."""
    contrast = rng.uniform(*contrast_range)
    brightness = rng.uniform(*brightness_range)
    hue = rng.uniform(*hue_range)
    saturation = rng.uniform(*saturation_range)
    x = _rgbx(image)
    px = x.view(torch.int32).view(-1)
    px = _lut_packed(px, contrast_brightness_table(_packed_mean(px), contrast, brightness))
    px = _lut_packed(_table("rgb2hsv").index_select(0, px), hue_saturation_table(hue, saturation))
    return _hsv_to_rgbx(px.view(torch.uint8).view(x.shape))[..., :3].numpy()


# ---------------------------------------------------------------------------
# Crop and expand
# ---------------------------------------------------------------------------


def random_crop(
    rng: np.random.RandomState,
    image: np.ndarray,
    boxes: np.ndarray,
    min_fraction: float = 0.6,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random crop keeping at least ``min_fraction`` of each side; the boxes
    shift into the crop (``batch_iterator`` filters the degenerate ones)."""
    h, w = image.shape[:2]
    ch = int(h * rng.uniform(min_fraction, 1.0))
    cw = int(w * rng.uniform(min_fraction, 1.0))
    y0 = rng.randint(0, h - ch + 1)
    x0 = rng.randint(0, w - cw + 1)
    out = image[y0: y0 + ch, x0: x0 + cw]
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] -= x0
        boxes[:, [1, 3]] -= y0
    return out, boxes


def random_expand(
    rng: np.random.RandomState,
    image: np.ndarray,
    boxes: np.ndarray,
    max_ratio: float = 1.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the image into a larger zero canvas at a random offset."""
    h, w = image.shape[:2]
    ratio = rng.uniform(1.0, max_ratio)
    nh, nw = int(h * ratio), int(w * ratio)
    y0 = rng.randint(0, nh - h + 1)
    x0 = rng.randint(0, nw - w + 1)
    canvas = np.zeros((nh, nw, 3), image.dtype)
    canvas[y0: y0 + h, x0: x0 + w] = image
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] += x0
        boxes[:, [1, 3]] += y0
    return canvas, boxes


# ---------------------------------------------------------------------------
# The augmenter for batch_iterator
# ---------------------------------------------------------------------------


def make_augmenter(
    transform_config: Optional[TransformConfig] = TransformConfig(),
    visual: bool = True,
    crop_chance: float = 0.0,
    expand_chance: float = 0.0,
) -> Callable:
    """``augment(rng, image, boxes, target_size=None)``: colour, then crop or
    expand (off by default), then the affine. With ``target_size`` the
    letterbox scale is composed into the affine and the image is warped
    once, straight into the (S, S) canvas: returns (canvas, boxes in canvas
    pixels, scale); without it, (image, boxes). With ``visual`` the colour
    tables are made here, in the caller's thread (once a process), not in
    the first worker to need them."""
    if visual:
        _table("rgb2hsv")
        _table("hsv2rgb")

    def augment(rng: np.random.RandomState, image: np.ndarray, boxes: np.ndarray,
                target_size: Optional[int] = None):
        if visual:
            image = random_visual_effect(rng, image)
        if crop_chance > 0 and rng.uniform() < crop_chance:
            image, boxes = random_crop(rng, image, boxes)
        elif expand_chance > 0 and rng.uniform() < expand_chance:
            image, boxes = random_expand(rng, image, boxes)
        if target_size is not None:
            h, w = image.shape[:2]
            scale = target_size / max(h, w)
            m = (random_transform_matrix(rng, (h, w), transform_config)
                 if transform_config is not None else np.eye(3))
            # the image samples at s * (x + 0.5) - 0.5 (half-pixel centres,
            # as the letterbox's resize); the boxes take the plain scale
            t = 0.5 * (scale - 1.0)
            m_img = np.array([[scale, 0.0, t], [0.0, scale, t], [0.0, 0.0, 1.0]], np.float64) @ m
            canvas = warp_affine(image, m_img, (target_size, target_size))
            m_box = scaling_matrix(scale, scale) @ m
            return canvas, transform_boxes(m_box, boxes), scale
        if transform_config is not None:
            m = random_transform_matrix(rng, image.shape[:2], transform_config)
            image, boxes = apply_transform(m, image, boxes)
        return image, boxes

    augment.supports_fused_letterbox = True
    return augment
