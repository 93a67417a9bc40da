"""Augmentation of a letterboxed batch on the device, inside the training step.

Counterpart of the JAX package's ``ops/augment.py``: the same random affine
(applied jointly to the images and the boxes) and the same contrast,
brightness, hue and saturation, as float32 tensor operations on the batch's
device. The host then only reads and letterboxes (or nothing at all, from
``data/device_cache.py``).

Drawing and applying are separate. ``sample_transform_matrices`` and
``sample_color_factors`` draw from a ``torch.Generator`` (the training
step's, so an echoed batch gets a new view each time); ``apply_augment``
is deterministic: matrices and colour factors in, images and boxes out.
``augment_batch_device`` is the two together, drawing the matrices first
(rotation, translation x and y, shear, scaling x and y, flip x and y, each a
(B,) uniform draw in that order), then the colour factors (contrast,
brightness, hue, saturation). JAX splits its key instead, so the two
packages draw different numbers; the tests hold the apply against JAX on
identical matrices and factors, and the sampler by its ranges.
``draw_rows=(offset, total)`` draws every factor for a ``total``-image batch
and keeps the rows from ``offset``: a data-parallel rank's share of the
global batch's draws.

Semantics, as in the JAX package:

* transforms act on the letterboxed canvas (B, S, S, 3), conjugated about
  each image's visible extent centre, with translations scaled by the
  extent (a flip maps the image onto itself, not into the padding);
* the warp inverse-maps each destination pixel centre and samples
  bilinearly, reading 0 outside the source (``map_coordinates(order=1,
  cval=0)``; cv2's INTER_LINEAR + BORDER_CONSTANT up to its fixed point);
* boxes map all four corners, re-axis-align, clip to the visible extent,
  and a box narrower or lower than one pixel gets the label -1 (padding);
* the colour ops apply only inside the visible region that warped content
  covers; the contrast mean is over that region.

Images come back float32 in [0, 255].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..data.augment import TransformConfig


@dataclasses.dataclass(frozen=True)
class ColorConfig:
    """Ranges of the colour factors (``data.augment.random_visual_effect``'s)."""

    contrast_range: Tuple[float, float] = (0.9, 1.1)
    brightness_range: Tuple[float, float] = (-0.1, 0.1)
    hue_range: Tuple[float, float] = (-0.05, 0.05)
    saturation_range: Tuple[float, float] = (0.95, 1.05)


def _uniform(generator, n: int, lo: float, hi: float, device, draw_rows=None) -> torch.Tensor:
    offset, total = draw_rows or (0, n)
    return (torch.rand(total, generator=generator, device=device) * (hi - lo) + lo)[offset:offset + n]


def _extents(extents: Optional[torch.Tensor], batch: int, size: int, device) -> torch.Tensor:
    """(B, 2) float32 (scaled_h, scaled_w); the full canvas when None."""
    if extents is None:
        return torch.full((batch, 2), float(size), device=device)
    return torch.as_tensor(extents, device=device).float()


def _mat(rows) -> torch.Tensor:
    """3 x 3 nested lists of (B,) tensors -> (B, 3, 3)."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def sample_transform_matrices(
    generator: Optional[torch.Generator],
    batch_size: int,
    size: int,
    config: TransformConfig = TransformConfig(),
    extents: Optional[torch.Tensor] = None,
    device=None,
    draw_rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """(B, 3, 3) random affines about each visible image's centre:
    rotation @ translation @ shear @ scaling @ flip, conjugated by the
    centring translation, as the host ``random_transform_matrix`` composes
    them. ``extents`` (B, 2) = (scaled_h, scaled_w); None means the canvas."""
    c = config
    ext = _extents(extents, batch_size, size, device)
    device = ext.device
    ext_h, ext_w = ext[:, 0], ext[:, 1]

    def u(lo, hi):
        return _uniform(generator, batch_size, lo, hi, device, draw_rows)

    ang = u(c.min_rotation, c.max_rotation)
    tx = u(c.min_translation[0], c.max_translation[0]) * ext_w
    ty = u(c.min_translation[1], c.max_translation[1]) * ext_h
    shear = u(c.min_shear, c.max_shear)
    sx = u(c.min_scaling[0], c.max_scaling[0])
    sy = u(c.min_scaling[1], c.max_scaling[1])
    fx = torch.where(u(0.0, 1.0) < c.flip_x_chance, -1.0, 1.0)
    fy = torch.where(u(0.0, 1.0) < c.flip_y_chance, -1.0, 1.0)
    z, o = torch.zeros_like(ang), torch.ones_like(ang)
    cos, sin = torch.cos(ang), torch.sin(ang)
    rot = _mat([[cos, -sin, z], [sin, cos, z], [z, z, o]])
    trans = _mat([[o, z, tx], [z, o, ty], [z, z, o]])
    shr = _mat([[o, -torch.sin(shear), z], [z, torch.cos(shear), z], [z, z, o]])
    scl = _mat([[sx, z, z], [z, sy, z], [z, z, o]])
    flp = _mat([[fx, z, z], [z, fy, z], [z, z, o]])
    m = rot @ trans @ shr @ scl @ flp
    hx, hy = 0.5 * ext_w, 0.5 * ext_h
    center = _mat([[o, z, hx], [z, o, hy], [z, z, o]])
    uncenter = _mat([[o, z, -hx], [z, o, -hy], [z, z, o]])
    return center @ m @ uncenter


def sample_color_factors(
    generator: Optional[torch.Generator],
    batch_size: int,
    config: ColorConfig = ColorConfig(),
    device=None,
    draw_rows: Optional[Tuple[int, int]] = None,
) -> Dict[str, torch.Tensor]:
    """(B,) contrast, brightness, hue and saturation, drawn in that order."""
    return {name: _uniform(generator, batch_size, *rng, device, draw_rows)
            for name, rng in (("contrast", config.contrast_range),
                              ("brightness", config.brightness_range),
                              ("hue", config.hue_range),
                              ("saturation", config.saturation_range))}


def _inverse(m: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) float32 inverses as LU with partial pivoting, then two
    triangular solves against the identity (the JAX package's
    ``jnp.linalg.inv``; within a float32 ulp of it, where
    ``torch.linalg.inv`` is up to 30 ulps away)."""
    p, lower, upper = torch.linalg.lu(m)
    eye = torch.eye(3, dtype=m.dtype, device=m.device).expand_as(m)
    y = torch.linalg.solve_triangular(lower, p.transpose(-1, -2) @ eye, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(upper, y, upper=True)


def affine_warp_batch(images: torch.Tensor, matrices: torch.Tensor) -> torch.Tensor:
    """Warp (B, S, S, C) by per-image source -> destination affines, 0
    outside. Returns float32: each destination pixel centre (x, y) samples
    the source at M^-1 (x, y), bilinearly, a tap outside the image reading 0.
    The coordinates are computed explicitly, not through a normalised grid."""
    b, size, _, ch = images.shape
    x = images.float()
    inv = _inverse(matrices.float())
    g = torch.arange(size, dtype=torch.float32, device=x.device)
    gx, gy = g[None, None, :], g[None, :, None]
    src_x = inv[:, 0, 0, None, None] * gx + inv[:, 0, 1, None, None] * gy + inv[:, 0, 2, None, None]
    src_y = inv[:, 1, 0, None, None] * gx + inv[:, 1, 1, None, None] * gy + inv[:, 1, 2, None, None]
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx1, wy1 = src_x - x0, src_y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = x.reshape(b, size * size, ch)
    out = torch.zeros((b, size, size, ch), dtype=torch.float32, device=x.device)
    # the taps in map_coordinates' order: (y0, x0), (y0, x1), (y1, x0), (y1, x1)
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            valid = (yi >= 0) & (yi < size) & (xi >= 0) & (xi < size)
            idx = (yi.clamp(0, size - 1) * size + xi.clamp(0, size - 1)).long().view(b, -1, 1)
            tap = torch.gather(flat, 1, idx.expand(-1, -1, ch)).view(b, size, size, ch)
            out += (wy * wx)[..., None] * torch.where(valid[..., None], tap, 0.0)
    return out


def transform_boxes_batch(matrices: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) x (B, G, 4) xyxy -> the boxes of the four mapped corners,
    re-axis-aligned."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    corners = torch.stack([torch.stack([x1, y1], -1), torch.stack([x2, y1], -1),
                           torch.stack([x1, y2], -1), torch.stack([x2, y2], -1)], -2)  # (B, G, 4, 2)
    m = matrices.float()
    pts = torch.einsum("bij,bgcj->bgci", m[:, :2, :2], corners) + m[:, None, None, :2, 2]
    return torch.cat([pts.amin(-2), pts.amax(-2)], -1)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 1] -> HSV with H in [0, 1) (continuous, not cv2's 180 bins)."""
    r, g, b = rgb.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe = torch.where(d > 0, d, 1.0)
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = torch.where(d > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], -1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.long(), 6)
    # sector i: (r, g, b) from (v, q, p, t) as the JAX select lists them
    choices = torch.stack([v, q, p, t], -1)
    pick = torch.tensor([[0, 3, 2], [1, 0, 2], [2, 0, 3], [2, 1, 0], [3, 2, 0], [0, 2, 1]],
                        device=hsv.device)[i]
    return torch.gather(choices, -1, pick)


def apply_color_batch(
    images: torch.Tensor,
    factors: Dict[str, torch.Tensor],
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """contrast -> brightness -> hue -> saturation with (B,) ``factors``, on
    (B, S, S, 3) float32 in [0, 255]. ``mask`` (B, S, S, 1) in {0, 1}: colour
    applies only there, and the contrast mean is taken there; elsewhere the
    pixels pass unchanged."""
    def per_image(name):
        return factors[name].float().view(-1, 1, 1, 1)

    x0 = images.float()
    if mask is None:
        mean = x0.mean(dim=(1, 2), keepdim=True)
    else:
        n = mask.sum(dim=(1, 2), keepdim=True).clamp_min(1.0)
        mean = (x0 * mask).sum(dim=(1, 2), keepdim=True) / n
    x = torch.clamp((x0 - mean) * per_image("contrast") + mean, 0, 255)
    x = torch.clamp(x + per_image("brightness") * 255.0, 0, 255)
    hsv = _rgb_to_hsv(x / 255.0)
    h = torch.remainder(hsv[..., 0] + per_image("hue")[..., 0], 1.0)
    s = torch.clamp(hsv[..., 1] * per_image("saturation")[..., 0], 0.0, 1.0)
    x = torch.clamp(_hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], -1)) * 255.0, 0, 255)
    if mask is not None:
        x = x * mask + x0 * (1.0 - mask)
    return x


def apply_augment(
    images: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    extents: Optional[torch.Tensor] = None,
    matrices: Optional[torch.Tensor] = None,
    color_factors: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The deterministic half of ``augment_batch_device``: warp by
    ``matrices`` (None: no warp), colour by ``color_factors`` (None: none),
    clip the boxes to the extents, label -1 on the degenerate ones."""
    b, size = images.shape[0], images.shape[1]
    x = images.float()
    hi = _extents(extents, b, size, x.device)
    rows = torch.arange(size, dtype=torch.float32, device=x.device)
    ext_mask = ((rows[None, :, None] < hi[:, 0, None, None])
                & (rows[None, None, :] < hi[:, 1, None, None]))[..., None].float()
    if matrices is not None:
        # an alpha channel warped beside RGB marks where content landed, so
        # the colour skips warped-in borders (the host colours before its
        # warp, so its borders stay black too)
        w4 = affine_warp_batch(torch.cat([x, ext_mask * 255.0], -1), matrices)
        x = w4[..., :3] * ext_mask
        vis = (w4[..., 3:] > 127.5).float() * ext_mask
        gt_boxes = transform_boxes_batch(matrices, gt_boxes.float())
    else:
        vis = ext_mask
    if color_factors is not None:
        x = apply_color_batch(x, color_factors, mask=vis)
    lim = torch.stack([hi[:, 1], hi[:, 0], hi[:, 1], hi[:, 0]], -1)
    gt_boxes = torch.minimum(torch.clamp(gt_boxes.float(), min=0.0), lim[:, None, :])
    w = gt_boxes[..., 2] - gt_boxes[..., 0]
    h = gt_boxes[..., 3] - gt_boxes[..., 1]
    gt_labels = torch.where((w >= 1.0) & (h >= 1.0), gt_labels, torch.full_like(gt_labels, -1))
    return x, gt_boxes, gt_labels


def augment_batch_device(
    generator: Optional[torch.Generator],
    images: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    extents: Optional[torch.Tensor] = None,
    transform_config: TransformConfig = TransformConfig(),
    color_config: ColorConfig = ColorConfig(),
    geometric: bool = True,
    color: bool = True,
    draw_rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Augment a letterboxed batch on its device.

    images (B, S, S, 3) uint8 or float in [0, 255]; gt_boxes (B, G, 4) xyxy
    canvas pixels; gt_labels (B, G), -1 padding; extents (B, 2) the visible
    (scaled_h, scaled_w), None for the whole canvas. ``generator``: the draws'
    source on the images' device (the default generator when None).
    Returns (images float32 in [0, 255], boxes, labels).
    """
    b, size = images.shape[0], images.shape[1]
    matrices = (sample_transform_matrices(generator, b, size, transform_config, extents,
                                          device=images.device, draw_rows=draw_rows)
                if geometric else None)
    factors = (sample_color_factors(generator, b, color_config, device=images.device,
                                    draw_rows=draw_rows)
               if color else None)
    return apply_augment(images, gt_boxes, gt_labels, extents, matrices, factors)
