"""Feature-map resampling for the BiFPN, on NCHW tensors.

Up: nearest-neighbour (2x on the main path). Down: 3x3 stride-2 max-pool
with the JAX package's SAME padding: for an even size the pad is (0, 1), for
an odd one (1, 1), filled with -inf, so the output is ceil(H/2).
Under a spatial ``parallel_context`` a band pools with its neighbours' halo
rows, and a whole level upsamples into a banded one by its band's rows
(parallel/context.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.context import active_context


def same_pads(size: int, kernel: int, stride: int):
    """(before, after) padding of flax/XLA ``padding="SAME"`` on one dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def upsample_to(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest upsample (B, C, H, W) -> (B, C, out_h, out_w)."""
    ctx = active_context()
    if ctx is not None and ctx.kind == "spatial":
        band = ctx.upsample(x, out_w, _upsample)
        if band is not None:
            return band
    return _upsample(x, out_h, out_w)


def _upsample(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    if out_h == 2 * h and out_w == 2 * w:
        return F.interpolate(x, scale_factor=2.0, mode="nearest")
    # jax.image.resize "nearest" samples at half-pixel centres
    return F.interpolate(x, size=(out_h, out_w), mode="nearest-exact")


def downsample_maxpool(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, ceil(H/2), ceil(W/2)) max-pool, SAME padding."""
    ctx = active_context()
    if ctx is not None and ctx.banded(x):
        return ctx.maxpool(x, window, stride, lambda whole: _maxpool(whole, window, stride))
    return _maxpool(x, window, stride)


def _maxpool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    ph = same_pads(x.shape[-2], window, stride)
    pw = same_pads(x.shape[-1], window, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)
