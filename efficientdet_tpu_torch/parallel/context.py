"""What a parallel step changes inside the model, switched on by a context.

The model's layers take no parallel knobs. ``make_sharded_*`` and
``make_spatial_*`` run the model inside ``with parallel_context(ctx):``, and
the few layers whose arithmetic reaches across ranks ask
:func:`active_context` what to do:

* data parallel (``ParallelContext(mesh, "data")``): training-mode BN
  normalises with the per-channel sums of ``x`` and ``x^2`` and the count
  all-reduced over the ranks (the global batch's statistics, as the JAX
  step on the global batch computes them), and stochastic depth draws its
  keep masks for the global batch and keeps the rank's rows;
* spatial (``ParallelContext(mesh, "spatial", image_size)``): every
  activation is split by height into one band a rank (:class:`BandLayout`).
  SAME convs and the stride-2 max-pool exchange halo rows with the
  neighbouring bands (zero or -inf rows only at the image's real edges);
  the SE's mean, and BN in training, all-reduce their sums over the bands;
  levels too thin to split are gathered and computed whole on every rank.

A tensor's level is read from its width, which is never split: an NCHW
tensor of width W belongs to stride ``image_size // W``.

The active context is one slot of this module, not a ``contextvars``
variable, because the autograd engine's device threads must see it when a
remat block is recomputed in the backward pass. Outside the ``with``, or
with no context, every layer runs its serial code unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import collectives as C
from .mesh import split_rows

_ACTIVE: List["ParallelContext"] = []

MIN_BAND_ROWS = 2  # the widest halo: 5x5 SAME pads two rows on a side


class BandLayout:
    """The height bands of a ``size``-pixel image over ``world`` ranks.

    One split, made at the coarsest stride ``unit`` (a power of two) at which
    every rank still gets ``MIN_BAND_ROWS`` rows, fixes every level's bands:
    at stride ``s <= unit`` rank r holds rows ``[bounds[r] // s, bounds[r+1]
    // s)``, so each level's band is exactly twice the next coarser one's
    and the BiFPN's 2x upsample stays local. Units are dealt as evenly as
    they go (the first ranks one more when they do not divide). Levels of
    stride above ``unit`` (fewer rows than the ranks need) are whole.
    """

    def __init__(self, size: int, world: int, rank: int):
        if size // world < MIN_BAND_ROWS:
            raise ValueError(f"{size} rows cannot give {world} ranks {MIN_BAND_ROWS} rows each")
        unit = 1
        while size % (2 * unit) == 0 and size // (2 * unit) // world >= MIN_BAND_ROWS:
            unit *= 2
        self.size, self.world, self.rank, self.unit = size, world, rank, unit
        self.bounds = [lo * unit for lo, _ in split_rows(size // unit, world)] + [size]

    def banded(self, stride: int) -> bool:
        return stride <= self.unit

    def band(self, stride: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """Rank ``rank``'s (this rank's) rows of the stride-``stride`` level."""
        r = self.rank if rank is None else rank
        return self.bounds[r] // stride, self.bounds[r + 1] // stride

    def rows(self, stride: int) -> int:
        """The level's full height."""
        return -(-self.size // stride)


class ParallelContext:
    """``kind`` "data" or "spatial" over ``mesh``; ``image_size`` fixes the
    spatial band layout."""

    def __init__(self, mesh, kind: str, image_size: Optional[int] = None):
        if kind not in ("data", "spatial"):
            raise ValueError(f"unknown parallel kind {kind!r}")
        self.mesh, self.kind = mesh, kind
        self.group, self.rank, self.world = mesh.group, mesh.rank, mesh.world_size
        self.layout = BandLayout(image_size, self.world, self.rank) if kind == "spatial" else None

    # --- data parallel -------------------------------------------------
    def draw_rows(self, batch: int) -> Optional[Tuple[int, int]]:
        """(offset, total) of this rank's images in the global batch's draws,
        or None when every rank holds the whole batch."""
        if self.kind != "data":
            return None
        return self.rank * batch, self.world * batch

    # --- which tensors are split ---------------------------------------
    def stride_of(self, x: torch.Tensor) -> int:
        return self.layout.size // x.shape[-1]

    def banded(self, x: torch.Tensor) -> bool:
        return self.kind == "spatial" and self.layout.banded(self.stride_of(x))

    def syncs_bn(self, x: torch.Tensor) -> bool:
        return self.kind == "data" or self.banded(x)

    # --- the layers' cross-rank arithmetic -----------------------------
    def batch_moments(self, xf: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global (mean, biased variance) per channel of float32 (or
        float64) ``xf``."""
        count = torch.full((1,), float(xf.numel() // xf.shape[1]), dtype=xf.dtype,
                           device=xf.device)
        sums = C.all_reduce_sum(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]),
                                self.group)
        ch = xf.shape[1]
        n = sums[-1]
        mean = sums[:ch] / n
        var = (sums[ch:2 * ch] / n - mean * mean).clamp_min(0.0)
        return mean, var

    def spatial_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 (float64) mean over (H, W) of a band, keepdim: the bands' sums
        all-reduced over the full level's H*W."""
        s = torch.sum(x, dim=(2, 3), keepdim=True,
                      dtype=torch.promote_types(x.dtype, torch.float32))
        return C.all_reduce_sum(s, self.group) / float(self.layout.rows(self.stride_of(x)) * x.shape[-1])

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """A band gathered into its full level on every rank (autograd)."""
        lo, _ = self.layout.band(self.stride_of(x))
        return C.gather_band(x, 2, lo, self.layout.rows(self.stride_of(x)), self.group)

    def _halo(self, x, kernel: int, stride: int, pad: float) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """The band with the rows a SAME ``kernel``/``stride`` window reads
        above and below it; the horizontal SAME pads."""
        from ..ops.resample import same_pads

        above, below = same_pads(self.layout.rows(self.stride_of(x)), kernel, stride)
        ext = C.halo_exchange(x, above, below, pad, self.group, self.rank, self.world)
        return ext, same_pads(x.shape[-1], kernel, stride)

    def conv2d(self, x, w, b, kernel: int, stride: int, groups: int, serial) -> torch.Tensor:
        """SAME conv of a band. ``serial(x)`` is the layer's own call, run on
        the gathered level when the output level is whole."""
        if not self.layout.banded(self.stride_of(x) * stride):
            return serial(self.whole(x))
        ext, pw = self._halo(x, kernel, stride, 0.0)
        if stride == 1 and kernel % 2 == 1:
            return F.conv2d(ext, w, b, 1, (0, kernel // 2), 1, groups)
        return F.conv2d(F.pad(ext, (pw[0], pw[1], 0, 0)), w, b, stride, 0, 1, groups)

    def maxpool(self, x, window: int, stride: int, serial) -> torch.Tensor:
        """SAME max-pool of a band: -inf pads only at the image's edges."""
        if not self.layout.banded(self.stride_of(x) * stride):
            return serial(self.whole(x))
        ext, pw = self._halo(x, window, stride, float("-inf"))
        if any(pw):
            ext = F.pad(ext, (pw[0], pw[1], 0, 0), value=float("-inf"))
        return F.max_pool2d(ext, window, stride)

    def upsample(self, x, out_w: int, serial) -> Optional[torch.Tensor]:
        """A whole level upsampled into a banded one: the full output, then
        this rank's rows; None when the serial call already does the right
        thing (both banded and nested, or both whole)."""
        out_stride = self.layout.size // out_w
        if self.banded(x) or not self.layout.banded(out_stride):
            return None
        lo, hi = self.layout.band(out_stride)
        return serial(x, self.layout.rows(out_stride), out_w)[:, :, lo:hi]


def active_context() -> Optional[ParallelContext]:
    """The innermost :func:`parallel_context`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def parallel_context(ctx: Optional[ParallelContext]) -> Iterator[Optional[ParallelContext]]:
    """Run the model's layers under ``ctx`` (None: serially)."""
    if ctx is None:
        yield None
        return
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.remove(ctx)
