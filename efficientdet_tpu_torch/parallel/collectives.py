"""The port's collectives: what XLA's GSPMD writes for the JAX package.

Every collective here is built on ``torch.distributed.all_reduce`` (SUM) and
``broadcast`` alone, the two that gloo runs on CUDA tensors as well as NCCL
does, so one code path serves NCCL on the cards, gloo on the CPU and gloo
with CUDA tensors (two ranks on one card). A gather is an all-reduce of a
zeroed buffer in which each rank fills its own slot: each element has one
writer, so the sum adds zeros and is exact, in any dtype. bf16 and fp16
travel as float32 (exact), bool as uint8. With ``group=None`` (a world of one
process and no process group) every collective is the identity.

- :func:`all_reduce_sum`: an autograd all-reduce; its backward all-reduces
  the incoming gradient (SUM).
- :func:`all_reduce_grads`: the gradients' SUM, flattened into buckets;
  :func:`sum_over_ranks` the same for any tensors, without autograd.
- :func:`gather_rows`: concatenation of every rank's rows along a dim,
  uneven and empty shares included; :func:`gather_band` the same with
  autograd (its backward all-reduces and keeps the rank's rows).
- :func:`halo_exchange`: a height band with ``above`` rows of the rank
  before and ``below`` rows of the rank after, and ``pad`` at the image's
  real edges; its backward sends the halo rows' gradients back to their
  owners.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 << 20

_WIRE = {torch.bfloat16: torch.float32, torch.float16: torch.float32, torch.bool: torch.uint8}


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


@torch.no_grad()
def sum_over_ranks(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """SUM-all-reduce ``tensors`` in one flat buffer per wire dtype; returns
    them summed (new tensors), in their own dtypes and shapes."""
    if group is None:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((_WIRE.get(t.dtype, t.dtype), t.device), []).append(i)
    for (wire, device), idx in by_dtype.items():
        flat = torch.cat([tensors[i].reshape(-1).to(wire) for i in idx])
        _all_reduce_(flat, group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape).to(tensors[i].dtype)
            off += n
    return out


def broadcast_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s (one flat buffer per
    dtype)."""
    if group is None:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault((_WIRE.get(t.dtype, t.dtype), t.device), []).append(t)
    for (wire, _), ts in by_dtype.items():
        flat = torch.cat([t.detach().reshape(-1).to(wire) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        off = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` summed, on every rank, differentiably."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_grads(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The SUM over ranks of each gradient, all-reduced as flat buckets of at
    most ``BUCKET_BYTES`` (a larger tensor is a bucket of its own)."""
    grads = list(grads)
    if group is None:
        return grads
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    bucket: List[int] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if bucket:
            for i, t in zip(bucket, sum_over_ranks([grads[i] for i in bucket], group)):
                out[i] = t
        bucket, size = [], 0

    for i, g in enumerate(grads):
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or g.dtype != grads[bucket[0]].dtype):
            flush()
        bucket.append(i)
        size += nbytes
    flush()
    return out


def _placed(x: torch.Tensor, dim: int, lo: int, total: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = total
    full = x.new_zeros(shape)
    full.narrow(dim, lo, x.shape[dim]).copy_(x)
    return full


@torch.no_grad()
def gather_rows(tensors: Sequence[torch.Tensor], dim,
                bounds: Sequence[Tuple[int, int, int]], group) -> List[torch.Tensor]:
    """Each tensor's global form: ``bounds[i] = (lo, hi, total)`` are this
    rank's rows of tensor i along ``dim`` (an int, or one per tensor) and
    the global size; every rank's rows are concatenated in rank order (one
    all-reduce per wire dtype)."""
    if group is None:
        return list(tensors)
    dims = [dim] * len(tensors) if isinstance(dim, int) else list(dim)
    full = [_placed(t, d, lo, total) for t, d, (lo, _, total) in zip(tensors, dims, bounds)]
    return sum_over_ranks(full, group)


class _GatherBand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, lo, total, group):
        ctx.dim, ctx.lo, ctx.n, ctx.group = dim, lo, x.shape[dim], group
        return gather_rows([x], dim, [(lo, lo + x.shape[dim], total)], group)[0]

    @staticmethod
    def backward(ctx, g):
        g = sum_over_ranks([g.contiguous()], ctx.group)[0]
        return g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None, None, None


def gather_band(x: torch.Tensor, dim: int, lo: int, total: int, group) -> torch.Tensor:
    """Differentiable :func:`gather_rows` of one tensor: this rank's rows
    ``[lo, lo + x.shape[dim])`` of ``total``."""
    if group is None:
        return x
    return _GatherBand.apply(x, dim, lo, total, group)


def _slots(x: torch.Tensor, rows: int, world: int) -> torch.Tensor:
    return x.new_zeros((world,) + x.shape[:2] + (rows,) + x.shape[3:])


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, pad, group, rank, world):
        ctx.meta = (above, below, group, rank, world)
        h = x.shape[2]
        if h < max(above, below):
            raise ValueError(f"a band of {h} rows cannot lend a halo of {max(above, below)}")
        send = []
        if above:  # my last rows are the next rank's halo above it
            s = _slots(x, above, world)
            s[rank] = x[:, :, h - above:]
            send.append(s)
        if below:  # my first rows are the previous rank's halo below it
            s = _slots(x, below, world)
            s[rank] = x[:, :, :below]
            send.append(s)
        got = sum_over_ranks(send, group) if group is not None else send
        parts = []
        if above:
            top = got[0][rank - 1] if rank > 0 else torch.full_like(got[0][0], pad)
            parts.append(top)
        parts.append(x)
        if below:
            bot = got[-1][rank + 1] if rank < world - 1 else torch.full_like(got[-1][0], pad)
            parts.append(bot)
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        above, below, group, rank, world = ctx.meta
        h = g.shape[2] - above - below
        gx = g[:, :, above:above + h].clone()
        send = []
        if above:  # the gradient of my halo above belongs to the previous rank
            s = _slots(g, above, world)
            if rank > 0:
                s[rank - 1] = g[:, :, :above]
            send.append(s)
        if below:
            s = _slots(g, below, world)
            if rank < world - 1:
                s[rank + 1] = g[:, :, above + h:]
            send.append(s)
        got = sum_over_ranks(send, group) if group is not None else send
        if above:
            gx[:, :, h - above:] += got[0][rank]
        if below:
            gx[:, :, :below] += got[-1][rank]
        return gx, None, None, None, None, None, None


def halo_exchange(x: torch.Tensor, above: int, below: int, pad: float, group, rank: int,
                  world: int) -> torch.Tensor:
    """(B, C, h, W) band -> (B, C, above + h + below, W): the previous rank's
    last ``above`` rows on top, the next rank's first ``below`` rows under
    it, rows of ``pad`` where the band meets the image's edge."""
    if above == 0 and below == 0:
        return x
    return _Halo.apply(x, above, below, pad, group, rank, world)
