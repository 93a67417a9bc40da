"""Recompute a module in the backward pass instead of keeping its activations.

The port's ``nn.remat``: ``remat(module, *args)`` is ``module(*args)`` under
``torch.utils.checkpoint``. flax's remat is functional; torch's checkpoint
runs ``forward`` a second time during the backward pass, side effects and
all. So the recompute runs with every BatchNorm's ``update_stats`` off: the
running statistics move once a step, as without remat. Nothing random may be
drawn inside ``module``: the caller draws (stochastic depth's keep masks) and
passes the draws in ``args``, so the recompute sees the same ones.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from .normalization import TpuBatchNorm


@contextlib.contextmanager
def _stats_frozen(module: torch.nn.Module):
    bns = [m for m in module.modules() if isinstance(m, TpuBatchNorm)]
    saved = [bn.update_stats for bn in bns]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn, s in zip(bns, saved):
            bn.update_stats = s


def remat(module: torch.nn.Module, *args):
    """``module(*args)``, recomputed in the backward pass when grad is on."""
    if not torch.is_grad_enabled():
        return module(*args)
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return module(*a)
        with _stats_frozen(module):
            return module(*a)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
