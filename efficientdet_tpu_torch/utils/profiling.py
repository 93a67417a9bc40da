"""Tracing and profiling helpers, counterpart of the JAX package's ``utils/profiling.py``.

* :func:`trace`: a context manager around ``torch.profiler`` (the CPU, and
  CUDA when a card is present) that writes a Chrome trace into ``log_dir``,
  viewable in Perfetto or ``chrome://tracing``.
* :class:`StepTimer`: a wall-clock items/s meter per device, fenced on the
  step's output (``torch.cuda.synchronize`` of its device).
* :func:`flops_estimate`: the FLOPs of one call by
  ``torch.utils.flop_counter.FlopCounterMode``, for MFU accounting.
* :func:`start_server`: the JAX package starts a live profiler server here;
  torch has none, so it raises and names :func:`trace`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its Chrome trace into ``log_dir``:
    ``with trace("traces"): step()``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def start_server(port: int = 9999):
    """The JAX package's live profiler server has no torch counterpart."""
    raise NotImplementedError(
        f"torch has no live profiler server (port {port}); capture a window "
        "with efficientdet_tpu_torch.utils.profiling.trace(log_dir) instead"
    )


def _world_size() -> int:
    """The devices one step spans: 1 until the step is data parallel."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _fence(output) -> None:
    """Wait for the device work that produced ``output`` (the last tensor
    leaf of a nested tuple, list or dict)."""
    leaves = [t for t in torch.utils._pytree.tree_leaves(output) if isinstance(t, torch.Tensor)]
    if leaves and leaves[-1].device.type == "cuda":
        torch.cuda.synchronize(leaves[-1].device)


class StepTimer:
    """Throughput meter: ``tick()`` per step, ``rate()`` -> items/s per device.

    The clock starts at the ``warmup``-th tick, so the first ``warmup``
    steps (kernel builds, graph captures) are left out.
    """

    def __init__(self, items_per_step: int, warmup: int = 2):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self._count = 0
        self._t0: Optional[float] = None

    def tick(self, fence_output=None) -> None:
        if fence_output is not None:
            _fence(fence_output)
        self._count += 1
        if self._count == self.warmup:
            self._t0 = time.perf_counter()

    def rate(self) -> float:
        if self._t0 is None or self._count <= self.warmup:
            return 0.0
        steps = self._count - self.warmup
        dt = time.perf_counter() - self._t0
        return steps * self.items_per_step / dt / _world_size()


def flops_estimate(fn: Callable, *args) -> Optional[float]:
    """Total FLOPs of one call of ``fn(*args)``, or None when it fails.

    ``FlopCounterMode`` counts matrix products and convolutions only (2 a
    multiply-add), where the JAX package's XLA cost analysis counts every
    operation: elementwise passes, reductions and the NMS are left out.
    """
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:  # the JAX helper's contract: an estimate or None
        return None
