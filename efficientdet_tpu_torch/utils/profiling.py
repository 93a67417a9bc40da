"""Tracing and profiling helpers, counterpart of the JAX package's ``utils/profiling.py``.

* :func:`trace`: a context manager around ``torch.profiler`` (the CPU, and
  CUDA when a card is present, with each op's input shapes) that writes a
  Chrome trace into ``log_dir``, viewable in Perfetto or
  ``chrome://tracing`` and read by ``tools/analyze_trace.py``.
* :func:`stage`: a ``record_function`` range for one of :data:`STAGES`,
  the port's counterpart of the names flax's module tree puts on every XLA
  op; the models, the prediction and the training step open them.
* :class:`StepTimer`: a wall-clock items/s meter per device, fenced on the
  step's output (``torch.cuda.synchronize`` of its device).
* :func:`flops_estimate`: the FLOPs of one call by
  ``torch.utils.flop_counter.FlopCounterMode``, for MFU accounting.
* :func:`start_server`: the JAX package starts a live profiler server here;
  torch has none, so it raises and names :func:`trace`.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import Callable, Optional

import torch

# The pipeline's stages, named as the JAX tool tools/analyze_trace.py names
# them (a device event outside all of them is "other"), each with its range
# name: the stage, then, where the JAX tool's patterns (STAGE_PATTERNS,
# matched against flax's module names) need them, the names that flax's
# name stack shows there, so that its classify() puts the range in the same
# stage.
RANGE_NAMES = {"preprocess": "preprocess", "backbone": "backbone", "bifpn": "bifpn",
               "heads": "heads/class_net+box_net", "postprocess": "postprocess/decode_boxes+nms",
               "loss": "loss/anchor_targets+focal+huber", "optimizer": "optimizer/adam"}
STAGES = tuple(RANGE_NAMES)


def stage_of_range(name: str) -> Optional[str]:
    """The stage a range's name opens, or None."""
    head = name.split("/", 1)[0]
    return head if head in STAGES else None

# off inside stages_off(), for its thread or task alone
_stages_on: contextvars.ContextVar = contextvars.ContextVar("stages_on", default=True)


def stage(name: str):
    """``with stage("backbone"): ...``: the block's ops, and the kernels they
    launch, belong to stage ``name`` in a profile. A ``record_function``
    range: it launches nothing, and costs a few microseconds of host time
    whether or not a profiler runs. Inside :func:`stages_off` it is a
    ``nullcontext``."""
    if name not in STAGES:
        raise ValueError(f"unknown stage {name!r}; one of {STAGES}")
    if not _stages_on.get():
        return contextlib.nullcontext()
    return torch.profiler.record_function(RANGE_NAMES[name])


@contextlib.contextmanager
def stages_off():
    """Open no stage range inside the block (``export.py`` traces the
    pipeline under it, so that no torch version records a profiler op into
    the exported program). Holds for the calling thread (or asyncio task)
    alone."""
    token = _stages_on.set(False)
    try:
        yield
    finally:
        _stages_on.reset(token)


@contextlib.contextmanager
def trace(log_dir: str, name: Optional[str] = None):
    """Profile the block and write its Chrome trace into ``log_dir`` (as
    ``name``, gzipped when it ends in ``.gz``; by default
    ``trace_<pid>_<ns>.json``): ``with trace("traces") as prof: ...``.
    ``prof.step()`` after each call puts the call in a ``ProfilerStep#N``
    range, which ``tools/analyze_trace.py`` counts as one call."""
    import warnings

    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with warnings.catch_warnings():  # "won't be using warmup": every step is recorded
        warnings.simplefilter("ignore", UserWarning)
        steps = schedule(wait=0, warmup=0, active=1 << 30)
    with profile(activities=activities, record_shapes=True, schedule=steps,
                 acc_events=True) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    name = name or f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


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
