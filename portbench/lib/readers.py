"""What the per-layer metric readers share: each reads the traced stretch
(``lib/trace.py``) and what the traffic module left in ``bench.extra``, and returns
None where there is nothing to read."""

from __future__ import annotations

import statistics
from typing import Optional

from .peaks import PEAK_FLOPS


def stage_ms(bench, *stages: str) -> Optional[float]:
    """Device ms a call or step in the stages' ranges, forward and backward."""
    if bench.trace is None or not bench.trace.device_events:
        return None
    return bench.trace.stage_ms_per_call(*stages, *(s + " backward" for s in stages))


def roofline_pct(bench, pattern: str, bound_key: str) -> Optional[float]:
    """The least time of a call's launches of the kernels matching
    ``pattern`` (``bench.extra[bound_key]``: seconds, and what bounds it) over
    their device time, in %."""
    if bench.trace is None or bound_key not in bench.extra:
        return None
    ms = bench.trace.kernel_ms_per_call(pattern)
    if not ms:
        return None
    bound, by = bench.extra[bound_key]
    bench.log(f"{pattern} bound {bound * 1e3:.6f} ms by {by}, device {ms:.6f} ms a call")
    return 100.0 * bound * 1e3 / ms


def mfu_pct(bench) -> Optional[float]:
    """The model's FLOPs of the traced calls (``lib/flops.py``) over the
    stretch's time, against the peak of the cell's precision, in %."""
    t = bench.trace
    if t is None or not t.device_events or "flops_per_call" not in bench.extra:
        return None
    rate = bench.extra["flops_per_call"] * t.calls / t.window_s
    return 100.0 * rate / PEAK_FLOPS[bench.extra["precision"]]


def idle_pct(bench) -> Optional[float]:
    """The share of the stretch in which no kernel, copy or fill ran."""
    t = bench.trace
    if t is None or not t.device_events:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)


def median(values) -> Optional[float]:
    return statistics.median(values) if values else None
