"""What the per-layer metrics of the port's own spans read.

The port keeps, in memory, every span that opens while a ``torch.profiler``
session records in its process (``efficientdet_tpu_torch.utils.profiling``:
the loss's ``loss.targets``, ``loss.focal`` and ``loss.huber``, forward and
backward, and the stages). The traced stretch (``lib/trace.py``) is that
session, so once the traffic has run the port's ``summary()`` holds the
stretch's spans, and no file of the benchmark has to read them from the
trace. A span's stream ms is the time between two CUDA events it recorded on
the current stream: its device work, plus any time the device waited for the
host inside it. A port without the recorder, a run without a trace, or a
span with no stream time (the CPU) gives None.
"""

from __future__ import annotations

from typing import Optional


def span_ms(bench, name: str, field: str = "stream_ms") -> Optional[float]:
    """``field`` of the spans named ``name`` in the port's ``summary()``,
    summed, a call or step of the traced stretch."""
    if bench.trace is None:
        return None
    from efficientdet_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)
    if summary is None:
        return None
    value = summary().get(name, {}).get(field)
    return None if value is None else value / bench.trace.calls
