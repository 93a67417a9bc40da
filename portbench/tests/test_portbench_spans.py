"""The readers of the port's own spans (``lib/spans.py``) on a CPU rehearsal
of ``d0-train``: None without a trace, None for stream ms on the CPU (no
CUDA events), and the traced stretch's host ms a step where a span was
recorded; None from a port that has no recorder."""

from __future__ import annotations

import time

import pytest

from portbench.lib.bench import Bench
from portbench.lib.spans import span_ms

READERS = {"targets_ms.train": "loss.targets", "focal_ms.train": "loss.focal",
           "huber_ms.train": "loss.huber"}
LEVELS = 5


def _run(tiny, trace: int):
    cell, args = tiny("d0-train", trace=trace)
    bench = Bench(cell, args.seed, args.seconds, bool(trace), time.perf_counter(), "cpu")
    cell.traffic().run(bench)
    return cell, bench


def test_the_span_readers_read_the_traced_stretch(tiny, monkeypatch):
    from efficientdet_tpu_torch.utils import profiling

    profiling.clear()
    cell, bench = _run(tiny, 0)
    assert profiling.summary() == {}  # an untraced run records nothing
    assert all(cell.reader(m).read(bench) is None for m in READERS)
    cell, bench = _run(tiny, 1)
    try:
        rows = profiling.summary()
        steps = bench.trace.calls
        assert rows["step"]["count"] == steps
        assert rows["loss.targets"]["count"] == steps
        assert rows["loss.focal"]["count"] == rows["loss.huber"]["count"] == 2 * LEVELS * steps
        for metric, name in READERS.items():
            assert cell.reader(metric).read(bench) is None  # no stream time on the CPU
            host = span_ms(bench, name, "host_ms")
            assert host == pytest.approx(rows[name]["host_ms"] / steps) and host > 0
        monkeypatch.delattr(profiling, "summary")  # a port without the recorder
        assert all(cell.reader(m).read(bench) is None for m in READERS)
    finally:
        profiling.clear()
