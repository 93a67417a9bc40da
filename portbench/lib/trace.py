"""A profiler trace of a short steady stretch, and what the per-layer
metrics read from it.

The stage arithmetic is a copy of the port's ``tools/analyze_trace.py``:
a device event (kernel, copy, fill) finds its launch on the host by its
``correlation`` id; the innermost range around that launch whose name opens
a stage (the ranges ``utils.profiling.stage`` opens: ``preprocess``,
``backbone``, ``bifpn``, ``heads/...``, ``postprocess/...``, ``loss/...``,
``optimizer/...``) gives its stage; a kernel launched by autograd's thread
takes the stage of the forward op whose sequence number its
``evaluate_function`` carries, marked backward; the port's own kernels
fall back on their names. Busy time is the union of the device events'
intervals. Nothing here counts FLOPs from the trace: the MFU divides the
model's own count (``flops.py``).
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Tuple

STAGES = ("preprocess", "backbone", "bifpn", "heads", "postprocess", "loss", "optimizer")
OTHER = "other"
BACKWARD = " backward"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op") + LAUNCH_CATS
EVALUATE = "autograd::engine::evaluate_function"
KERNEL_STAGES = (("heads", r"head_pw"), ("postprocess", r"nms_suppress"), ("backbone", r"mbconv_"))
EPS_US = 1e-3


def stage_of_range(name: str) -> Optional[str]:
    head = name.split("/", 1)[0]
    return head if head in STAGES else None


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


class Tracer:
    """``start()`` ... ``stop()`` around a stretch; ``stop`` returns the
    stretch's :class:`Trace`. The Chrome trace goes through a file in
    ``TMPDIR``, which is deleted once read."""

    def __init__(self, bench):
        from torch.profiler import ProfilerActivity, profile

        self._bench = bench
        cuda = [] if bench.device == "cpu" else [ProfilerActivity.CUDA]
        self._prof = profile(activities=[ProfilerActivity.CPU] + cuda)
        self._t0 = None

    def start(self) -> None:
        self._bench.sync()
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, calls: int) -> "Trace":
        self._bench.sync()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                data = json.load(f)
        finally:
            os.remove(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return Trace(events, calls, window_s)


class _Host:
    """The host events nested thread by thread, each with its stage."""

    def __init__(self, events: List[dict]):
        threads = collections.defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS:
                threads[(e["pid"], e["tid"])].append(e)
        self.threads = threads
        self.parent: Dict[int, Optional[dict]] = {}
        self.ann: Dict[int, Optional[str]] = {}
        self.eval: Dict[int, Optional[dict]] = {}
        self.forward: Dict[Tuple[int, int], Optional[str]] = {}
        self._starts: Dict[tuple, List[float]] = {}
        for evs in threads.values():
            evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
            stack: List[dict] = []
            for e in evs:
                end = e["ts"] + e.get("dur", 0)
                while stack and end > stack[-1]["ts"] + stack[-1].get("dur", 0) + EPS_US:
                    stack.pop()
                p = stack[-1] if stack else None
                k = id(e)
                self.parent[k] = p
                st = stage_of_range(e["name"]) if e["cat"] == "user_annotation" else None
                self.ann[k] = st or (self.ann[id(p)] if p else None)
                is_eval = e["cat"] == "cpu_op" and e["name"].startswith(EVALUATE)
                self.eval[k] = e if is_eval else (self.eval[id(p)] if p else None)
                seq = e.get("args", {}).get("Sequence number")
                if e["cat"] == "cpu_op" and seq is not None and self.eval[k] is None:
                    # the last op to carry a sequence number made the node backward names
                    self.forward[(e["pid"], seq)] = self.ann[k]
                stack.append(e)

    def stage(self, e: dict) -> Tuple[Optional[str], bool]:
        ev = self.eval[id(e)]
        if ev is None:
            return self.ann[id(e)], False
        while ev is not None:
            key = (ev["pid"], ev.get("args", {}).get("Sequence number"))
            if key in self.forward:
                return self.forward[key], True
            p = self.parent[id(ev)]
            ev = self.eval[id(p)] if p else None
        return self.ann[id(e)], True

    def activity_at(self, tid_key, ts: float) -> str:
        """The innermost host op, range or runtime call running at ``ts`` on
        a thread: the latest-starting event at or before ``ts``, else the
        first of its parents that still runs."""
        evs = self.threads.get(tid_key, [])
        if tid_key not in self._starts:
            self._starts[tid_key] = [e["ts"] for e in evs]
        i = bisect.bisect_right(self._starts[tid_key], ts) - 1
        e = evs[i] if i >= 0 else None
        while e is not None and e["ts"] + e.get("dur", 0) < ts:
            e = self.parent[id(e)]
        return e["name"] if e is not None else "host between ops"


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """The numbers of one traced stretch of ``calls`` calls or steps."""

    def __init__(self, events: List[dict], calls: int, window_s: float):
        self.calls = max(calls, 1)
        self.window_s = window_s
        host = _Host(events)
        device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        launches = {e["args"]["correlation"]: e for evs in host.threads.values() for e in evs
                    if e["cat"] in LAUNCH_CATS and "correlation" in e.get("args", {})}
        stage_us = collections.Counter()
        kernel_us = collections.Counter()
        spans, after = [], []
        for d in device:
            launch = launches.get(d.get("args", {}).get("correlation"))
            st, bwd = host.stage(launch) if launch is not None else (None, False)
            if st is None:
                st = next((s for s, pat in KERNEL_STAGES if re.search(pat, d["name"])), OTHER)
            dur = d.get("dur", 0.0)
            stage_us[st + (BACKWARD if bwd else "")] += dur
            kernel_us[short_name(d["name"])] += dur
            spans.append((d["ts"], d["ts"] + dur))
            after.append((d["ts"], launch))
        merged = _merge(spans)
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        self.device_events = len(device)
        self.stage_ms = {k: v / 1e3 / self.calls for k, v in stage_us.items()}
        self.kernel_s = dict(kernel_us)  # name -> device us over the stretch
        self.top_device_ops = [[name, us * 1e-6] for name, us in kernel_us.most_common(10)]
        # each idle gap between device events, named by what the thread that
        # launched the next device event was doing halfway through it
        after.sort(key=lambda x: x[0])
        starts = [t for t, _ in after]
        gaps = collections.Counter()
        for (_, b), (a2, _) in zip(merged, merged[1:]):
            nxt = after[bisect.bisect_left(starts, a2)][1]
            label = (host.activity_at((nxt["pid"], nxt["tid"]), (b + a2) / 2)
                     if nxt is not None else "no launch found")
            gaps[label] += (a2 - b) * 1e-6
        self.idle_gaps = [[name, s] for name, s in gaps.most_common(10)]

    def kernel_ms_per_call(self, pattern: str) -> Optional[float]:
        """Device ms a call of the kernels whose names match ``pattern``,
        None if none ran."""
        us = [v for k, v in self.kernel_s.items() if re.search(pattern, k)]
        return sum(us) / 1e3 / self.calls if us else None

    def stage_ms_per_call(self, *rows: str) -> Optional[float]:
        got = [self.stage_ms[r] for r in rows if r in self.stage_ms]
        return sum(got) if got else None
