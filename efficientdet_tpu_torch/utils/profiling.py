"""Tracing and profiling helpers, counterpart of the JAX package's ``utils/profiling.py``.

* :func:`trace`: a context manager around ``torch.profiler`` (the CPU, and
  CUDA when a card is present, with each op's input shapes) that writes a
  Chrome trace into ``log_dir``, viewable in Perfetto or
  ``chrome://tracing`` and read by ``tools/analyze_trace.py``.
* :func:`stage` and :func:`span`, the port's spans: ``stage(name)`` opens
  one of :data:`STAGES` (the port's counterpart of the names flax's module
  tree puts on every XLA op; the models, the prediction and the training
  step open them), ``span(name)`` one of the finer :data:`SPANS` (a
  training step or a prediction call as a whole, the backward pass, the
  loss's targets, focal and Huber terms, a BiFPN node's fusion and each
  resample between its levels), and :func:`backward_span` marks a
  stretch of a backward pass between two gradient hooks. Spans are recorded
  while a ``torch.profiler`` session records in the process, or inside
  :func:`record_spans`; then each is kept in memory (:class:`SpanRecorder`),
  and each with a range name opens a ``record_function`` range. Otherwise a span is a
  ``nullcontext`` and costs one check.
* :func:`summary` and :func:`export`: the kept spans, per name or one JSON
  line each; :func:`clear` forgets them.
* :func:`flops_estimate`: the FLOPs of one call by
  ``torch.utils.flop_counter.FlopCounterMode``, for MFU accounting.

A span's *stream ms* is read from two CUDA timing events that it records on
the current stream as it opens and closes: the device's work queued inside
the span, plus any time the device spent waiting for the host inside it.
The events come from a pool, and only :func:`summary` and :func:`export`
read them (and return them to the pool), so recording never waits for the
device; reading finished events as spans close would cost more host time
than making new ones. A span records no event while CUDA is not initialised
or while the current stream captures a CUDA graph.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

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

# The finer spans, each with its range name, or None for a span that opens
# no range. The BiFPN's spans open none: a D0 call opens 50 of them, their
# ranges would cost a traced call more host time than the device spends in
# them, and no reader of a trace needs them. No range name opens a stage:
# not by stage_of_range (nor portbench's copy of it), nor by the JAX tool's
# patterns, which would read "focal" or "huber" as its loss stage. So a
# trace's stage table is the same with these ranges as without them.
SPAN_RANGES = {"step": "step", "predict": "predict", "backward": "backward",
               "loss.targets": "loss.targets", "loss.focal": "loss.cls_term",
               "loss.huber": "loss.box_term", "bifpn.fuse": None,
               "bifpn.resample": None}
SPANS = tuple(SPAN_RANGES)

# the spans a recorder keeps; those that close past it are counted and dropped
MAX_SPANS = 1 << 15
# the autograd nodes backward_span() searches for the one that consumes its input
_SEARCH_NODES = 256


def stage_of_range(name: str) -> Optional[str]:
    """The stage a range's name opens, or None."""
    head = name.split("/", 1)[0]
    return head if head in STAGES else None

# off inside stages_off(), for its thread or task alone
_stages_on: contextvars.ContextVar = contextvars.ContextVar("stages_on", default=True)
_OFF = contextlib.nullcontext()


# a Stream object for each (stream id, device index, device type)
_STREAMS: Dict[tuple, Any] = {}


def _current_stream():
    """``torch.cuda.current_stream()``, its Stream object made once: making
    one for each event, as that function does, takes the host longer than
    recording the event."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


class _Span:
    """One span, kept by its recorder once it closes."""

    __slots__ = ("recorder", "name", "range", "parent", "call", "id", "thread", "t0", "t1",
                 "child_ns", "start_event", "end_event", "stream_ms", "pushed", "_rf")

    def __init__(self, recorder: "SpanRecorder", name: str, range_name: Optional[str]):
        self.recorder = recorder
        self.name = name
        self.range = range_name
        self.child_ns = 0
        self.start_event = self.end_event = self.stream_ms = self._rf = None

    def __enter__(self) -> "_Span":
        if self.range is not None:
            self._rf = torch.profiler.record_function(self.range)
            self._rf.__enter__()
        self.recorder.open(self)
        return self

    def __exit__(self, *exc) -> None:
        self.recorder.close(self)
        if self._rf is not None:
            self._rf.__exit__(*exc)

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def self_host_ms(self) -> float:
        return (self.t1 - self.t0 - self.child_ns) / 1e6


class SpanRecorder:
    """The spans that closed while recording was on, at most ``max_spans``
    (:attr:`dropped` counts those past it), each with its name, its parent,
    the call it belongs to (a new one at every span opened outside all
    others: ``step``, ``predict``), its host start and end
    (``perf_counter_ns``) and, on a CUDA device, its pair of timing events.

    Safe across threads: each thread nests its own spans, and a span that
    opens on a thread with none open (the autograd engine runs a backward
    pass on its own device threads) takes the newest open ``backward`` span
    as its parent. The port records into the one :data:`RECORDER`.
    """

    def __init__(self, max_spans: int = MAX_SPANS):
        self.max_spans = max_spans
        self.dropped = 0
        self.explicit = 0  # open record_spans() blocks
        self._kept: List[_Span] = []
        self._backward: List[_Span] = []  # open backward spans, newest last
        self._free_events: List[Any] = []
        self._lock = threading.Lock()
        self._read_lock = threading.Lock()  # one reader of the events at a time
        self._local = threading.local()
        self._ids = itertools.count()
        self._calls = itertools.count()

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self):
        """A timing event recorded on the current stream, or None where none
        is recorded (no CUDA, or a graph being captured)."""
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None
        stream = _current_stream()
        with self._lock:
            ev = self._free_events.pop() if self._free_events else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _release(self, *events) -> None:
        events = [e for e in events if e is not None]
        if events:
            with self._lock:
                self._free_events.extend(events)

    def open(self, span: _Span, push: bool = True) -> None:
        stack = self._stack()
        if stack:
            parent = stack[-1]
        else:
            with self._lock:
                parent = self._backward[-1] if self._backward else None
        span.parent = parent
        span.call = parent.call if parent is not None else next(self._calls)
        span.id = next(self._ids)
        span.thread = threading.get_ident()
        span.pushed = push
        if push:
            stack.append(span)
        if span.name == "backward":
            with self._lock:
                self._backward.append(span)
        span.start_event = self._event()
        span.t0 = time.perf_counter_ns()

    def close(self, span: _Span) -> None:
        span.t1 = time.perf_counter_ns()
        if span.start_event is not None:
            span.end_event = self._event()
            if span.end_event is None:  # a capture began inside the span
                self._release(span.start_event)
                span.start_event = None
        if span.pushed:
            stack = self._stack()
            if stack and stack[-1] is span:
                stack.pop()
            elif span in stack:
                stack.remove(span)
        with self._lock:
            if span.name == "backward" and span in self._backward:
                self._backward.remove(span)
            if span.parent is not None:
                span.parent.child_ns += span.t1 - span.t0
            kept = len(self._kept) < self.max_spans
            if kept:
                self._kept.append(span)
            else:
                self.dropped += 1
        if not kept:
            self._release(span.start_event, span.end_event)

    def _read(self, span: _Span) -> None:
        """The span's stream ms from its two events, which go back to the pool."""
        try:
            span.stream_ms = span.start_event.elapsed_time(span.end_event)
        except RuntimeError:  # the two events were recorded on two devices
            span.stream_ms = None
        self._release(span.start_event, span.end_event)
        span.start_event = span.end_event = None

    @contextlib.contextmanager
    def recording(self):
        """Record spans inside the block, whether or not a profiler runs."""
        with self._lock:
            self.explicit += 1
        try:
            yield self
        finally:
            with self._lock:
                self.explicit -= 1

    def spans(self) -> List[_Span]:
        """The kept spans in the order they closed, their events read (this
        waits for the device to reach each span's end)."""
        with self._read_lock:
            with self._lock:
                spans = list(self._kept)
            for s in spans:
                if s.end_event is not None:
                    s.end_event.synchronize()
                    self._read(s)
        return spans

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """Per span name: ``count``, ``host_ms``, ``self_host_ms`` (each
        span's duration less its children's), ``stream_ms`` (None where no
        span of the name recorded events) and ``timed`` (the spans that did),
        summed over the kept spans."""
        rows: Dict[str, Dict[str, Any]] = {}
        for s in self.spans():
            row = rows.setdefault(s.name, {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                           "stream_ms": None, "timed": 0})
            row["count"] += 1
            row["host_ms"] += s.host_ms
            row["self_host_ms"] += s.self_host_ms
            if s.stream_ms is not None:
                row["stream_ms"] = (row["stream_ms"] or 0.0) + s.stream_ms
                row["timed"] += 1
        return rows

    def export(self, path: str) -> None:
        """One JSON line a kept span: ``name``, ``id``, ``parent`` (its id),
        ``call``, ``thread``, ``start_ns``, ``host_ms``, ``self_host_ms``,
        ``stream_ms``."""
        with open(path, "w") as f:
            for s in self.spans():
                f.write(json.dumps({
                    "name": s.name, "id": s.id, "parent": None if s.parent is None else s.parent.id,
                    "call": s.call, "thread": s.thread, "start_ns": s.t0, "host_ms": s.host_ms,
                    "self_host_ms": s.self_host_ms, "stream_ms": s.stream_ms}) + "\n")

    def clear(self) -> None:
        """Forget the kept spans and the count of those dropped."""
        with self._read_lock:
            with self._lock:
                kept, self._kept, self.dropped = self._kept, [], 0
            for s in kept:
                self._release(s.start_event, s.end_event)


RECORDER = SpanRecorder()


def _recording() -> bool:
    return bool(RECORDER.explicit or _autograd_profiler._is_profiler_enabled) and _stages_on.get()


def stage(name: str):
    """``with stage("backbone"): ...``: the block's ops, and the kernels they
    launch, belong to stage ``name`` in a profile: while spans are recorded
    it opens the stage's ``record_function`` range (:data:`RANGE_NAMES`) and
    keeps a span named ``name``. Otherwise, and always inside
    :func:`stages_off`, it is a ``nullcontext``."""
    if name not in RANGE_NAMES:
        raise ValueError(f"unknown stage {name!r}; one of {STAGES}")
    if not _recording():
        return _OFF
    return _Span(RECORDER, name, RANGE_NAMES[name])


def span(name: str):
    """:func:`stage` for one of :data:`SPANS` (range names
    :data:`SPAN_RANGES`)."""
    if name not in SPAN_RANGES:
        raise ValueError(f"unknown span {name!r}; one of {SPANS}")
    if not _recording():
        return _OFF
    return _Span(RECORDER, name, SPAN_RANGES[name])


def _consumer(root, inp: torch.Tensor):
    """The one node of the graph under ``root`` that takes ``inp``'s
    gradient from it, or None (none, several, or past the search's size)."""
    target = inp.grad_fn
    found, seen, todo = [], set(), [root]
    while todo and len(seen) < _SEARCH_NODES:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            # a tensor made by an op, or a leaf through its AccumulateGrad node
            takes = nxt is target if target is not None else getattr(nxt, "variable", None) is inp
            if takes:
                found.append(node)
            else:
                todo.append(nxt)
    return found[0] if len(found) == 1 and not todo else None


def backward_span(name: str, out: torch.Tensor, inp: torch.Tensor) -> None:
    """Record the backward pass from ``out``'s gradient down to ``inp``'s as
    a span ``name`` (one of :data:`SPANS`): it opens when autograd reaches
    the node that made ``out`` and closes once the node that consumes
    ``inp`` has run. Nothing is hooked while spans are not recorded, when
    either tensor takes no gradient, or when no single node under ``out``
    consumes ``inp``. The span opens no range: begun in one autograd node
    and ended in another, it would cross the engine's own ranges and change
    how a trace nests."""
    if name not in SPAN_RANGES:
        raise ValueError(f"unknown span {name!r}; one of {SPANS}")
    if not _recording() or not (out.requires_grad and inp.requires_grad):
        return
    node = _consumer(out.grad_fn, inp)
    if node is None:
        return
    opened: List[_Span] = []

    def start(grad):
        s = _Span(RECORDER, name, None)
        RECORDER.open(s, push=False)
        opened.append(s)

    def stop(grad_inputs, grad_outputs):
        if opened:
            RECORDER.close(opened.pop())

    out.register_hook(start)
    node.register_hook(stop)


def record_spans():
    """``with record_spans(): ...``: record spans inside the block, with no
    profiler running (process-wide, every thread)."""
    return RECORDER.recording()


def summary() -> Dict[str, Dict[str, Any]]:
    """:meth:`SpanRecorder.summary` of the kept spans."""
    return RECORDER.summary()


def export(path: str) -> None:
    """:meth:`SpanRecorder.export` of the kept spans into ``path``."""
    RECORDER.export(path)


def clear() -> None:
    """Forget the kept spans."""
    RECORDER.clear()


@contextlib.contextmanager
def stages_off():
    """Open no stage or span inside the block, and record none (``export.py``
    traces the pipeline under it, so that no torch version records a
    profiler op into the exported program). Holds for the calling thread (or
    asyncio task) alone."""
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
