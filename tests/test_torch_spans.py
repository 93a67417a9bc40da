"""The port's span recorder (utils/profiling.py) on the CPU: what a training
step and a prediction record, what recording costs when it is off (no range
opened), that it changes no loss, gradient or detection, and that it holds
across threads.

A training step of the slim D0 (tests/torch_stage_ranks.py: 128 px, five
levels, the per-level loss) records, inside ``record_spans()``: ``step``;
its stages; ``backward``; one ``loss.targets``; and per level one forward
and one backward span each of ``loss.focal`` and ``loss.huber``.
"""

import collections
import contextlib
import json
import os
import sys
import threading

import pytest
import torch

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch import train_lib
from efficientdet_tpu_torch.ops.preprocess import preprocess_batch_fixed
from efficientdet_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(__file__))
import torch_stage_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = 5
TRAIN_STAGES = ("preprocess", "backbone", "bifpn", "heads", "optimizer")
TC = dict(batch_size=2, max_gt_boxes=4)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def batch():
    return ranks.slim_batch(2)


def _step(model, batch, **config):
    """One training step of ``model`` on ``batch``: (metrics, params after)."""
    tc = et.TrainConfig(**TC, **config)
    step = et.make_train_step(model, tc, device="cpu")
    state = et.create_train_state(model, tc, device="cpu")
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    return metrics, {k: v.detach().clone() for k, v in state.params.items()}


def _by_id(spans):
    return {s.id: s for s in spans}


# ---------------------------------------------------------------- off

def test_a_step_records_nothing_and_opens_no_range_when_off(batch, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _step(ranks.slim_model(), batch)
    assert opened == []
    assert profiling.RECORDER.spans() == [] and profiling.summary() == {}
    assert isinstance(profiling.stage("loss"), contextlib.nullcontext)
    assert isinstance(profiling.span("loss.focal"), contextlib.nullcontext)
    with profiling.record_spans():
        _step(ranks.slim_model(), batch)
    assert "step" in opened and "loss.cls_term" in opened  # the same wrapper sees them when on


def test_stages_off_records_nothing(batch):
    with profiling.record_spans(), profiling.stages_off():
        assert isinstance(profiling.stage("heads"), contextlib.nullcontext)
        assert isinstance(profiling.span("step"), contextlib.nullcontext)
        _step(ranks.slim_model(), batch)
    assert profiling.RECORDER.spans() == []


def test_names_are_checked():
    with pytest.raises(ValueError):
        profiling.stage("loss.focal")
    with pytest.raises(ValueError):
        profiling.span("loss")
    with pytest.raises(ValueError):
        profiling.backward_span("huber", torch.zeros(1), torch.zeros(1))


# ---------------------------------------------------------------- what a step records

def test_a_per_level_step_records_its_tree(batch):
    with profiling.record_spans():
        _step(ranks.slim_model(), batch)
    spans = profiling.RECORDER.spans()
    ids = _by_id(spans)
    names = collections.Counter(s.name for s in spans)
    depth = ranks.SLIM["bifpn_depth"]
    # a BiFPN layer fuses 2 * LEVELS - 2 nodes, each with one resample; the
    # first layer also pools P6 and P7
    assert names == collections.Counter(
        {"step": 1, "backward": 1, "loss": 2, "loss.targets": 1, "loss.focal": 2 * LEVELS,
         "loss.huber": 2 * LEVELS, "bifpn.fuse": depth * (2 * LEVELS - 2),
         "bifpn.resample": depth * (2 * LEVELS - 2) + 2, **{st: 1 for st in TRAIN_STAGES}})
    assert len({s.call for s in spans}) == 1
    parent = {s.id: (ids[s.parent.id].name if s.parent else None) for s in spans}
    for s in spans:
        if s.name == "step":
            assert parent[s.id] is None
        elif s.name in TRAIN_STAGES or s.name in ("loss", "backward"):
            assert parent[s.id] == "step", s.name
        elif s.name == "loss.targets":
            assert parent[s.id] == "loss"
        elif s.name.startswith("bifpn."):
            assert parent[s.id] == "bifpn", s.name
    for name in ("loss.focal", "loss.huber"):
        got = collections.Counter(parent[s.id] for s in spans if s.name == name)
        assert got == {"loss": LEVELS, "backward": LEVELS}, name
    backward = next(s for s in spans if s.name == "backward")
    for s in spans:
        if s.parent is backward:
            assert backward.t0 <= s.t0 <= s.t1 <= backward.t1
    rows = profiling.summary()
    assert rows["loss.focal"]["count"] == 2 * LEVELS
    assert all(r["stream_ms"] is None and r["timed"] == 0 for r in rows.values())  # no CUDA


def test_the_concatenated_loss_records_one_span_each_way(batch):
    with profiling.record_spans():
        _step(ranks.slim_model(), batch, per_level_loss=False)
    spans = profiling.RECORDER.spans()
    parent = {s.id: s.parent.name for s in spans if s.parent}
    for name in ("loss.focal", "loss.huber"):
        got = collections.Counter(parent[s.id] for s in spans if s.name == name)
        assert got == {"loss": 1, "backward": 1}, name


def test_self_times_never_exceed_the_durations(batch, tmp_path):
    with profiling.record_spans():
        for _ in range(2):
            _step(ranks.slim_model(), batch)
    spans = profiling.RECORDER.spans()
    assert len({s.call for s in spans}) == 2
    for s in spans:
        assert 0 <= s.self_host_ms <= s.host_ms, s.name
    for name, row in profiling.summary().items():
        assert 0 <= row["self_host_ms"] <= row["host_ms"], name
    step = profiling.summary()["step"]
    assert step["count"] == 2 and step["self_host_ms"] < step["host_ms"]
    path = tmp_path / "spans.jsonl"
    profiling.export(str(path))
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == len(spans)
    ids = {r["id"] for r in lines}
    assert all(r["parent"] is None or r["parent"] in ids for r in lines)
    assert {r["name"] for r in lines} == {s.name for s in spans}


def test_a_profiler_session_records_spans_and_a_prediction_is_a_call(tmp_path):
    model = ranks.slim_model().eval()
    images = torch.from_numpy(ranks.slim_batch(1)["images"])
    predict = et.make_predict_fn(model)
    predict(images)
    assert profiling.RECORDER.spans() == []
    with profiling.trace(str(tmp_path), name="p.json"):
        predict(images)
        predict(images)
    spans = profiling.RECORDER.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["predict", "predict"]
    assert len({s.call for s in spans}) == 2
    assert collections.Counter(s.name for s in spans if s.parent is roots[0]) == {
        "preprocess": 1, "backbone": 1, "bifpn": 1, "heads": 1, "postprocess": 1}


# ---------------------------------------------------------------- observe only

def test_the_loss_gradients_and_detections_are_unchanged_by_recording(batch):
    tc = et.TrainConfig(**TC)

    def loss_and_grads():
        model = ranks.slim_model()
        images = preprocess_batch_fixed(torch.from_numpy(batch["images"]), dtype=torch.float32)
        boxes, labels = (torch.from_numpy(batch[k]) for k in ("gt_boxes", "gt_labels"))
        total, aux, _ = train_lib._loss(model, tc, images, boxes, labels, None)
        grads = torch.autograd.grad(total, list(model.parameters()))
        return [total, aux["cls_loss"], aux["box_loss"], *grads]

    def detections():
        model = ranks.slim_model().eval()
        return list(et.make_predict_fn(model)(torch.from_numpy(ranks.slim_batch(2)["images"])))

    def everything():
        metrics, params = _step(ranks.slim_model(), batch)
        return loss_and_grads() + detections() + list(metrics.values()) + list(params.values())

    off = everything()
    with profiling.record_spans():
        on = everything()
    assert profiling.summary()["loss.huber"]["count"] == 4 * LEVELS  # hooks were in place
    assert len(on) == len(off)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------- names and threads

def test_no_span_range_opens_a_stage():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import analyze_trace as jax_tool
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    from portbench.lib import trace as bench_trace

    assert set(profiling.SPAN_RANGES) == set(profiling.SPANS)
    assert not set(profiling.SPANS) & set(profiling.STAGES)
    for name in filter(None, profiling.SPAN_RANGES.values()):
        assert profiling.stage_of_range(name) is None, name
        assert bench_trace.stage_of_range(name) is None, name
        assert jax_tool.classify(name, "", "") == "other", name


def test_the_recorder_holds_across_threads(monkeypatch):
    rec = profiling.SpanRecorder(max_spans=1000)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    workers, each = 3 * (os.cpu_count() or 2), 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with profiling.span("step"):
                    with profiling.stage("loss"):
                        pass

        with rec.recording():
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = rec.spans()
    assert len(spans) == 1000 and rec.dropped == 2 * workers * each - 1000
    for s in spans:
        if s.name == "loss":
            assert s.parent.name == "step" and s.parent.thread == s.thread
            assert s.call == s.parent.call
        else:
            assert s.parent is None
    steps = [s for s in spans if s.name == "step"]
    assert len({s.call for s in steps}) == len(steps)  # a call a root span
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0


class _FakeEvent:
    """A CUDA timing event's interface: ``record()`` stamps a count of the
    events recorded so far."""

    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock += 1.0
        self.t = _FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_stream_ms_comes_from_pooled_events(monkeypatch):
    rec = profiling.SpanRecorder(max_spans=100)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(profiling, "_current_stream", lambda: None)
    _FakeEvent.made = 0
    with rec.recording():
        for _ in range(40):
            with profiling.span("step"):
                with profiling.stage("loss"):
                    pass
        assert _FakeEvent.made == 2 * 80  # none read, none reused, before summary()
        capturing[0] = True
        with profiling.span("predict"):  # a graph capture records no event
            pass
        with profiling.span("backward"):
            capturing[0] = False  # nor a span inside which a capture ended
        with profiling.span("loss.huber"):
            capturing[0] = True  # nor one inside which a capture began
        capturing[0] = False
    rows = rec.summary()
    assert rows["loss"]["timed"] == rows["step"]["timed"] == 40
    assert rows["loss"]["stream_ms"] == 40 * 1.0 and rows["step"]["stream_ms"] == 40 * 3.0
    for name in ("predict", "backward", "loss.huber"):
        assert rows[name]["count"] == 1 and rows[name]["timed"] == 0, name
        assert rows[name]["stream_ms"] is None, name
    assert len(rec._free_events) == _FakeEvent.made  # every event read and back in the pool
    rec.clear()
    made = _FakeEvent.made
    with rec.recording():
        for _ in range(40):
            with profiling.span("step"):
                pass
    assert _FakeEvent.made == made and rec.summary()["step"]["stream_ms"] == 40.0  # the pool's

    small = profiling.SpanRecorder(max_spans=3)
    monkeypatch.setattr(profiling, "RECORDER", small)
    with small.recording():
        for _ in range(5):
            with profiling.span("step"):
                pass
    assert small.dropped == 2 and small.summary()["step"]["timed"] == 3
