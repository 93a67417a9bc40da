"""The port's stage ranges (utils/profiling.stage) and its trace analyser
(efficientdet_tpu_torch/tools/analyze_trace.py), on the CPU.

A hand-built trace in torch.profiler's Chrome format, with known durations,
must give a known table; real CPU traces of the slim D0's prediction and
training step must put every op in its stage; the JAX tool's classify()
must put each range name in the same stage; the exported program must hold
no profiler op; and a sharded step on two gloo ranks must classify as the
one-process step does, its collectives in "other".
"""

import collections
import contextlib
import gzip
import json
import os
import sys

import numpy as np
import pytest
import torch

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.experiments.timing import HBM_BYTES_S, PEAK_BF16, PEAK_F32_CUDA_CORES
from efficientdet_tpu_torch.parallel.launch import spawn
from efficientdet_tpu_torch.tools import analyze_trace as at
from efficientdet_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(__file__))
import torch_stage_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = "tests/torch_stage_ranks.py"
INFERENCE_STAGES = ["preprocess", "backbone", "bifpn", "heads", "postprocess"]
OTHER_SHARE = 0.05


# ---------------------------------------------------------------- hand-built trace

def _op(name, ts, dur, tid=1, dims=(), types=(), concrete=None, seq=None, cat="cpu_op"):
    args = {"Input Dims": [list(d) for d in dims], "Input type": list(types)}
    if concrete is not None:
        args["Concrete Inputs"] = list(concrete)
    if seq is not None:
        args["Sequence number"] = seq
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _range(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": dur, "args": {}}


def _launch(corr, ts, tid=1, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": 3, "args": {"correlation": corr}}


def _kernel(corr, name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr, "device": 0, "stream": 7}}


CONV_CONCRETE = ["", "", "", "[1, 1]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1"]
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>(int, float)"


def synthetic_trace():
    """One profiled call (a ProfilerStep range) on the host's thread 1, a
    backward on autograd's thread 2, and the kernels they launched.

    preprocess: a div (corr 1, 5 us) and a copy's memcpy (corr 11, 2 us);
    backbone: one convolution, 2 kernels (corr 2, 3: 20 + 30 us), its
    cudnn op reading 64 MiB + 288 B; bifpn: an add (corr 4, 8 us) that is
    forward op sequence 8; heads, inside a range that is no stage: a bf16
    mm (corr 5, 12 us); postprocess: the NMS op (corr 6, 6 us), and inside
    it a heads range with a mul (corr 7, 4 us: the innermost range wins);
    outside every range: a head kernel (corr 8, 10 us, heads by its name)
    and an elementwise kernel (corr 9, 3 us, other); on autograd's thread the
    add's backward (sequence 8: bifpn backward; a mul, corr 10, 7 us)."""
    host = [
        _range("ProfilerStep#0", 0, 1000),
        _range("preprocess", 10, 50),
        _op("aten::div", 20, 7, dims=[(2, 4)], types=["float"]),
        _launch(1, 22),
        _op("aten::copy_", 28, 12, dims=[(2, 4), (2, 4)], types=["float", "float"]),
        _launch(11, 30, name="cudaMemcpyAsync"),
        _range("backbone", 100, 300),
        _op("aten::convolution", 110, 190, dims=[(1, 2, 8, 8), (4, 2, 3, 3), ()],
            types=["float", "float", ""], concrete=CONV_CONCRETE, seq=7),
        _op("aten::cudnn_convolution", 120, 170, dims=[(1, 1024, 128, 128), (4, 2, 3, 3)],
            types=["float", "float"]),
        _launch(2, 130),
        _launch(3, 140),
        _range("bifpn", 400, 200),
        _op("aten::add", 410, 40, dims=[(4,), (4,)], types=["float", "float"], seq=8),
        _launch(4, 420),
        _range("my_range", 600, 200),
        _range("heads/class_net+box_net", 610, 180),
        _op("aten::mm", 620, 80, dims=[(4096, 1024), (1024, 4096)],
            types=["c10::BFloat16", "c10::BFloat16"]),
        _launch(5, 630),
        _range("postprocess/decode_boxes+nms", 800, 190),
        _range("heads/class_net+box_net", 810, 40),
        _op("aten::mul", 815, 25, dims=[(4,)], types=["float"]),
        _launch(7, 820),
        _op("efficientdet_tpu_torch::nms_keep_mask", 860, 40, dims=[(1000000, 100)],
            types=["float"]),
        _launch(6, 870),
        _launch(8, 1100),
        _launch(9, 1110),
        _op("autograd::engine::evaluate_function: AddBackward0", 1200, 100, tid=2, seq=8),
        _op("aten::mul", 1205, 45, tid=2, dims=[(4,), (4,)], types=["float", "float"]),
        _launch(10, 1210, tid=2),
        # the range the profiler opens after the last step(): the closing synchronize
        _range("ProfilerStep#1", 1500, 5),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "pid": 1, "tid": 1,
         "ts": 1501, "dur": 2, "args": {}},
    ]
    device = [
        _kernel(1, ELEMENTWISE, 2000, 5),
        _kernel(11, "Memcpy HtoD (Pageable -> Device)", 2005, 2, cat="gpu_memcpy"),
        _kernel(2, "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw", 2010, 20),
        _kernel(3, "void at::native::reduce_kernel<512, 1>(float)", 2030, 30),
        _kernel(4, ELEMENTWISE, 2060, 8),
        _kernel(5, "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNT", 2070, 12),
        _kernel(6, "void nms_suppress_kernel<4>(float const*, int)", 2082, 6),
        _kernel(7, ELEMENTWISE, 2088, 4),
        _kernel(8, "void head_pw_streamed_kernel<true>(CUtensorMap, float*)", 2092, 10),
        _kernel(9, "void at::native::(anonymous namespace)::sort_kernel(float*)", 2102, 3),
        _kernel(10, ELEMENTWISE, 2105, 7),
    ]
    return {"schemaVersion": 1, "traceEvents": host + device}


def _row(us, launches, flops, peak_us, nbytes, total_us, verdict):
    s = us * 1e-6
    return {"ms_per_step": us / 1e3, "share": us / total_us, "launches": float(launches),
            "flops_per_step": float(flops), "tflops": flops / s / 1e12,
            "pct_peak": 100.0 * peak_us / us, "bytes_per_step": float(nbytes),
            "gbps": nbytes / s / 1e9, "pct_hbm": 100.0 * nbytes / s / HBM_BYTES_S,
            "verdict": verdict}


def expected_rows():
    total = 107.0
    conv_flops = 2 * (1 * 4 * 8 * 8) * (2 * 3 * 3)
    mm_flops = 2 * 4096 * 1024 * 4096
    return {
        "backbone": _row(50, 2, conv_flops, conv_flops / PEAK_F32_CUDA_CORES * 1e6,
                         (1024 * 128 * 128 + 4 * 2 * 3 * 3) * 4, total, "bandwidth-leaning"),
        "heads": _row(26, 3, mm_flops, mm_flops / PEAK_BF16 * 1e6,
                      (4096 * 1024 * 2) * 2 + 4 * 4, total, "COMPUTE-bound"),
        "bifpn": _row(8, 1, 0, 0, 8 * 4, total, "latency/overhead"),
        "preprocess": _row(7, 2, 0, 0, 8 * 4 + 16 * 4, total, "latency/overhead"),
        "bifpn backward": _row(7, 1, 0, 0, 8 * 4, total, "latency/overhead"),
        "postprocess": _row(6, 1, 0, 0, 100_000_000 * 4, total, "BANDWIDTH-bound"),
        "other": _row(3, 1, 0, 0, 0, total, "latency/overhead"),
    }


def _check_row(got, want):
    for key in ("ms_per_step", "share", "launches", "flops_per_step", "bytes_per_step", "verdict"):
        assert got[key] == want[key], key
    for key in ("tflops", "pct_peak", "gbps", "pct_hbm"):
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-15), key


@pytest.fixture
def synthetic(tmp_path):
    path = tmp_path / "synthetic.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(synthetic_trace(), f)
    return str(path)


def test_synthetic_trace_stage_table(synthetic):
    r = at.analyze(synthetic)
    assert r["mode"] == "device" and r["n_steps"] == 1
    assert r["step_ms"] == 1000 / 1e3
    assert r["events"] == r["assigned"] == 11
    assert r["xla_ms_per_step"] == r["busy_ms_per_step"] == 107 / 1e3
    want = expected_rows()
    assert list(r["stages"]) == list(want)  # ordered by time
    for name, row in want.items():
        _check_row(r["stages"][name], row)


def test_synthetic_trace_families_and_top(synthetic):
    r = at.analyze(synthetic, top=3)
    fams = {k: v["ms_per_step"] for k, v in r["families"].items()}
    assert fams == {"cudnn_cublas": 32 / 1e3, "reduction": 30 / 1e3, "elementwise": 24 / 1e3,
                    "port_kernels": 16 / 1e3, "sort": 3 / 1e3, "memcpy": 2 / 1e3}
    assert list(fams) == ["cudnn_cublas", "reduction", "elementwise", "port_kernels", "sort",
                          "memcpy"]
    assert [(k["name"], k["op"], k["stage"]) for k in r["top"]] == [
        ("at::native::reduce_kernel<512, 1>", "aten::cudnn_convolution", "backbone"),
        ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw",
         "aten::cudnn_convolution", "backbone"),
        ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNT", "aten::mm", "heads"),
    ]
    assert r["port_kernels"] == {"nms_suppress_kernel": {"postprocess": 1.0},
                                 "head_pw_streamed_kernel": {"heads": 1.0}}
    elementwise = [k for k in at.analyze(synthetic, top=20)["top"]
                   if k["name"].startswith("at::native::vectorized")]
    assert sorted((k["op"], k["launches"]) for k in elementwise) == [
        ("aten::add", 1.0), ("aten::div", 1.0), ("aten::mul", 2.0)]


def test_synthetic_trace_json_line(synthetic, capsys):
    r = at.main([synthetic, "--json", "--calls", "1"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert line == json.loads(json.dumps(r))
    assert line["event"] == "trace_roofline"
    for key in ("trace", "n_steps", "step_ms", "xla_ms_per_step", "stages"):
        assert key in line  # the JAX tool's keys
    for row in line["stages"].values():
        for key in ("ms_per_step", "share", "gbps", "pct_hbm", "tflops", "pct_peak", "verdict"):
            assert key in row


def test_find_trace_takes_the_newest(tmp_path, synthetic):
    d = tmp_path / "traces"
    d.mkdir()
    old, new = d / "a.json", d / "sub" / "b.json.gz"
    old.write_text(json.dumps(synthetic_trace()))
    new.parent.mkdir()
    with gzip.open(new, "wt") as f:
        json.dump(synthetic_trace(), f)
    os.utime(old, (1, 1))
    assert at.find_trace(str(d)) == str(new)
    with pytest.raises(FileNotFoundError):
        at.find_trace(str(tmp_path / "empty_dir_does_not_exist"))


# ---------------------------------------------------------------- the range names

def test_each_range_name_classifies_into_its_stage_by_the_jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import analyze_trace as jax_tool
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    assert set(profiling.RANGE_NAMES) == set(profiling.STAGES)
    for st, name in profiling.RANGE_NAMES.items():
        assert jax_tool.classify(name, "", "") == st, name
        assert profiling.stage_of_range(name) == st
    assert profiling.stage_of_range("ProfilerStep#3") is None


def test_stage_rejects_unknown_names_and_turns_off():
    with pytest.raises(ValueError):
        profiling.stage("neck")
    with profiling.stages_off():
        assert isinstance(profiling.stage("heads"), contextlib.nullcontext)
        with profiling.stages_off():
            pass
        assert isinstance(profiling.stage("heads"), contextlib.nullcontext)
    # a range only while spans are recorded (a profiler session, or record_spans())
    assert isinstance(profiling.stage("heads"), contextlib.nullcontext)
    with profiling.record_spans():
        assert not isinstance(profiling.stage("heads"), contextlib.nullcontext)
        with profiling.stages_off():
            assert isinstance(profiling.stage("heads"), contextlib.nullcontext)


# ---------------------------------------------------------------- real CPU traces

@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def slim():
    model = ranks.slim_model().eval()
    images = torch.from_numpy(ranks.slim_batch(2)["images"])
    return model, images


def _ranges(path):
    """(name, ts, end) of every stage range, in time order."""
    ev = at.load_events(path)
    out = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in ev
           if e.get("cat") == "user_annotation" and profiling.stage_of_range(e["name"])]
    return sorted(out, key=lambda r: r[1])


def _trace(tmp_path, name, fn, calls):
    with profiling.trace(str(tmp_path), name=name) as prof:
        for _ in range(calls):
            fn()
            prof.step()
    return str(tmp_path / name)


def test_cpu_trace_of_predict_pipeline(slim, tmp_path):
    model, images = slim
    call = lambda: et.predict_pipeline(model, images)  # noqa: E731
    call()
    path = _trace(tmp_path, "predict.json", call, 2)
    ranges = _ranges(path)
    names = [profiling.stage_of_range(n) for n, _, _ in ranges]
    assert names == INFERENCE_STAGES * 2  # in pipeline order, one set a call
    for (_, a0, a1), (_, b0, b1) in zip(ranges, ranges[1:]):
        assert a1 <= b0  # no stage range inside another
    r = at.analyze(path)
    assert r["mode"] == "cpu" and r["n_steps"] == 2
    assert set(r["stages"]) <= set(INFERENCE_STAGES) | {"other"}
    assert set(INFERENCE_STAGES) <= set(r["stages"])
    assert r["events"] == r["assigned"]
    other = r["stages"].get("other", {"ms_per_step": 0.0})["ms_per_step"]
    assert other < OTHER_SHARE * r["busy_ms_per_step"]
    assert sum(v["ms_per_step"] for v in r["stages"].values()) == pytest.approx(
        r["busy_ms_per_step"], rel=1e-9)
    # FLOPs: FlopCounterMode's count of the same call (the head products run
    # inside the head kernel's op, which it sees whole)
    flops = sum(v["flops_per_step"] for v in r["stages"].values())
    assert flops == profiling.flops_estimate(lambda x: et.predict_pipeline(model, x), images)
    assert r["stages"]["backbone"]["flops_per_step"] > 0


def test_cpu_trace_of_the_predictor(tmp_path):
    pred = et.Predictor(phi=0, num_classes=6, image_size=128, device="cpu")
    image = np.random.RandomState(3).randint(0, 256, (96, 160, 3)).astype(np.uint8)
    pred(image)
    path = _trace(tmp_path, "predictor.json", lambda: pred(image), 1)
    assert [profiling.stage_of_range(n) for n, _, _ in _ranges(path)] == INFERENCE_STAGES
    r = at.analyze(path)
    other = r["stages"].get("other", {"ms_per_step": 0.0})["ms_per_step"]
    assert other < OTHER_SHARE * r["busy_ms_per_step"]


def _train_step(model):
    tc = et.TrainConfig(batch_size=2, max_gt_boxes=4)
    step = et.make_train_step(model, tc, device="cpu")
    state = et.create_train_state(model, tc, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = ranks.slim_batch(2)
    box = {"state": state}

    def call():
        box["state"], _ = step(box["state"], batch, gen)

    return call


def test_cpu_trace_of_a_training_step(tmp_path):
    from torch.utils.flop_counter import FlopCounterMode

    model = ranks.slim_model()
    call = _train_step(model)
    call()
    path = _trace(tmp_path, "train.json", call, 1)
    r = at.analyze(path)
    rows = set(r["stages"])
    assert {"preprocess", "backbone", "bifpn", "heads", "loss", "optimizer"} <= rows
    assert {"backbone backward", "bifpn backward", "heads backward", "loss backward"} <= rows
    assert "postprocess" not in rows and "optimizer backward" not in rows
    # the loss ranges hold no other stage's range: the forward keeps its own
    ranges = _ranges(path)
    for name, t0, t1 in ranges:
        if name.startswith("loss"):
            assert not any(t0 < s0 and s1 < t1 for _, s0, s1 in ranges), name
    other = sum(v["ms_per_step"] for k, v in r["stages"].items() if k.startswith("other"))
    assert other < OTHER_SHARE * r["busy_ms_per_step"]
    # FLOPs: the forward's convolutions as FlopCounterMode counts them, the
    # backward's two products a convolution (input and weight gradients)
    # but the stem's input gradient (the images take none)
    counter = FlopCounterMode(display=False)
    with counter:
        call()
    counts = counter.get_flop_counts()["Global"]
    forward = sum(v["flops_per_step"] for k, v in r["stages"].items() if not k.endswith("backward"))
    backward = sum(v["flops_per_step"] for k, v in r["stages"].items() if k.endswith("backward"))
    assert forward == counts[torch.ops.aten.convolution]
    b, size = 2, ranks.SIZE
    stem = 2 * b * (size // 2) ** 2 * 32 * 3 * 3 * 3
    assert backward == 2 * forward - stem
    # the spans' finer ranges (the loss's parts, step, backward) change no
    # op's stage: the same step traced with them left out gives the same table
    names = {e["name"] for e in at.load_events(path) if e.get("cat") == "user_annotation"}
    subranges = set(filter(None, profiling.SPAN_RANGES.values()))
    assert subranges - {"predict"} <= names
    real = torch.profiler.record_function

    def stages_only(name, *args):
        return contextlib.nullcontext() if name in subranges else real(name, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", stages_only)
        bare = _trace(tmp_path, "train_bare.json", call, 1)
    assert not subranges & {e["name"] for e in at.load_events(bare)
                            if e.get("cat") == "user_annotation"}
    assert _op_stages(path) == _op_stages(bare)
    assert {k: v["launches"] for k, v in r["stages"].items()} == {
        k: v["launches"] for k, v in at.analyze(bare)["stages"].items()}


def _op_stages(path):
    """Each CPU op's name with the stage the analyser gives it, counted."""
    host = at._Host(at.load_events(path))
    got = collections.Counter()
    for e in host.ordered:
        if e["cat"] == "cpu_op":
            st, bwd = host.stage(e)
            got[(e["name"], st, bwd)] += 1
    return got


def test_stage_ranges_add_no_op(slim, tmp_path):
    model, images = slim
    call = lambda: et.predict_pipeline(model, images)  # noqa: E731
    call()

    def ops(path):
        return collections.Counter(e["name"] for e in at.load_events(path)
                                   if e.get("cat") == "cpu_op")

    on = ops(_trace(tmp_path, "on.json", call, 1))
    with profiling.stages_off():
        off = ops(_trace(tmp_path, "off.json", call, 1))
    assert on == off
    assert not any(profiling.stage_of_range(e["name"]) for e in at.load_events(
        str(tmp_path / "off.json")) if e.get("cat") == "user_annotation")


def test_exported_program_holds_no_profiler_op():
    from efficientdet_tpu_torch.export import export_predict

    model = ranks.slim_model().eval()
    exported, _ = export_predict(model, 1)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert any("nms_keep_mask" in t for t in targets)


# ---------------------------------------------------------------- two gloo ranks

def test_sharded_step_classifies_as_the_one_process_step(tmp_path):
    batch = {k: torch.from_numpy(v) for k, v in ranks.slim_batch(2).items()}
    tc = dict(batch_size=2, max_gt_boxes=4)
    got = spawn(f"{RANKS}:traced_step", 2,
                dict(batch=batch, trace_dir=str(tmp_path), train_config=tc), device="cpu",
                timeout_s=300)
    model = ranks.slim_model(**ranks.TINY)
    step = et.make_train_step(model, et.TrainConfig(**tc), device="cpu")
    state = et.create_train_state(model, et.TrainConfig(**tc), "cpu")
    gen = torch.Generator().manual_seed(0)
    local = {k: v[:1] for k, v in batch.items()}  # rank 0's rows
    with profiling.trace(str(tmp_path), name="one.json") as prof:
        step(state, local, gen)
        prof.step()
    one = ranks.step_summary(str(tmp_path / "one.json"))
    for rank in got:
        assert rank["mode"] == "cpu" and rank["events"] == rank["assigned"]
        assert set(rank["rows"]) == set(one["rows"])
        collectives = rank["marked"].pop("other")
        assert collectives and all(k.startswith("c10d::") for k in collectives)
        # each stage holds the same convolutions, forward and backward
        assert rank["marked"] == one["marked"]
        assert "other" not in one["marked"]
