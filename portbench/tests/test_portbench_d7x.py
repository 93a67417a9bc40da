"""The ``d7x-b16`` cell (EfficientDet-D7x, P3..P8) rehearsed on the CPU at
256 px, batch 1, the port in float32 with the kernels' plain versions: the
result line's keys in both modes, ``correct`` read through
``reference/levels.py``, and the new BiFPN span readers."""

from __future__ import annotations

import argparse
import json

import pytest

from conftest import ROOT
from portbench import run
from portbench.lib.bench import Cell

SMALL = dict(batch=1, ring=2, precision="f32", check_images=2, check_block=1,
             trace_start_call=1, trace_calls=1, warmup_calls=1)


def _cell(trace: int):
    import torch

    torch.set_num_threads(2)
    cell = Cell(ROOT, "d7x-b16")
    cell.config["image_size"] = 256
    cell.workload["params"].update(SMALL)
    return cell, argparse.Namespace(workload="d7x-b16", seed=2 ** 31 + 91, seconds=0.5,
                                    trace=trace)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cpu_rehearsal_of_d7x_prints_the_contract_keys(trace):
    cell, args = _cell(trace)
    assert cell.kind == "batched_levels" and cell.config["max_level"] == 8
    res = run.measure(cell, args, device="cpu")
    json.loads(json.dumps(res))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == set(cell.workload["limits"])
    assert res["checks"]["box_rel"]["value"] < 1e-5 and res["checks"]["logit_gap"]["value"] < 1e-4
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
        assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
        # the CPU records no stream time, so the span readers give nothing
        assert "bifpn_fuse_ms.infer" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert res["metrics"]["setup_s"]["value"] > 0


def test_the_cell_reports_the_bifpn_spans_and_what_the_inference_cells_report():
    cell, _ = _cell(0)
    names = {m["name"] for m in cell.per_layer}
    assert {"bifpn_fuse_ms.infer", "bifpn_resample_ms.infer", "mfu.infer",
            "head_kernel_roofline.infer", "nms_kernel_roofline.infer"} <= names
    assert {m["name"] for m in cell.end_to_end} == {"infer_img_s", "peak_gb", "setup_s"}
    for name in ("bifpn_fuse_ms.infer", "bifpn_resample_ms.infer"):
        assert [m for m in cell.per_layer if m["name"] == name][0]["source"] == "program_span"


def test_the_span_readers_read_the_spans_per_traced_call(monkeypatch):
    from efficientdet_tpu_torch.utils import profiling
    from portbench.lib.bench import Bench

    cell, _ = _cell(1)
    bench = Bench(cell, 1, 1.0, True, 0.0, "cpu")
    assert cell.reader("bifpn_fuse_ms.infer").read(bench) is None  # no trace yet
    bench.trace = argparse.Namespace(calls=4)
    rows = {"bifpn.fuse": {"stream_ms": 8.0}, "bifpn.resample": {"stream_ms": 2.0}}
    monkeypatch.setattr(profiling, "summary", lambda: rows)
    assert cell.reader("bifpn_fuse_ms.infer").read(bench) == 2.0
    assert cell.reader("bifpn_resample_ms.infer").read(bench) == 0.5


def test_flops_count_the_sixth_level():
    from portbench.lib.flops import inference_flops as five_levels
    from portbench.lib.models import reference_config
    from portbench.traffic.batched_levels import inference_flops

    cfg = json.load(open(f"{ROOT}/portbench/configs/effdet-d4.json"))
    cfg["image_size"] = 256
    rc = reference_config(cfg)
    assert inference_flops(rc, 2) == five_levels(rc, 2)  # P3..P7: the same count
    cell, _ = _cell(0)
    d7x = reference_config(cell.config)
    assert len(d7x.strides) == 6
    assert inference_flops(d7x, 1) > 0


def test_the_layer_by_layer_comparison_reads_every_level_and_the_counters():
    from portbench.readings_levels import levels_numbers

    cell, _ = _cell(0)
    out = levels_numbers(cell, 2 ** 31 + 3, images=2, block=1, device="cpu")
    keys = {"C3.tap", "C4.tap", "C5.tap"} | {f"P{lvl}.{p}" for lvl in range(3, 9)
                                              for p in ("cls", "box")}
    assert set(out["port"]) == set(out["control"]) == keys
    assert out["fusion_nodes"] == {"sum": 80, "weighted": 0}
    assert max(out["port"].values()) < 1e-4, out["port"]  # float32 against float32
    # the control (TF32 rounding for a float32 cell) lies far wider at every level
    assert all(out["control"][k] > 10 * out["port"][k] for k in keys if k.endswith(".cls"))
