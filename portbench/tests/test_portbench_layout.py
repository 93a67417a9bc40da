"""BENCHMARK.json against the benchmark's contract, every name resolved to its
files, a new configuration, cell and metric found from files and entries
alone, and the imports that the benchmark may not make."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil

import pytest

from conftest import ROOT
from portbench.lib.bench import Bench, Cell, load_spec, metric_file

SPEC = load_spec(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_DIR = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "efficientdet_tpu"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_configs_cells_and_metrics_keep_the_contract():
    names = [c["name"] for c in SPEC["configs"]]
    cells = [w["name"] for w in SPEC["workloads"]]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == [] and c["name"] in {w["config"] for w in SPEC["workloads"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metric_names = list(e2e) + [m["name"] for m in SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = Cell(ROOT, name)
    assert cell.workload["name"] == name and cell.config["name"]
    assert callable(cell.traffic().run)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    assert set(cell.workload["limits"]) and all(v > 0 for v in cell.workload["limits"].values())


def test_a_new_config_cell_and_metric_need_only_files_and_entries(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.load(open(os.path.join(ROOT, "portbench/configs/effdet-d0.json")))
    cfg.update(name="efficientdet-d1", phi=1, image_size=640, backbone_name="efficientnet-b1",
               fpn_num_filters=88, fpn_cell_repeats=4)
    json.dump(cfg, open(tmp_path / "portbench/configs/effdet-d1.json", "w"))
    spec["configs"].append({"name": "effdet-d1", "source": "https://arxiv.org/abs/1911.09070",
                            "file": "portbench/configs/effdet-d1.json", "reduced": [], "why": "D1"})
    work = json.load(open(os.path.join(ROOT, "portbench/workloads/d0-b128.json")))
    work.update(name="d1-b64", config="effdet-d1", traffic="batched_b64_d1")
    json.dump(work, open(tmp_path / "portbench/workloads/d1-b64.json", "w"))
    spec["workloads"].append({"name": "d1-b64", "config": "effdet-d1", "traffic": "batched_b64_d1",
                              "chips": 1, "why": "D1"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "d0-b128" in m["workloads"]:
            m["workloads"].append("d1-b64")
    (tmp_path / "portbench/metrics/calls_traced__infer.py").write_text(
        "def read(bench):\n    return bench.trace.calls if bench.trace else None\n")
    spec["per_layer"].append({"name": "calls_traced.infer", "unit": "calls", "better": "higher",
                              "source": "device_trace", "layer": "whole call",
                              "moves": "infer_img_s", "workloads": ["d1-b64"]})
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))

    cell = Cell(str(tmp_path), "d1-b64")
    assert cell.config["phi"] == 1 and cell.kind == "batched"
    assert [m["name"] for m in cell.per_layer] == ["calls_traced.infer"]
    assert metric_file(str(tmp_path), "calls_traced.infer").endswith("calls_traced__infer.py")
    bench = Bench(cell, 1, 1.0, True, 0.0, "cpu")
    assert cell.reader("calls_traced.infer").read(bench) is None
    assert {m["name"] for m in cell.end_to_end} == {"infer_img_s", "peak_gb", "setup_s"}
    from portbench.lib.models import port_config, reference_config

    assert reference_config(cell.config).bifpn_width == port_config(cell.config).bifpn_width == 88


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(top):
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py")]


@pytest.mark.parametrize("path", [p for p in _sources(BENCH_DIR) if "/tests/" not in p],
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_benchmark_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_scan_compares_whole_top_level_names():
    assert "efficientdet_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "efficientdet_tpu.models".split(".", 1)[0] in FORBIDDEN


@pytest.mark.parametrize("path", _sources(os.path.join(BENCH_DIR, "reference")),
                         ids=lambda p: os.path.basename(p))
def test_the_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & (FORBIDDEN | {"efficientdet_tpu_torch", "portbench"}), tops
