"""Each traffic module rehearsed on the CPU at a tiny size, with the kernels'
plain versions: the result line's keys in both modes, a run that finds no
card failing rather than falling back to the CPU, and the JAX guard."""

from __future__ import annotations

import json
import sys
import types

import pytest

from portbench import run
from portbench.lib.bench import forbidden_modules

CELLS = ["d0-b128", "d4-b64", "d0-train"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_rehearsal_prints_the_contract_keys(tiny, name, trace):
    cell, args = tiny(name, trace=trace)
    res = run.measure(cell, args, device="cpu")
    json.loads(json.dumps(res))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == set(cell.workload["limits"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
        assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert res["metrics"]["setup_s"]["value"] > 0


def test_a_run_without_a_card_fails_and_prints_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "d0-b128", "--seed", str(2 ** 31 + 5), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_the_guard_names_jax_modules_and_not_the_port(monkeypatch):
    import efficientdet_tpu_torch  # noqa: F401

    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "efficientdet_tpu.ops", types.ModuleType("efficientdet_tpu.ops"))
    assert forbidden_modules() == ["efficientdet_tpu", "jax"]
