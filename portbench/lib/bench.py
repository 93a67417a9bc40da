"""What one run of one cell carries: the cell's files found by name, the
seeds, and what the traffic module and the metric readers fill in.

Everything is found from the names in ``BENCHMARK.json``: the cell's
``portbench/workloads/<cell>.json`` (its traffic kind, parameters and
correctness limits), its configuration's ``file``, the traffic module
``portbench/traffic/<kind>.py`` and one reader
``portbench/metrics/<metric>.py`` a per-layer metric, the metric's dots
written as ``__``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

# top-level modules that may not be loaded where the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "efficientdet_tpu")


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def metric_file(root: str, name: str) -> str:
    return os.path.join(root, "portbench", "metrics", name.replace(".", "__") + ".py")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Cell:
    """The files of one cell, resolved by name."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.spec = load_spec(root)
        self.name = name
        with open(os.path.join(root, "portbench", "workloads", name + ".json")) as f:
            self.workload = json.load(f)
        entries = {w["name"]: w for w in self.spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(entries)}")
        self.entry = entries[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        file = configs[self.entry["config"]]["file"]
        with open(os.path.join(root, file)) as f:
            self.config = json.load(f)
        for key in ("config", "traffic", "chips"):
            if self.workload[key] != self.entry[key]:
                raise ValueError(f"{name}: the workload file's {key} {self.workload[key]!r} is not "
                                 f"BENCHMARK.json's {self.entry[key]!r}")
        self.kind = self.workload["kind"]
        self.traffic_file = os.path.join(root, "portbench", "traffic", self.kind + ".py")
        self.end_to_end = [m for m in self.spec["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in self.spec["per_layer"] if applies(m, name)]
        for m in self.per_layer:
            if not os.path.exists(metric_file(root, m["name"])):
                raise FileNotFoundError(metric_file(root, m["name"]))
        if not os.path.exists(self.traffic_file):
            raise FileNotFoundError(self.traffic_file)

    def traffic(self):
        return load_module(self.traffic_file, "portbench_traffic_" + self.kind)

    def reader(self, metric: str):
        return load_module(metric_file(self.root, metric),
                           "portbench_metric_" + metric.replace(".", "__"))


class Bench:
    """One run: its cell, arguments and results."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
                 device: str = "cuda"):
        self.cell = cell
        self.params: Dict = cell.workload["params"]
        self.limits: Dict[str, float] = cell.workload["limits"]
        self.config: Dict = cell.config
        self.seed = seed
        self.seconds = seconds
        self.trace_on = trace
        self.t_start = t_start
        self.device = device
        # filled by the traffic module
        self.setup_s: Optional[float] = None
        self.end_to_end: Dict[str, float] = {}
        self.numbers: Dict[str, float] = {}
        self.faults: List[str] = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.trace = None  # lib.trace.Trace of the traced stretch
        self.extra: Dict = {}  # what the readers need beside the trace

    def seed_for(self, tag: str) -> int:
        """A seed of its own for each thing drawn, from the run's seed."""
        h = hashlib.sha256(f"{self.seed}/{tag}".encode()).digest()
        return int.from_bytes(h[:8], "little") >> 1

    def stamp(self, what: str) -> None:
        """Log how far into set-up ``what`` is done."""
        self.log(f"set-up: {what} at {time.perf_counter() - self.t_start:.3f} s")

    def mark_setup_done(self) -> None:
        """Set-up ends where the first timed call starts."""
        self.setup_s = time.perf_counter() - self.t_start

    # the device calls a traffic module makes, which a rehearsal on the CPU skips
    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        if self.device == "cpu":
            return 0
        import torch
        return torch.cuda.max_memory_allocated(self.device)

    def host(self, t):
        """``t`` in host memory, pinned where there is a card."""
        t = t.cpu()
        return t if self.device == "cpu" else t.pin_memory()

    def free(self) -> None:
        import gc
        gc.collect()
        if self.device != "cpu":
            import torch
            torch.cuda.empty_cache()

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))
