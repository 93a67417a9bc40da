"""The benchmark of ``efficientdet_tpu_torch`` on NVIDIA H100s: one run of one cell.

    python3 portbench/run.py --workload d0-b128 --seed 7 --seconds 10 --trace 0

Run from the root of a checkout. The cell's files are found by name from
``BENCHMARK.json`` (``lib/bench.py``); its traffic module builds the port,
warms up every shape the cell uses (set-up, ``setup_s``), measures for
``--seconds`` and then checks what the window produced against the
benchmark's plain reference (``correct``). ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` profiles a short steady stretch of
the window and reports its per-layer metrics instead, with the device's
busy time and a breakdown.

The last line of standard output is one JSON object; the numbers compared
for ``correct``, each beside its limit, are the last lines of standard
error and the result's last key. With no card, or fewer than the cell asks
for, the run prints no result and exits with 2; with a JAX module loaded
when the window has closed, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here, before torch loads

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a run that has not ended by then prints every thread's stack and exits with 1
HANG_S = 340
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib.bench import Bench, Cell, forbidden_modules  # noqa: E402
from portbench.lib.compare import judged  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(bench, chips: int) -> dict:
    import torch

    dev = {"platform": "gpu" if bench.device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if bench.device != "cpu" else "cpu",
           "count": chips, "memory_peak_bytes": int(bench.memory_peak_bytes)}
    if bench.trace is not None:
        dev["busy_s"] = bench.trace.busy_s
        dev["window_s"] = bench.trace.window_s
    return dev


def measure(cell: Cell, args, device: str = "cuda") -> dict:
    """Drive one run of ``cell`` and return its result line as a dict."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = Bench(cell, args.seed, args.seconds, bool(args.trace), T_START, device)
    cell.traffic().run(bench)
    metrics = {}
    if args.trace:
        from portbench.lib.card import power_limit

        bench.log(f"card and power limit: {power_limit()}")
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(bench)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(bench.end_to_end, setup_s=bench.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    checks = judged(bench.numbers, bench.limits)
    correct = not bench.faults and all(v <= limit for _, v, limit in checks)
    result = {"correct": correct, "attempted": bench.attempted, "failed": bench.failed,
              "metrics": metrics, "device": device_info(bench, cell.entry["chips"])}
    if bench.trace is not None:
        result["breakdown"] = {"device_ops": bench.trace.top_device_ops,
                               "idle_gaps": bench.trace.idle_gaps}
    for fault in bench.faults:
        bench.log(f"fault: {fault}")
    result["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": limit}
                        for name, v, limit in checks}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cell = Cell(ROOT, args.workload)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    try:
        result = measure(cell, args)
    finally:
        faulthandler.cancel_dump_traceback_later()
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX modules loaded in the measuring process: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
