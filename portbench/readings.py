"""The readings that a cell's correctness limits are set from, in one process.

    python3 portbench/readings.py --workload d0-b128 --seeds 11 12 13 --control-seeds 11 12 13 \
        --faults drop_first_level invert_nms --fault-seeds 21 22 23

For each seed, one run of the cell as ``run.py`` makes it (a short window
of ``--seconds``) prints the port's numbers; for each control seed, the
same run's checked inputs also go through the control, the reference one
precision below the cell's (``lib/precision.py``), in the port's place;
for a training cell also through the half-batch fault (each loss over the
first half of the batch alone). For each fault seed, one run of the cell
with each of ``--faults`` planted in the port (``faults.py``). One JSON
line each. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import faults  # noqa: E402
from portbench.lib import precision  # noqa: E402
from portbench.lib.bench import Bench, Cell  # noqa: E402
from portbench.lib.compare import training_numbers  # noqa: E402


def control_numbers(bench, prec: str) -> dict:
    """The control's numbers, and a training cell's half-batch fault's."""
    check = bench.extra.pop("check")
    if "ring" in check:
        from portbench.traffic.train_step import reference_steps

        steps = bench.params["check_steps"]
        low = reference_steps(bench, check["cfg"], check["sd"], check["ring"], steps,
                              quant=precision.BELOW[prec])
        half = reference_steps(bench, check["cfg"], check["sd"], check["ring"], steps, half_batch=True)
        return {"control": training_numbers(low, check["ref"]),
                "half_batch": training_numbers(half, check["ref"])}
    from portbench.lib.detect import control_gaps

    return {"control": control_gaps(check, precision.BELOW[prec])}


def digest(port) -> list:
    """The checked detections in brief (their count and the sums of their
    scores and boxes): a fault that leaves them as a sound run of the same
    seed has them changed no answer."""
    return [sum(len(s) for _, s, _ in port), sum(float(s.double().sum()) for _, s, _ in port),
            sum(float(b.double().sum()) for b, _, _ in port)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], choices=sorted(faults.FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("portbench/readings.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(ROOT, args.workload)
    runs = [(seed, None) for seed in args.seeds]
    runs += [(seed, fault) for fault in args.faults for seed in args.fault_seeds]
    for seed, fault in runs:
        undo = faults.plant(fault) if fault else None
        bench = Bench(cell, seed, args.seconds, False, time.perf_counter())
        try:
            cell.traffic().run(bench)
        finally:
            if undo:
                undo()
        rec = {"workload": args.workload, "seed": seed, "fault": fault, "numbers": bench.numbers,
               "faults": bench.faults, "end_to_end": bench.end_to_end}
        if "port" in bench.extra.get("check", {}):
            rec["answers"] = digest(bench.extra["check"]["port"])
        if seed in args.control_seeds and not fault:
            prec = "f32" if cell.workload["kind"] == "train_step" else bench.params["precision"]
            rec.update(control_numbers(bench, prec))
        print(json.dumps(rec), flush=True)
        del bench
        bench = None
        import gc

        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
