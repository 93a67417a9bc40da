"""Device time by stage of a torch.profiler trace: the port's counterpart of
the JAX package's ``tools/analyze_trace.py``.

Turns a Chrome trace that ``utils.profiling.trace`` (or the profiler's own
``export_chrome_trace``) wrote into the JAX tool's three tables: device time,
FLOP/s and bytes per pipeline stage (the ranges ``utils.profiling.stage``
opens: preprocess, backbone, bifpn, heads, postprocess, loss, optimizer;
the rest is "other"), each split into forward and backward where a backward
ran, against the H100's ceilings (``experiments/timing.py``) with the JAX
tool's verdict; device time by kernel family; and the most expensive
kernels, each beside the op that launched it.

Usage::

  python -m efficientdet_tpu_torch.tools.analyze_trace traces/         # newest trace under a directory
  python -m efficientdet_tpu_torch.tools.analyze_trace t.json.gz --top 25 --json

Works offline on a saved trace (``.json`` or ``.json.gz``), with no card.
How a device event (kernel, memcpy, memset) finds its stage:

* its ``correlation`` id names the runtime launch on the host; the innermost
  ``user_annotation`` around that launch whose name opens a stage
  (``utils.profiling.stage_of_range``: "heads/class_net+box_net" opens
  heads) gives it;
* backward kernels are launched on autograd's thread, outside every range:
  the innermost ``autograd::engine::evaluate_function`` around the launch
  carries the ``Sequence number`` of the forward op that made its node, and
  the kernel takes that op's stage, marked backward;
* collectives (``c10d::`` ops and what they launch, NCCL kernels) are
  "other" wherever they run: a stage's rows hold its computation;
* what is left is "other", except the port's own kernels, which fall back on
  their names (``head_pw`` -> heads, ``nms_suppress`` -> postprocess,
  ``mbconv_`` -> backbone), as the JAX tool falls back on HLO names.

FLOPs count convolutions and matrix products only, as ``FlopCounterMode``
(``utils.profiling.flops_estimate``) does: reckoned from each such op's
recorded shapes (the trace needs ``record_shapes``), carried to the kernels
it launched, and held against the bf16 tensor-core peak for bf16 and fp16
inputs and the CUDA cores' float32 peak otherwise (TF32 off). A grouped
convolution's weight gradient counts its own multiply-adds, where
FlopCounterMode counts it as if ungrouped (the group count times too many);
the ops inside the port's own ops (the kernels' plain versions on the CPU)
count none, as FlopCounterMode sees such an op whole. Bytes are each
launching op's recorded input sizes, once an op: a lower bound of what it
moves (outputs and second reads are not seen).

A trace with no device events (a CPU run) falls back to each CPU op's self
time, the op's stage found by the same rules; bytes are then the leaf ops'
inputs, and no verdict is given.

A trace's calls are its ``ProfilerStep#N`` ranges (``prof.step()`` between
calls), unless ``--calls`` says how many there were.
"""

from __future__ import annotations

import argparse
import ast
import collections
import functools
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple

from ..experiments.timing import HBM_BYTES_S, PEAK_BF16, PEAK_F32_CUDA_CORES
from ..utils.profiling import stage_of_range

OTHER = "other"
BACKWARD = " backward"  # the suffix of a stage's backward row
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op") + LAUNCH_CATS
EVALUATE = "autograd::engine::evaluate_function"
PORT_OPS = "efficientdet_tpu_torch::"  # the kernels' torch.library ops
# collectives: in "other" wherever they run (a stage's rows hold its compute)
COLLECTIVES = r"^c10d::|^nccl:|^gloo:|record_param_comms|^ncclDevKernel|^ncclKernel"
STEP = "ProfilerStep#"
# the port's own kernels, where no range holds their launch
KERNEL_STAGES = (("heads", r"head_pw"), ("postprocess", r"nms_suppress"),
                 ("backbone", r"mbconv_"))
# kernel families by name, first match (device events; CPU op names in CPU mode)
FAMILIES = (
    ("port_kernels", r"head_pw|nms_suppress|mbconv_|tap_floor"),
    ("memcpy", r"[Mm]emcpy|[Mm]emset"),
    ("sort", r"[Ss]ort|[Rr]adix|[Tt]op[Kk]|bitonic|cub::"),
    ("cudnn_cublas", r"cudnn|cublas|[Gg]emm|xmma|cutlass|nvjet|conv|Conv|wgrad|dgrad|fprop"
                     r"|mkldnn|aten::mm|aten::addmm|aten::bmm"),
    ("reduction", r"[Rr]educe|[Ww]elford|norm|softmax|[Pp]ool|sum|mean|amax|argmax"),
    ("elementwise", r"[Ee]lementwise|vectorized|unrolled|CatArray|[Ii]ndex|scatter|gather|fill"
                    r"|copy|upsample|pad|where|multi_tensor_apply|foreach|aten::"),
)
# element sizes of the profiler's "Input type" names
ELEMENT_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2, "long int": 8,
                 "int": 4, "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1,
                 "c10::complex<float>": 8, "TensorList": 4}
HALF_TYPES = ("c10::BFloat16", "c10::Half")
EPS_US = 1e-3  # timestamp rounding allowed when one range holds another


def find_trace(path: str) -> str:
    """``path`` itself, or the newest ``*.json``/``*.json.gz`` under it."""
    if os.path.isfile(path):
        return path
    hits = sorted((p for pat in ("*.json", "*.json.gz")
                   for p in glob.glob(os.path.join(path, "**", pat), recursive=True)),
                  key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no *.json or *.json.gz trace under {path}")
    return hits[-1]


def load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _dims(args) -> list:
    return args.get("Input Dims") or []


def _concrete(args, i, default):
    """The ``i``-th concrete input (a list or scalar literal), or ``default``."""
    vals = args.get("Concrete Inputs") or []
    try:
        v = ast.literal_eval(vals[i])
    except (IndexError, ValueError, SyntaxError):
        return default
    return v if v != "" else default


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _conv_out(x, w, stride, padding, dilation) -> List[int]:
    spatial = []
    for i, (n, k) in enumerate(zip(x[2:], w[2:])):
        s = stride[i] if i < len(stride) else stride[-1]
        p = padding[i] if i < len(padding) else padding[-1]
        d = dilation[i] if i < len(dilation) else dilation[-1]
        spatial.append((n + 2 * p - d * (k - 1) - 1) // s + 1)
    return [x[0], w[0]] + spatial


def op_flops(op: dict) -> int:
    """FLOPs of one convolution or matrix product from its recorded shapes
    (FlopCounterMode's count: 2 a multiply-add); 0 for any other op."""
    name, args = op["name"], op.get("args", {})
    d = _dims(args)
    try:
        if name == "aten::convolution" and not _concrete(args, 6, False):
            x, w = d[0], d[1]
            stride, padding, dilation = (_concrete(args, i, [v]) for i, v in ((3, 1), (4, 0), (5, 1)))
            return 2 * _prod(_conv_out(x, w, stride, padding, dilation)) * _prod(w[1:])
        if name == "aten::convolution_backward" and not _concrete(args, 7, False):
            go, w = d[0], d[2]
            mask = _concrete(args, 10, [True, True, False])
            return 2 * _prod(go) * _prod(w[1:]) * (int(bool(mask[0])) + int(bool(mask[1])))
        if name == "aten::mm":
            return 2 * _prod(d[0]) * d[1][-1]
        if name == "aten::addmm":
            return 2 * _prod(d[1]) * d[2][-1]
        if name == "aten::bmm":
            return 2 * _prod(d[0]) * d[1][-1]
        if name == "aten::baddbmm":
            return 2 * _prod(d[1]) * d[2][-1]
    except (IndexError, TypeError):
        return 0
    return 0


def op_bytes(op: dict) -> int:
    """The sizes of an op's recorded tensor inputs (TensorList elements at 4
    bytes each)."""
    args = op.get("args", {})
    total = 0
    for dims, typ in zip(_dims(args), args.get("Input type") or []):
        size = ELEMENT_BYTES.get(typ)
        if not size or not dims:
            continue
        if isinstance(dims[0], list):  # a TensorList
            total += sum(_prod(t) * size for t in dims if t)
        else:
            total += _prod(dims) * size
    return total


def _peak(op: dict) -> float:
    types = op.get("args", {}).get("Input type") or []
    return PEAK_BF16 if any(t in HALF_TYPES for t in types) else PEAK_F32_CUDA_CORES


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name):
            return fam
    return OTHER


def is_collective(name: str) -> bool:
    return re.search(COLLECTIVES, name) is not None


def kernel_stage(name: str) -> str:
    for st, pat in KERNEL_STAGES:
        if re.search(pat, name):
            return st
    return OTHER


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


class _Host:
    """The host events of a trace, nested thread by thread (each event's
    parent is the innermost event around it), with each event's stage."""

    def __init__(self, events: List[dict]):
        self.is_collective = functools.lru_cache(maxsize=None)(is_collective)  # once a name
        threads = collections.defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS:
                threads[(e["pid"], e["tid"])].append(e)
        self.parent: Dict[int, Optional[dict]] = {}
        self._flops: Dict[int, int] = {}
        self.ann: Dict[int, Optional[str]] = {}  # the innermost stage range around
        self.eval: Dict[int, Optional[dict]] = {}  # the innermost evaluate_function around
        self.collective: Dict[int, bool] = {}  # inside a collective op
        self.step: Dict[int, Optional[dict]] = {}  # the ProfilerStep range around
        self.forward: Dict[Tuple[int, int], Optional[str]] = {}  # (pid, sequence) -> stage
        self.ordered: List[dict] = []
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
                is_step = e["cat"] == "user_annotation" and e["name"].startswith(STEP)
                self.step[k] = e if is_step else (self.step[id(p)] if p else None)
                self.collective[k] = self.is_collective(e["name"]) or (
                    self.collective[id(p)] if p else False)
                seq = e.get("args", {}).get("Sequence number")
                if e["cat"] == "cpu_op" and seq is not None and self.eval[k] is None:
                    # every op carries the sequence number current when it ran; the last
                    # one to carry it made the autograd node that backward names
                    self.forward[(e["pid"], seq)] = self.ann[k]
                stack.append(e)
                self.ordered.append(e)

    def stage(self, e: dict) -> Tuple[Optional[str], bool]:
        """(stage or None, whether it ran in a backward pass); None, False
        inside a collective."""
        if self.collective[id(e)]:
            return None, False
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

    def flops(self, e: dict) -> int:
        """:func:`op_flops` of ``e``, computed once."""
        k = id(e)
        if k not in self._flops:
            self._flops[k] = op_flops(e) if e["cat"] == "cpu_op" else 0
        return self._flops[k]

    def op_of(self, e: dict, flops: bool = False) -> Optional[dict]:
        """The innermost CPU op around ``e``; ``flops``: the innermost one
        around or at ``e`` with a FLOP count, None inside one of the port's
        own ops (FlopCounterMode sees such an op whole: on the CPU it runs
        the kernel's plain version, on the card no ATen op)."""
        p = e if flops else self.parent[id(e)]
        while p is not None and not (p["cat"] == "cpu_op" and (not flops or self.flops(p))):
            p = self.parent[id(p)]
        if flops and p is not None:
            q = self.parent[id(p)]
            while q is not None:
                if q["name"].startswith(PORT_OPS):
                    return None
                q = self.parent[id(q)]
        return p


def _busy_us(events: List[dict]) -> float:
    """The union of the events' intervals, device by device."""
    total = 0.0
    by_dev = collections.defaultdict(list)
    for e in events:
        by_dev[e.get("args", {}).get("device", 0)].append((e["ts"], e["ts"] + e.get("dur", 0)))
    for spans in by_dev.values():
        spans.sort()
        lo, hi = spans[0]
        for a, b in spans[1:]:
            if a > hi:
                total += hi - lo
                lo, hi = a, b
            else:
                hi = max(hi, b)
        total += hi - lo
    return total


def _verdict(gbps: float, pct_peak: float) -> str:
    """The JAX tool's thresholds, against the H100's ceilings."""
    if gbps > 0.6 * HBM_BYTES_S / 1e9:
        return "BANDWIDTH-bound"
    if pct_peak > 50.0:
        return "COMPUTE-bound"
    if gbps > 0.3 * HBM_BYTES_S / 1e9:
        return "bandwidth-leaning"
    return "latency/overhead"


def analyze(path: str, calls: Optional[int] = None, top: int = 15) -> dict:
    """The stage table, families and top kernels of the trace at ``path``
    (a file, or the newest trace under a directory), as one dict: the JAX
    tool's ``--json`` keys and the port's own."""
    path = find_trace(path)
    events = load_events(path)
    host = _Host(events)
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    # the step ranges that hold a call's ops (the profiler opens one more
    # after the last step(), which may hold the closing synchronize)
    with_ops = {id(host.step[id(e)]) for e in host.ordered
                if e["cat"] == "cpu_op" and host.step[id(e)] is not None}
    steps = [e for e in host.ordered if e["cat"] == "user_annotation"
             and e["name"].startswith(STEP) and id(e) in with_ops]
    n = calls or max(len(steps), 1)

    # the names' classifications, once a name in this trace
    fam_of, stage_of, short_of = (functools.lru_cache(maxsize=None)(f) for f in (
        family, kernel_stage, short_name))
    # the units: (duration us, stage row, family, name, launching op, flop op, bytes op)
    units = []
    if device:
        mode = "device"
        launches = {e["args"]["correlation"]: e for e in host.ordered
                    if e["cat"] in LAUNCH_CATS and "correlation" in e.get("args", {})}
        for d in device:
            launch = launches.get(d.get("args", {}).get("correlation"))
            st, bwd, op, fop = None, False, None, None
            if launch is not None:
                st, bwd = host.stage(launch)
                op, fop = host.op_of(launch), host.op_of(launch, flops=True)
            if host.is_collective(d["name"]):
                st, bwd = None, False
            st = st or stage_of(d["name"])
            units.append((d.get("dur", 0.0), st + (BACKWARD if bwd else ""), fam_of(d["name"]),
                          short_of(d["name"]), op, fop, op))
        busy = _busy_us(device)
    else:
        mode = "cpu"
        ops = [e for e in host.ordered if e["cat"] == "cpu_op"]
        child_us = collections.Counter()
        has_child = set()
        for e in ops:
            p = host.op_of(e)
            if p is not None:
                child_us[id(p)] += e.get("dur", 0.0)
                has_child.add(id(p))
        for e in ops:
            st, bwd = host.stage(e)
            fop = host.op_of(e, flops=True)
            units.append((max(e.get("dur", 0.0) - child_us[id(e)], 0.0),
                          (st or OTHER) + (BACKWARD if bwd else ""), fam_of(e["name"]), e["name"],
                          host.op_of(e), fop if fop is e else None,
                          None if id(e) in has_child else e))
        busy = sum(u[0] for u in units)

    acc = collections.defaultdict(lambda: {"us": 0.0, "n": 0, "flops": 0, "peak_us": 0.0,
                                           "bytes": 0})
    seen_flops, seen_bytes = set(), set()
    fam_us = collections.Counter()
    port = collections.defaultdict(collections.Counter)  # the port's kernels: name -> row -> n
    per_kernel = collections.defaultdict(lambda: [0.0, 0, collections.Counter(), ""])
    for dur, row, fam, name, op, fop, bop in units:
        a = acc[row]
        a["us"] += dur
        a["n"] += 1
        if fop is not None and id(fop) not in seen_flops:
            seen_flops.add(id(fop))
            f = host.flops(fop)
            a["flops"] += f
            a["peak_us"] += f / _peak(fop) * 1e6
        if bop is not None and id(bop) not in seen_bytes:
            seen_bytes.add(id(bop))
            a["bytes"] += op_bytes(bop)
        fam_us[fam] += dur
        if fam == "port_kernels":  # by the kernel's own name, without namespace or template
            port[name.split("<")[0].split("::")[-1]][row] += 1
        k = per_kernel[(name, op["name"] if op else "")]
        k[0] += dur
        k[1] += 1
        k[2][row] += dur
        k[3] = fam

    total = sum(a["us"] for a in acc.values())
    rows = {}
    for row, a in sorted(acc.items(), key=lambda kv: -kv[1]["us"]):
        s = a["us"] * 1e-6
        gbps = a["bytes"] / s / 1e9 if s else 0.0
        tflops = a["flops"] / s / 1e12 if s else 0.0
        pct_peak = 100.0 * a["peak_us"] / a["us"] if a["us"] else 0.0
        rows[row] = {
            "ms_per_step": a["us"] / 1e3 / n,
            "share": a["us"] / total if total else 0.0,
            "launches": a["n"] / n,
            "flops_per_step": a["flops"] / n,
            "tflops": tflops,
            "pct_peak": pct_peak if mode == "device" else None,
            "bytes_per_step": a["bytes"] / n,
            "gbps": gbps,
            "pct_hbm": 100.0 * gbps * 1e9 / HBM_BYTES_S if mode == "device" else None,
            "verdict": _verdict(gbps, pct_peak) if mode == "device" else "host (CPU trace)",
        }
    return {
        "event": "trace_roofline",
        "trace": path,
        "mode": mode,
        "n_steps": n,
        "step_ms": sum(e["dur"] for e in steps) / len(steps) / 1e3 if steps else None,
        "xla_ms_per_step": total / 1e3 / n,
        "busy_ms_per_step": busy / 1e3 / n,
        "events": len(units),
        "assigned": sum(a["n"] for a in acc.values()),
        "stages": rows,
        "families": {f: {"ms_per_step": us / 1e3 / n, "share": us / total if total else 0.0}
                     for f, us in fam_us.most_common()},
        "port_kernels": {k: {row: c / n for row, c in rows_n.items()} for k, rows_n in port.items()},
        "top": [{"name": name, "op": op, "stage": rows_us.most_common(1)[0][0], "family": fam,
                 "ms_per_step": us / 1e3 / n, "launches": cnt / n}
                for (name, op), (us, cnt, rows_us, fam) in sorted(
                    per_kernel.items(), key=lambda kv: -kv[1][0])[:top]],
    }


def print_report(r: dict) -> None:
    unit = "device events" if r["mode"] == "device" else "CPU ops, self time (no device events)"
    print(f"trace: {r['trace']} ({unit})")
    print(f"calls: {r['n_steps']}"
          + (f", mean call {r['step_ms']:.2f} ms" if r["step_ms"] else "")
          + f" | busy {r['busy_ms_per_step']:.3f} ms/call, stages {r['xla_ms_per_step']:.3f}"
          f" ms/call, {r['events'] / r['n_steps']:.0f} events/call")
    print("FLOPs: convolutions and matrix products only; bytes: each launching op's "
          "recorded inputs, once an op (a lower bound)")
    print("\n== per stage (ms per call) ==")
    print(f"{'stage':<22} {'ms/call':>9} {'share':>6} {'launch':>7} {'GB/s':>8} {'%HBM':>6} "
          f"{'TFLOP/s':>8} {'%peak':>6}  verdict")
    for st, v in r["stages"].items():
        hbm = "" if v["pct_hbm"] is None else f"{v['pct_hbm']:5.1f}%"
        peak = "" if v["pct_peak"] is None else f"{v['pct_peak']:5.1f}%"
        print(f"{st:<22} {v['ms_per_step']:>9.3f} {v['share'] * 100:>5.1f}% {v['launches']:>7.0f} "
              f"{v['gbps']:>8.1f} {hbm:>6} {v['tflops']:>8.2f} {peak:>6}  {v['verdict']}")
    print("\n== by kernel family ==")
    for fam, v in r["families"].items():
        print(f"{fam:<14} {v['ms_per_step']:>9.3f} ms/call ({v['share'] * 100:>4.1f}%)")
    print(f"\n== top {len(r['top'])} kernels (instances merged) ==")
    for k in r["top"]:
        print(f"{k['ms_per_step']:>9.3f} ms {k['launches']:>6.0f}x  {k['stage']:<20} "
              f"{k['name'][:56]:<56} {k['op'][:40]}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace", help="a trace file (.json or .json.gz) or a directory")
    p.add_argument("--top", type=int, default=15,
                   help="show the N most expensive kernels")
    p.add_argument("--calls", type=int, default=None,
                   help="the calls the trace holds (default: its ProfilerStep ranges, or 1)")
    p.add_argument("--json", action="store_true",
                   help="print one machine-readable JSON line at the end")
    args = p.parse_args(argv)
    r = analyze(args.trace, args.calls, args.top)
    print_report(r)
    if args.json:
        print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()
