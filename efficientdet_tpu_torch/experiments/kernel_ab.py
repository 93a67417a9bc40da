"""Same-card A/B of two checkouts on the port's kernels and the main path's img/s.

    python3 -m efficientdet_tpu_torch.experiments.kernel_ab --base DIR [--pairs 5] [--out FILE]

DIR is another checkout of the repository, for example its parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Each run is a fresh process in one tree that builds that tree's head, NMS
and fused-MBConv kernels and measures them with the harness below, the same
for both trees: the head kernel's class (A 9, out 90) and box (A 1, out 36) launches
on D0@512 batch-128 rows in bf16, the weights passed as the heads pass them;
the NMS kernel on random B 128, K 1024, 16-class candidates (chip_smoke.py's
``random_bench_K1024``); each as the wrapper call's ms (CUDA events over 20
calls) and the kernel's device ms (torch.profiler); the fused MBConv kernel at the six
``BLOCKS`` of experiments/packed_mbconv.py in its three layouts (``mb_<block>_
<layout>_ms`` the call over 10 calls, ``_device_ms`` its launches alone, their
sums over the blocks as ``mb_sum_*``), the port's unfused block there
(``mb_<block>_module_ms``), and every route of the D0 and D4 stages-1-3
chains against the block chain (``chain_<name>_baseline_ms``,
``chain_<name>_route<i>_ms``, experiments/packed_chain.run_chain, 10 steps);
then the D0@512 bf16 pipeline's img/s at batch 128 (10 calls after 2). The runs take turns on
one GPU: base, this, this, base, base, this, ... (``--pairs`` runs of each
tree). Printed, and written to ``--out`` if given: every run's numbers, and per tree
their median and spread ((max - min) / median), with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# one run in a tree; executed with the tree's root as the working directory
_RUN = r"""
import json, subprocess, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
import efficientdet_tpu_torch as et
import efficientdet_tpu_torch.ops.head_kernel as hk
import efficientdet_tpu_torch.ops.mbconv_kernel as mk
import efficientdet_tpu_torch.ops.nms_kernel as nk
from efficientdet_tpu_torch.experiments import packed_chain as pc
from efficientdet_tpu_torch.experiments import packed_mbconv as pm
from efficientdet_tpu_torch.ops import cuda_build

cuda_build.build(["head_pointwise", "nms_suppress", "fused_mbconv"])


def event_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name, calls=5):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    tot = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and name in ev.key:
            dev = getattr(ev, "self_device_time_total", None)
            tot += (ev.self_cuda_time_total if dev is None else dev) / 1e3 / calls
    return tot


rec = {}
rows = 128 * (64 * 64 + 32 * 32 + 16 * 16 + 8 * 8 + 4 * 4)
for a, out, key in ((9, 90, "head_class"), (1, 36, "head_box")):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(rows, 64, generator=g).bfloat16().cuda()
    k = (torch.randn(64, a * out, generator=g) * 0.125).cuda()
    b = (torch.randn(a * out, generator=g) * 0.5 - 2.0).cuda()
    k = k.bfloat16().t().contiguous().t()  # the transposed view of a bf16 conv weight
    call = lambda: hk.head_pointwise_anchor_major(x, k, b, a)
    rec[key + "_ms"] = event_ms(call)
    rec[key + "_device_ms"] = device_ms(call, "head_pw")
    del x
    torch.cuda.empty_cache()

rng = np.random.RandomState(1)
xy = rng.uniform(0, 400, (128, 1024, 2))
wh = rng.uniform(10, 150, (128, 1024, 2))
boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).cuda()
cls = torch.from_numpy(rng.randint(0, 16, (128, 1024)).astype(np.int32)).cuda()
valid = torch.from_numpy(rng.rand(128, 1024) > 0.1).cuda()
call = lambda: nk.suppression_keep_mask(boxes, cls, valid, 0.5)
rec["nms_ms"] = event_ms(call)
rec["nms_device_ms"] = device_ms(call, "nms_")

del boxes, cls, valid
with torch.inference_mode():
    for name, shape in pm.BLOCKS.items():
        block, _ = pm.torch_block(shape, torch.bfloat16, device="cuda")
        packed = pm.pack_params(block)
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((shape.batch, shape.hw, shape.hw, shape.cin), generator=gen,
                        device="cuda").bfloat16()
        xp, xrp, mask = mk.pack_x(x), mk.pack_rp(x), mk.rp_mask(shape.hw, torch.bfloat16, "cuda")
        xnchw = xp.view(shape.batch, shape.cin, shape.hw, shape.hw)
        calls = {"packed": lambda: mk.packed_mbconv(xp, packed, shape),
                 "rp": lambda: mk.packed_mbconv_rp(xrp, mask, packed, shape),
                 "nhwc": lambda: mk.fused_mbconv_nhwc(x, packed, shape.ksize, shape.has_skip)}
        for layout, call in calls.items():
            rec[f"mb_{name}_{layout}_ms"] = event_ms(call, iters=10)
            rec[f"mb_{name}_{layout}_device_ms"] = device_ms(call, "mbconv_", calls=3)
        rec[f"mb_{name}_module_ms"] = event_ms(lambda: block(xnchw), iters=10)
        del x, xp, xrp, xnchw, block, packed
        torch.cuda.empty_cache()
for key in ("packed_ms", "rp_ms", "nhwc_ms", "packed_device_ms", "rp_device_ms", "nhwc_device_ms",
            "module_ms"):
    rec["mb_sum_" + key] = sum(rec[f"mb_{name}_{key}"] for name in pm.BLOCKS)
for spec in (pc.D0_CHAIN, pc.D4_CHAIN):
    chain = pc.run_chain(spec, steps=10)
    rec[f"chain_{spec.name}_baseline_ms"] = chain["baseline_ms"]
    for i, route in enumerate(chain["routes"]):
        rec[f"chain_{spec.name}_route{i}_ms"] = route["ms"]
    torch.cuda.empty_cache()

model, cfg = et.build_efficientdet(0, num_classes=90, dtype=torch.bfloat16, seed=0)
predict = et.make_predict_fn(et.fuse_for_inference(model))
images = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (128, 512, 512, 3)).astype(np.uint8)).cuda()
for _ in range(2):
    predict(images)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(10):
    predict(images)
torch.cuda.synchronize()
rec["pipeline_img_s"] = 10 * 128 / (time.perf_counter() - t0)
rec["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(json.dumps(rec), flush=True)
"""


def run_tree(root: str) -> dict:
    """One run of the harness in ``root``: the metrics and the card line."""
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def summarize(runs):
    out = {}
    for key in (k for k, v in runs[0].items() if isinstance(v, float)):
        vals = [r[key] for r in runs]
        med = statistics.median(vals)
        out[key] = {"runs": vals, "median": med, "spread": (max(vals) - min(vals)) / med}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", required=True, help="the other checkout's root")
    parser.add_argument("--pairs", type=int, default=5)
    parser.add_argument("--out", default=None, help="also write the result to this JSON file")
    args = parser.parse_args()

    trees = {"base": os.path.abspath(args.base), "this": ROOT}
    runs = {"base": [], "this": []}
    order = []
    for i in range(args.pairs):
        order += ["base", "this"] if i % 2 == 0 else ["this", "base"]
    for name in order:
        rec = run_tree(trees[name])
        runs[name].append(rec)
        print(json.dumps({"tree": name, **rec}), flush=True)
    cards = sorted({r["card"] for rs in runs.values() for r in rs})
    result = {"order": order, "cards": cards,
              "summary": {name: summarize(rs) for name, rs in runs.items()}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
