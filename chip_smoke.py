#!/usr/bin/env python3
"""Smoke run of the PyTorch port (efficientdet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # the repository's GPU check
    python3 chip_smoke.py --profile-dir DIR  # also a torch.profiler breakdown
                                             # of three back-to-back batch-128
                                             # calls, with their chrome trace
                                             # written into DIR

Phases, each printing one JSON line (any failure raises, exit code != 0):

1. device: the card's name and power limit (nvidia-smi), the kernels'
   build time (nvcc, one process per source, all at once);
2. head_kernel: csrc/head_pointwise.cu against its plain version at the
   D0@512 batch-16 shapes (class A=9 x 90, box A=1 x 36), bf16 and f32;
   then its time at batch 128 beside its bound and torch.addmm + amax;
3. nms_kernel: csrc/nms_suppress.cu against its plain version, exactly, on
   the JAX package's parity data (B=4, K=1024, 16 classes, seed 0) and on
   B=128 random candidates; its time at B=128;
4. pipeline: D0@512 (90 classes, random weights from seed 0), BN folded,
   three bf16 calls at batch 16 through make_predict_fn with the launch
   counters reset just before; the detections checked; then img/s at
   batch 128 bf16;
5. gpu_vs_cpu: the same model in float32 (TF32 off) on the card and on the
   CPU (which takes the kernels' plain versions) at batch 2: raw head
   outputs, then detections;
6. the kernels line, the card line, and the last line,
   {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: dense peaks and memory rate
HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32_CUDA_CORES = 67e12
# float32 operations of one IoU test in the NMS mask: 2 min, 2 max, 2 sub,
# 2 clamp, 1 mul (intersection), 1 add + 1 sub (union), 1 max, 1 div,
# 1 compare; the areas (per box) are not counted
NMS_OPS_PER_PAIR = 14

D0_PIXELS = 64 * 64 + 32 * 32 + 16 * 16 + 8 * 8 + 4 * 4  # pixel rows per image at 512
CHECK_BATCH = 16   # the kernels against their plain versions; the main-path calls
BENCH_BATCH = 128  # timing: the batch the JAX package's bench.py measures


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device(cuda_build):
    line = card_line()
    t0 = time.perf_counter()
    cuda_build.build(["head_pointwise", "nms_suppress"])
    build_s = time.perf_counter() - t0
    for name, log in cuda_build.build_logs.items():
        print(f"--- nvcc {name} ---\n{log}", file=sys.stderr)
    name, limit = (s.strip() for s in line.split(",", 1))
    emit({"phase": "device", "name": name, "power_limit": limit, "build_s": build_s,
          "registers": _registers(cuda_build.build_logs.values())})
    return line


# the main path's kernel instances (out=90 -> 12 column tiles, out=36 -> 5)
_MAIN_PATH_KERNELS = ("head_pw_mma_kernel<12>", "head_pw_mma_kernel<5>",
                      "nms_mask_kernel", "nms_scan_kernel")


def _registers(logs):
    """Registers per thread of the main path's kernels, from ptxas -v."""
    regs, entry = {}, None
    for log in logs:
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                k = re.search(r"(head_pw_mma_kernel|head_pw_kernel|nms_mask_kernel"
                              r"|nms_scan_kernel)(?:ILi(\d+)E)?", m.group(1))
                entry = k and (f"{k.group(1)}<{k.group(2)}>" if k.group(2) else k.group(1))
                continue
            m = re.search(r"Used (\d+) registers", ln)
            if m and entry in _MAIN_PATH_KERNELS:
                regs[entry] = int(m.group(1))
                entry = None
    return regs


def _head_inputs(rows, cin, n, dtype, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, cin, generator=g).to(dtype).cuda()
    k = (torch.randn(cin, n, generator=g) * cin ** -0.5).cuda()
    b = (torch.randn(n, generator=g) * 0.5 - 2.0).cuda()
    return x, k, b


def phase_head(hk):
    """Kernel vs plain at batch 16; timing at batch 128 (bf16, the main path)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    checks = []
    worst_bf16 = 0.0
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for a, out in ((9, 90), (1, 36)):
            x, k, b = _head_inputs(CHECK_BATCH * D0_PIXELS, 64, a * out, dtype, seed=a)
            z, amax, m = hk.head_pointwise_anchor_major(x, k, b, a)
            zr, ar, _ = hk.head_pointwise_reference(x, k, b, a)
            torch.cuda.synchronize()
            zf, zrf = z.float(), zr.float()
            af, arf = amax.float(), ar.float()
            dz = (zf - zrf).abs()
            da = (af - arf).abs()
            if dtype == torch.bfloat16:
                # the two sum 64 products in another order before rounding:
                # one bf16 ulp relative (2^-7 |ref|), plus 1e-4 for sums
                # that cancel to near zero
                tol_z, tol_a = 2.0 ** -7 * zrf.abs() + 1e-4, 2.0 ** -7 * arf.abs() + 1e-4
                rule = "|d| <= 2^-7 |ref| + 1e-4"
            else:
                tol_z, tol_a = 1e-4 * zrf.abs() + 1e-5, 1e-4 * arf.abs() + 1e-5
                rule = "|d| <= 1e-4 |ref| + 1e-5"
            ok = bool((dz <= tol_z).all() and (da <= tol_a).all())
            rec = {"dtype": name, "A": a, "out": out, "M": m, "Mp": z.shape[1],
                   "max_abs_dz": dz.max().item(), "max_abs_damax": da.max().item(),
                   "tolerance": rule, "ok": ok}
            checks.append(rec)
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, rec["max_abs_dz"], rec["max_abs_damax"])
            if not ok:
                raise AssertionError(f"head kernel disagrees with its plain version: {rec}")
            del x, z, zr, zf, zrf, dz

    timing = []
    for a, out in ((9, 90), (1, 36)):
        x, k, b = _head_inputs(BENCH_BATCH * D0_PIXELS, 64, a * out, torch.bfloat16, seed=7)
        m, cin = x.shape
        mp = m + (-m) % hk.ROW_TILE
        kb = k.bfloat16()
        ms = cuda_ms(lambda: hk.head_pointwise_anchor_major(x, k, b, a))
        plain = cuda_ms(lambda: hk.head_pointwise_reference(x, k, b, a), iters=5, warmup=1)
        bb = b.bfloat16()
        library = cuda_ms(lambda: torch.addmm(bb, x, kb).view(m, a, out).amax(-1))
        nbytes = m * cin * 2 + cin * a * out * 2 + a * out * 4 + a * mp * out * 2 + a * mp * 2
        b_ms, b_by = bound(nbytes, 2.0 * m * cin * a * out, PEAK_BF16)
        timing.append({"A": a, "out": out, "M": m, "ms": ms, "plain_ms": plain,
                       "library_ms": library, "bound_ms": b_ms, "bound_by": b_by,
                       "bytes": nbytes})
        del x
        torch.cuda.empty_cache()
    emit({"phase": "head_kernel", "checks": checks, "bench_bf16": timing})
    return worst_bf16, timing


def _nms_inputs(rng, b, k, classes, span, wh_max):
    import torch

    xy = rng.uniform(0, span, (b, k, 2))
    wh = rng.uniform(10, wh_max, (b, k, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).cuda()
    cls = torch.from_numpy(rng.randint(0, classes, (b, k)).astype(np.int32)).cuda()
    valid = torch.from_numpy(rng.rand(b, k) > 0.1).cuda()
    return boxes, cls, valid


def phase_nms(nk):
    import torch

    cases = {
        "parity_data_B4_K1024": _nms_inputs(np.random.RandomState(0), 4, 1024, 16, 400, 150),
        "random_bench_K1024": _nms_inputs(np.random.RandomState(1), BENCH_BATCH, 1024, 16, 400, 150),
        "dense_B8_K1000": _nms_inputs(np.random.RandomState(2), 8, 1000, 2, 100, 80),
    }
    checks = []
    for name, (boxes, cls, valid) in cases.items():
        got = nk.suppression_keep_mask(boxes, cls, valid, 0.5)
        want = nk.suppression_keep_mask_reference(boxes, cls, valid, 0.5)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        checks.append({"case": name, "kept": int(want.sum()), "valid": int(valid.sum()),
                       "differ": diff})
        if diff:
            raise AssertionError(f"NMS kernel differs from its plain version: {checks[-1]}")
    boxes, cls, valid = cases["random_bench_K1024"]
    b, k = cls.shape
    ms = cuda_ms(lambda: nk.suppression_keep_mask(boxes, cls, valid, 0.5))
    plain = cuda_ms(lambda: nk.suppression_keep_mask_reference(boxes, cls, valid, 0.5),
                    iters=3, warmup=1)
    nbytes = b * k * (16 + 4 + 1) + b * k
    # this data's work: a class compare for every pair j < i, the IoU only
    # for the pairs of one class
    per_class = torch.stack([torch.bincount(c.long(), minlength=16) for c in cls])
    same_class_pairs = int((per_class * (per_class - 1) // 2).sum())
    ops = b * k * (k - 1) / 2 + same_class_pairs * NMS_OPS_PER_PAIR
    b_ms, b_by = bound(nbytes, ops, PEAK_F32_CUDA_CORES)
    timing = {"B": b, "K": k, "ms": ms, "plain_ms": plain, "library_ms": None,
              "bound_ms": b_ms, "bound_by": b_by, "same_class_pairs": same_class_pairs}
    emit({"phase": "nms_kernel", "checks": checks, "bench": timing})
    return timing


def _check_detections(dets, num_classes, batch):
    import torch

    boxes, scores, classes, n = (t.cpu() for t in dets)
    assert boxes.shape == (batch, 100, 4) and scores.shape == (batch, 100)
    assert classes.shape == (batch, 100) and n.shape == (batch,), "detection shapes"
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all(), "non-finite output"
    assert ((n >= 0) & (n <= 100)).all(), "num_valid out of [0, 100]"
    for i in range(batch):
        k = int(n[i])
        s, c = scores[i, :k], classes[i, :k]
        assert ((s > 0) & (s <= 1)).all(), "score out of (0, 1]"
        assert ((c >= 0) & (c < num_classes)).all(), "class out of range"
        assert (scores[i, k:] == -1).all() and (classes[i, k:] == -1).all(), "padding"
    return n


def phase_pipeline(et, hk, nk, card, profile_dir):
    import torch

    model, cfg = et.build_efficientdet(0, num_classes=90, dtype=torch.bfloat16, seed=0)
    model = et.fuse_for_inference(model)
    predict = et.make_predict_fn(model)
    size = cfg.image_size
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (CHECK_BATCH, size, size, 3)).astype(np.uint8)).cuda()

    hk.head_pointwise_anchor_major.launches = 0
    nk.suppression_keep_mask.launches = 0
    calls = 3
    for _ in range(calls):
        dets = predict(images)
        n = _check_detections(dets, cfg.num_classes, CHECK_BATCH)
    torch.cuda.synchronize()
    launches = {"head_pointwise": hk.head_pointwise_anchor_major.launches,
                "nms_suppress": nk.suppression_keep_mask.launches}
    if launches != {"head_pointwise": 2 * calls, "nms_suppress": calls}:
        raise AssertionError(f"the main path did not go through both kernels: {launches}")

    big = torch.from_numpy(rng.randint(0, 256, (BENCH_BATCH, size, size, 3)).astype(np.uint8)).cuda()
    for _ in range(2):
        _check_detections(predict(big), cfg.num_classes, BENCH_BATCH)
    torch.cuda.synchronize()
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        out = predict(big)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _check_detections(out, cfg.num_classes, BENCH_BATCH)
    rec = {"phase": "pipeline", "model": "D0@512, 90 classes, BN folded, bf16",
           "check_batch": CHECK_BATCH, "check_calls": calls, "launches": launches,
           "num_valid": [int(v) for v in n],
           "bench_batch": BENCH_BATCH, "img_s_bf16": steps * BENCH_BATCH / dt,
           "ms_per_call": dt / steps * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    emit(rec)
    if profile_dir:
        emit({"phase": "profile", "bench_batch": BENCH_BATCH,
              **_profile(predict, big, profile_dir, rec["ms_per_call"])})
    del big, images, model
    torch.cuda.empty_cache()
    return launches


def _profile(predict, images, out_dir, ms_per_call, calls: int = 3):
    """Device time by kernel, per call, over ``calls`` back-to-back
    batch-128 calls.

    Idle share twice: against the profiled wall time (the profiler adds host
    work) and against ``ms_per_call``, the unprofiled steady-state time.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            predict(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # kernels only, not the ops around them
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        if dev > 0:
            rows.append((dev / 1e3 / calls, ev.count / calls, ev.key))
    rows.sort(reverse=True)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "pipeline_trace.json"))
    busy = sum(r[0] for r in rows)
    return {"calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy,
            "launches": sum(r[1] for r in rows),
            "idle_share_profiled": max(0.0, 1.0 - busy / wall_ms),
            "idle_share_steady": max(0.0, 1.0 - busy / ms_per_call),
            "top": [{"ms": r[0], "count": r[1], "name": r[2][:100]} for r in rows[:30]]}


def phase_gpu_vs_cpu(et, tn):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = {}
    for dev in ("cuda", "cpu"):
        model, cfg = et.build_efficientdet(0, num_classes=90, dtype=torch.float32,
                                           device=dev, seed=0)
        models[dev] = et.fuse_for_inference(model)
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randint(0, 256, (2, 512, 512, 3)).astype(np.uint8))
    from efficientdet_tpu_torch.ops.preprocess import preprocess_batch_fixed

    outs = {}
    with torch.inference_mode():
        for dev, model in models.items():
            x = preprocess_batch_fixed(images.to(dev))
            (z, amax, hws), (zb, _) = model(x, anchor_major=True)
            outs[dev] = (z.cpu(), amax.cpu(), zb.cpu(), hws)
    heads = {}
    for i, name in enumerate(("z", "amax", "zb")):
        g, c = outs["cuda"][i], outs["cpu"][i]
        scale = c.abs().max().item()
        err = (g - c).abs().max().item()
        # float32 convs in other algorithms and summation orders, through
        # some 90 layers: 1e-4 of the output's scale
        heads[name] = {"max_abs_err": err, "scale": scale, "ok": err <= 1e-4 * scale}
    if not all(h["ok"] for h in heads.values()):
        raise AssertionError(f"card and CPU head outputs differ: {heads}")

    # the same head outputs through the NMS on both devices: exact
    from efficientdet_tpu_torch.anchors import anchors_for_shape

    z, amax, zb, hws = outs["cpu"]
    anchors = torch.from_numpy(anchors_for_shape((512, 512)))
    cpu = tn.batched_filter_from_anchor_major_levels(anchors, (zb, hws), (z, amax, hws), (512, 512))
    gpu = tn.batched_filter_from_anchor_major_levels(
        anchors.cuda(), (zb.cuda(), hws), (z.cuda(), amax.cuda(), hws), (512, 512)
    )
    gpu = [t.cpu() for t in gpu]
    same_heads = {
        "boxes_equal": bool(torch.equal(gpu[0], cpu[0])),
        "classes_equal": bool(torch.equal(gpu[2], cpu[2])),
        "num_valid_equal": bool(torch.equal(gpu[3], cpu[3])),
        "max_abs_dscore": (gpu[1] - cpu[1]).abs().max().item(),
    }
    if not (same_heads["boxes_equal"] and same_heads["classes_equal"]
            and same_heads["num_valid_equal"] and same_heads["max_abs_dscore"] <= 1e-6):
        raise AssertionError(f"NMS on the card differs from the CPU's: {same_heads}")

    # end to end: each card detection has a CPU detection of the same class,
    # box within 0.01 px and score within 1e-4 (ranks of near-equal scores
    # may swap where the head outputs differ in the last digits)
    dets = {dev: [t.cpu() for t in et.make_predict_fn(m)(images.to(dev))]
            for dev, m in models.items()}
    matched = total = 0
    for i in range(images.shape[0]):
        kg, kc = int(dets["cuda"][3][i]), int(dets["cpu"][3][i])
        total += kg
        for j in range(kg):
            hit = ((dets["cpu"][2][i, :kc] == dets["cuda"][2][i, j])
                   & ((dets["cpu"][0][i, :kc] - dets["cuda"][0][i, j]).abs().amax(-1) <= 1e-2)
                   & ((dets["cpu"][1][i, :kc] - dets["cuda"][1][i, j]).abs() <= 1e-4))
            matched += int(hit.any())
    end_to_end = {"num_valid_cuda": [int(v) for v in dets["cuda"][3]],
                  "num_valid_cpu": [int(v) for v in dets["cpu"][3]],
                  "matched": matched, "total": total}
    if not torch.equal(dets["cuda"][3], dets["cpu"][3]) or matched < 0.98 * total:
        raise AssertionError(f"card and CPU detections differ: {end_to_end}")
    emit({"phase": "gpu_vs_cpu", "batch": 2, "dtype": "float32, TF32 off",
          "head_outputs": heads, "nms_same_heads": same_heads, "end_to_end": end_to_end})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-dir", default=None,
                        help="profile three batch-128 calls; write their trace here")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import efficientdet_tpu_torch as et
    import efficientdet_tpu_torch.ops.head_kernel as hk
    import efficientdet_tpu_torch.ops.nms as tn
    import efficientdet_tpu_torch.ops.nms_kernel as nk
    from efficientdet_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = phase_device(cuda_build)
    head_err, head_t = phase_head(hk)
    nms_t = phase_nms(nk)
    launches = phase_pipeline(et, hk, nk, card, args.profile_dir)
    phase_gpu_vs_cpu(et, tn)

    def total(key):
        return sum(t[key] for t in head_t)

    emit({"kernels": [
        {"name": "head_pointwise", "route": "cuda",
         "source": "efficientdet_tpu_torch/csrc/head_pointwise.cu",
         "replaces": "efficientdet_tpu/ops/head_pallas.py:46",
         "launches": launches["head_pointwise"], "max_abs_err": head_err,
         "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
         "bound_by": head_t[0]["bound_by"], "library_ms": total("library_ms")},
        {"name": "nms_suppress", "route": "cuda",
         "source": "efficientdet_tpu_torch/csrc/nms_suppress.cu",
         "replaces": "efficientdet_tpu/ops/nms_pallas.py:34",
         "launches": launches["nms_suppress"], "max_abs_err": 0.0,
         "ms": nms_t["ms"], "plain_ms": nms_t["plain_ms"], "bound_ms": nms_t["bound_ms"],
         "bound_by": nms_t["bound_by"], "library_ms": None},
    ], "note": "ms, plain_ms, bound_ms, library_ms per main-path call at batch 128 "
               "(head_pointwise: the class and the box launch together)",
        "elapsed_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
