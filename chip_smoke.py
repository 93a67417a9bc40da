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
6. mbconv_kernels: csrc/fused_mbconv.cu's three launchers (packed, row-
   padded, NHWC) against their plain versions in f32 and bf16, on the JAX
   tests' tiny cases and the D0 blocks at batch 2, the row-padded output's
   gap lanes exactly 0; then the per-block harness at the recorded D0
   (batch 128) and D4 (batch 16) shapes: each kernel against its plain
   version there (bf16, the same tolerance, rp gaps exactly 0), then its ms
   beside its bound, its plain version's and the port's unfused
   MBConvBlock's (module_ms);
7. chain: D0's stages 1-3 at batch 128 and D4's at batch 16, every route
   against the block chain (bf16): ms, speedup, error, and one packed-kernel
   launch per 'pallas' block per call;
8. tap_floor: csrc/tap_floor.cu against its plain version, then the FMA
   rates (f32/bf16 x chains 1/4), the f32 swish rate, the 1x1 products'
   ms, and the stages-1-3 floor against the chain phase's D0 baseline and
   the pipeline phase's ms per call;
9. the kernels line, the card line, and the last line,
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

from efficientdet_tpu_torch.experiments.timing import (
    HBM_BYTES_S,
    PEAK_BF16,
    PEAK_F32_CUDA_CORES,
    bound,
    cuda_ms,
)

ROOT = os.path.dirname(os.path.abspath(__file__))

# float32 operations of one IoU test in the NMS mask: 2 min, 2 max, 2 sub,
# 2 clamp, 1 mul (intersection), 1 add + 1 sub (union), 1 max, 1 div,
# 1 compare; the areas (per box) are not counted
NMS_OPS_PER_PAIR = 14

SOURCES = ["head_pointwise", "nms_suppress", "fused_mbconv", "tap_floor"]
D0_PIXELS = 64 * 64 + 32 * 32 + 16 * 16 + 8 * 8 + 4 * 4  # pixel rows per image at 512
# the JAX tests' tiny MBConv cases (name, batch, side, cin, cexp, cout, k, se)
MBCONV_TINY = [("tiny_exp_skip", 2, 16, 8, 48, 8, 3, 2),
                      ("tiny_noexp", 2, 16, 8, 8, 4, 3, 2),
                      ("tiny_k5", 2, 8, 8, 24, 8, 5, 2)]
MBCONV_STEPS = 10  # timed calls per kernel and block (the plain version: a fifth)
CHAIN_STEPS = 10
FLOOR_REPEATS = 512
FLOOR_STEPS = 10
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


def phase_device(cuda_build):
    line = card_line()
    t0 = time.perf_counter()
    cuda_build.build(SOURCES)
    build_s = time.perf_counter() - t0
    for name, log in cuda_build.build_logs.items():
        print(f"--- nvcc {name} ---\n{log}", file=sys.stderr)
    name, limit = (s.strip() for s in line.split(",", 1))
    regs, spills = _registers(cuda_build.build_logs.values())
    emit({"phase": "device", "name": name, "power_limit": limit, "build_s": build_s,
          "registers": regs, "spill_store_bytes": spills})
    return line


# the kernels whose ptxas report the device line carries, every instance
_MAIN_PATH_KERNELS = ("head_pw_mma_kernel", "head_pw_kernel", "nms_mask_kernel",
                      "nms_scan_kernel", "mbconv_pool_kernel", "mbconv_se_kernel",
                      "mbconv_proj_kernel", "tap_floor_fma_f32", "tap_floor_fma_bf16",
                      "tap_floor_swish_f32")


def _demangle(mangled):
    """``name<args>`` of a mangled kernel name, or None if not one of ours."""
    m = re.search("|".join(f"{len(k)}{k}" for k in _MAIN_PATH_KERNELS), mangled)
    if not m:
        return None
    name = m.group().lstrip("0123456789")
    rest = mangled[m.end():]
    if not rest.startswith("I"):
        return name
    rest = rest[1:]
    args, i = [], 0
    while i < len(rest) and rest[i] != "E":
        if rest[i] == "L":  # literal: L <type letter> <value> E
            j = rest.index("E", i)
            args.append(rest[i + 2:j])
            i = j + 1
        elif rest[i].isdigit():  # length-prefixed type name
            n = re.match(r"\d+", rest[i:]).group()
            i += len(n)
            args.append(rest[i:i + int(n)])
            i += int(n)
        else:  # builtin type letter
            args.append({"f": "float"}.get(rest[i], rest[i]))
            i += 1
    return f"{name}<{','.join(args)}>"


def _registers(logs):
    """Registers per thread and spill-store bytes of each kernel instance, from ptxas -v."""
    regs, spills, entry = {}, {}, None
    for log in logs:
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = _demangle(m.group(1))
                continue
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m and entry and int(m.group(1)):
                spills[entry] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", ln)
            if m and entry:
                regs[entry] = int(m.group(1))
                entry = None
    return regs, spills


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
    return launches, rec["ms_per_call"]


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


def phase_mbconv(mk, pm):
    """The three launchers vs their plain versions at small shapes; then the
    per-block harness, which holds them against their plain versions again
    at every BLOCKS shape (D0 at batch 128, D4 at 16) before timing them."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [pm.BlockShape(*c) for c in MBCONV_TINY] + [pm.BLOCKS[n]._replace(batch=2) for n in ("d0s1", "d0s2b1", "d0s3b1")]
    checks, worst = [], {"packed": 0.0, "rp": 0.0, "nhwc": 0.0}
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for shape in cases:
            block, _ = pm.torch_block(shape, dtype, device="cuda")
            packed = pm.pack_params(block)
            gen = torch.Generator(device="cuda").manual_seed(1)
            x = torch.randn((shape.batch, shape.hw, shape.hw, shape.cin), generator=gen,
                            device="cuda").to(dtype)
            mask = mk.rp_mask(shape.hw, dtype, "cuda")
            xp, xrp = mk.pack_x(x), mk.pack_rp(x)
            pairs = {
                "packed": (mk.packed_mbconv(xp, packed, shape),
                           mk.packed_mbconv_reference(xp, packed, shape)),
                "rp": (mk.packed_mbconv_rp(xrp, mask, packed, shape),
                       mk.packed_mbconv_rp_reference(xrp, mask, packed, shape)),
                "nhwc": (mk.fused_mbconv_nhwc(x, packed, shape.ksize, shape.has_skip),
                         mk.fused_mbconv_nhwc_reference(x, packed, shape.ksize, shape.has_skip)),
            }
            torch.cuda.synchronize()
            gap = (pairs["rp"][0].float() * (1 - mask.float())).abs().max().item()
            rec = {"dtype": dname, "shape": shape.name, "batch": shape.batch, "rp_gap_max": gap}
            for name, (got, ref) in pairs.items():
                rec[name] = pm.check_kernel(got, ref, dtype)
                worst[name] = max(worst[name], rec[name]["max_abs_err"])
            checks.append(rec)
            if gap != 0.0 or not all(rec[n]["ok"] for n in pairs):
                raise AssertionError(f"fused MBConv kernel disagrees with its plain version: {rec}")

    # the per-block harness: its run is the rp and NHWC launchers' main path
    for fn in (mk.packed_mbconv, mk.packed_mbconv_rp, mk.fused_mbconv_nhwc):
        fn.launches = 0
    blocks = []
    for name, shape in pm.BLOCKS.items():
        rec = pm.run_block(shape, steps=MBCONV_STEPS)
        for layout in ("packed", "rp", "nhwc"):
            worst[layout] = max(worst[layout], rec["vs_plain"][layout]["max_abs_err"])
        blocks.append(rec)
        torch.cuda.empty_cache()
    launches = {"packed": mk.packed_mbconv.launches, "rp": mk.packed_mbconv_rp.launches,
                "nhwc": mk.fused_mbconv_nhwc.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"the block harness did not launch every layout: {launches}")
    emit({"phase": "mbconv_kernels", "checks": checks, "blocks": blocks,
          "harness_launches": launches, "steps": MBCONV_STEPS})
    return worst, blocks, launches


def phase_chain(mk, pc):
    """Every route of the D0 and D4 chains against the block chain."""
    import torch

    mk.packed_mbconv.launches = 0
    out, expected = [], 0
    for spec in (pc.D0_CHAIN, pc.D4_CHAIN):
        rec = pc.run_chain(spec, steps=CHAIN_STEPS)
        # one check call, three warm-up calls and the timed ones, per route
        expected += sum(r.count("pallas") for r in spec.routes) * (4 + CHAIN_STEPS)
        out.append(rec)
        torch.cuda.empty_cache()
    launches = mk.packed_mbconv.launches
    if launches != expected:
        raise AssertionError(f"the chains launched the packed kernel {launches} times, not {expected}")
    emit({"phase": "chain", "chains": out, "packed_launches": launches, "steps": CHAIN_STEPS})
    return out, launches


def phase_tap_floor(tk, tf, chain_d0_ms, d0_ms):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    x32 = torch.rand((64, 1024), generator=gen, device="cuda") * 2 - 1
    checks, worst = [], 0.0
    for op, dtype, taps in (("fma", torch.float32, 9), ("fma", torch.float32, 3),
                            ("fma", torch.bfloat16, 9), ("swish", torch.float32, 1)):
        for chains in (1, 4):
            x = x32.to(dtype)
            got = tk.tap_floor(x, op, taps, 2, chains).float()
            ref = tk.tap_floor_reference(x, op, taps, 2, chains).float()
            d = (got - ref).abs()
            if dtype == torch.float32:
                # an fmaf rounds once where the plain version multiplies, then adds
                tol, rule = 1e-5 * ref.abs() + 1e-6, "|d| <= 1e-5 |ref| + 1e-6"
            else:
                # a float32 sum rounded to bf16 may tie another way than __hfma2
                tol, rule = 2.0 ** -6 * ref.abs() + 1e-3, "|d| <= 2^-6 |ref| + 1e-3"
            rec = {"op": op, "dtype": str(dtype).split(".")[-1], "taps": taps, "chains": chains,
                   "repeats": 2, "max_abs_err": d.max().item(), "tolerance": rule,
                   "ok": bool((d <= tol).all())}
            checks.append(rec)
            worst = max(worst, rec["max_abs_err"])
            if not rec["ok"]:
                raise AssertionError(f"tap floor kernel disagrees with its plain version: {rec}")

    tk.tap_floor.launches = 0
    floor = tf.measure_floor(repeats=FLOOR_REPEATS, steps=FLOOR_STEPS, device="cuda")
    launches = tk.tap_floor.launches
    if launches == 0:
        raise AssertionError("the floor harness did not launch the floor kernel")
    n = tf.ROWS * tf.COLS
    fmas = float(n) * FLOOR_REPEATS * 9
    for r in floor["rates"]:
        if r["op"] == "fma":
            # bf16 at the CUDA cores' paired rate (2 FMAs per __hfma2, 134 TFLOP/s)
            peak = PEAK_F32_CUDA_CORES * (2 if r["dtype"] == "bf16" else 1)
            r["bound_ms"], r["bound_by"] = bound(n * (8 if r["dtype"] == "f32" else 4),
                                                 2 * fmas, peak)
    main = next(r for r in floor["rates"] if (r["op"], r["dtype"], r["chains"]) == ("fma", "f32", 4))
    x = torch.ones((tf.ROWS, tf.COLS), device="cuda")
    plain = cuda_ms(lambda: tk.tap_floor_reference(x, "fma", 9, FLOOR_REPEATS, 4), iters=1, warmup=0)
    ceiling = tf.ceiling_from_rates(floor["tap_fma_g_s"], floor["swish_g_s"], floor["t_mm_ms"],
                                    HBM_BYTES_S, chain_d0_ms, d0_ms)
    emit({"phase": "tap_floor", "checks": checks, "repeats": FLOOR_REPEATS, **floor,
          "harness_launches": launches, "plain_ms_f32_chains4": plain,
          "ceiling": ceiling})
    return worst, main, plain, launches


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
    import efficientdet_tpu_torch.ops.mbconv_kernel as mk
    import efficientdet_tpu_torch.ops.tap_floor_kernel as tk
    from efficientdet_tpu_torch.experiments import packed_chain as pc
    from efficientdet_tpu_torch.experiments import packed_mbconv as pm
    from efficientdet_tpu_torch.experiments import tap_floor as tf
    from efficientdet_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = phase_device(cuda_build)
    head_err, head_t = phase_head(hk)
    nms_t = phase_nms(nk)
    launches, ms_per_call = phase_pipeline(et, hk, nk, card, args.profile_dir)
    phase_gpu_vs_cpu(et, tn)
    mb_err, mb_blocks, harness = phase_mbconv(mk, pm)
    chains, chain_launches = phase_chain(mk, pc)
    floor_err, floor, floor_plain, floor_launches = phase_tap_floor(
        tk, tf, chains[0]["baseline_ms"], ms_per_call)

    def total(key):
        return sum(t[key] for t in head_t)

    def mbconv_row(layout, replaces, n):
        def tot(key):
            return sum(b[f"{layout}_{key}"] for b in mb_blocks)

        by_bytes = sum(b[f"{layout}_bound_ms"] for b in mb_blocks if b[f"{layout}_bound_by"] == "bytes")
        return {"name": f"fused_mbconv_{layout}", "route": "cuda",
                "source": "efficientdet_tpu_torch/csrc/fused_mbconv.cu", "replaces": replaces,
                "launches": n, "max_abs_err": mb_err[layout], "ms": tot("ms"),
                "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
                "bound_by": "bytes" if 2 * by_bytes >= tot("bound_ms") else "operations",
                "library_ms": None, "module_ms": sum(b["module_ms"] for b in mb_blocks)}

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
        mbconv_row("packed", "experiments/packed_mbconv_pallas.py:201", chain_launches),
        mbconv_row("rp", "experiments/packed_mbconv_pallas.py:360", harness["rp"]),
        mbconv_row("nhwc", "experiments/mbconv_pallas.py:52", harness["nhwc"]),
        {"name": "tap_floor", "route": "cuda", "source": "efficientdet_tpu_torch/csrc/tap_floor.cu",
         "replaces": "experiments/vpu_tap_floor.py:85", "launches": floor_launches,
         "max_abs_err": floor_err, "ms": floor["kernel_ms"], "plain_ms": floor_plain,
         "bound_ms": floor["bound_ms"], "bound_by": floor["bound_by"], "library_ms": None},
    ], "note": "head_pointwise, nms_suppress: ms per main-path call at batch 128 (head: the "
               "class and the box launch together), launches over 3 pipeline calls. "
               "fused_mbconv_*: ms summed over the six BLOCKS shapes (D0 at batch 128, D4 at 16), "
               "bf16, module_ms the port's unfused MBConvBlock there; launches: packed over the "
               "chain phase, rp and nhwc over the block harness. tap_floor: f32, taps 9, "
               "chains 4, repeats 512 over 4 Mi elements; launches over the floor harness.",
        "elapsed_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
