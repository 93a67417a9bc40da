#!/usr/bin/env python3
"""Smoke run of the PyTorch port (efficientdet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # the repository's GPU check
    python3 chip_smoke.py --profile-dir DIR  # also a torch.profiler breakdown
                                             # of three back-to-back batch-128
                                             # calls and of two training steps,
                                             # with their chrome traces
                                             # written into DIR

Phases, each printing one JSON line (any failure raises, exit code != 0):

1. device: the card's name and power limit (nvidia-smi), the kernels'
   build time (nvcc, one process per source, all at once);
2. head_kernel: csrc/head_pointwise.cu against its plain version at the
   D0@512 batch-16 shapes (class A=9 x 90, box A=1 x 36), bf16 and f32;
   then, in bf16, the bf16 kernels' edges: a row count that is not a
   multiple of 128 (the tail tile, past the end of x); on the streamed
   plan every phi's Cin (88, not a multiple of the K chunk, 112, 160, 224,
   288 and the D6/D7 width 384) at 3000 rows, 77 rows (under one tile) at
   Cin 88 and 384, 1024 rows (whole tiles) at Cin 160 and 384, and the
   tail tile at Cin 384, and at Cin 160 the odd widths out 91 and 21 and
   the widest, out 128; every case twice, the two launches equal bit for
   bit, and on the streamed plan streamed_smem_bytes against the kernel's
   own count; then its time at batch 128 (the call's ms by CUDA events, the
   kernel's device_ms by torch.profiler, the weights passed as the heads
   pass them) beside its bound and torch.addmm + amax;
3. nms_kernel: csrc/nms_suppress.cu against its plain version, exactly, on
   the JAX package's parity data (B=4, K=1024, 16 classes, seed 0), on
   B=128 random candidates, on 2-class dense data (K=1000), on candidates
   shaped like the main path's (B=16, K=1024, 90 classes, several classes
   per box), on K=40 (fewer than one mask word) and at the largest K the
   shared memory holds (B=2), at IoU threshold 0.5, and the parity data
   also at 0 and -0.1; the wrapper's shared-memory count against the
   kernel's layout; its time at B=128 (ms and device_ms, as for the head);
4. pipeline: D0@512 (90 classes, random weights from seed 0), BN folded,
   three bf16 calls at batch 16 through make_predict_fn with the launch
   counters reset just before (2 head, 1 NMS, 32 conv epilogue launches
   a call, 4 of them padded, 16 depthwise and 24 BiFPN node launches); the detections
   checked; then img/s at batch 128 bf16;
5. gpu_vs_cpu: the same model in float32 (TF32 off) on the card and on the
   CPU (which takes the kernels' plain versions) at batch 2: raw head
   outputs, then detections;
6. mbconv_kernels: csrc/fused_mbconv.cu's three launchers (packed, row-
   padded, NHWC) against their plain versions in f32 and bf16, on the JAX
   tests' tiny cases, the kernel's edges (MBCONV_EDGES) and the D0 blocks at
   batch 2, the row-padded output's gap lanes exactly 0 (x's own values
   under a skip) and two runs equal bit for bit; the wrapper's shared-memory
   count against the kernel's plan; then the per-block harness at the recorded D0
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
9. conv_epilogue: the folded backbone's two ops (experiments/folded_ops.py)
   on the inputs of each of their calls in one folded D0@512 backbone
   forward in float32 at batch 16, and in one in bf16 at batch 128; here
   csrc/conv_epilogue.cu against its twin (ATen's add, silu, add and pad):
   float32 bit for bit, bf16 within one ulp of the twin run in float32 and
   rounded once; 32 calls a forward, 4 of them padded; then at those
   batch-128 shapes the launch's ms, the kernel's device ms, the twin's ms
   and the bound of its bytes;
9b. depthwise_conv: csrc/depthwise_conv.cu against its twin (cuDNN's
   depthwise conv in float32, bias and SiLU; the SE sums against the
   kernel's own outputs summed by ATen) on the inputs of every depthwise
   call of a folded backbone forward (D0's two forwards from phase 9):
   D0@512 in float32 at batch 16 within the stated bound, D0@512 b128,
   D4@1024 b64 (its 2.43e9-element stage-2 input included) and D7x@1536
   b16 in bf16, at the benchmark's batches, within it and within one ulp
   of the twin rounded once; 16, 32 and 55
   launches a forward, 32, 63 and 107 epilogue launches; then at the
   benchmark's batches each call's ms, the kernel's device ms, cuDNN's
   conv and the epilogue after it (library_ms), the SE's mean, and the
   bound of its bytes;
9c. bifpn_node: csrc/bifpn_node.cu against its twin run in float32 (the
   moved input's nearest upsample or SAME max-pool, the plain or weighted
   sum and SiLU) on the inputs of every BiFPN node call of a folded
   forward: D0@512 in float32 at batch 16 within a few float32 ulps (the
   stated allowance), D0@512 b128, D4@1024 b64 and D7x@1536 b16 in bf16
   within one ulp of the twin rounded once; 24, 56 and 80 launches a
   forward; then at those batches each call's ms, the kernel's device ms,
   ATen's resample and fusion (library_ms) and the bound of its bytes;
   then portbench/readings_levels.py on d7x-b16 (one seed's levels P3..P8
   against the float32 reference, the fp8 control beside);
10. predictor: Predictor(phi=0) in f32 and bf16 at five source shapes
   (480x640, 640x480, 512x512, 1080x1920, 300x200): each shape's CUDA graph
   replay equal to the eager call on two images, ms per image (median of
   20) for the replay and for eager, the graphs' pool memory, the kernels
   of one replay by torch.profiler; the card against the CPU in f32 (TF32
   off) at 480x640; a ninth shape evicts the oldest graph; 8 threads
   sharing one instance at two source shapes, each answer equal to eager()
   of its own image;
11. serve: BatchingPredictor over D0@512 bf16, BN folded, batch 32,
   max_delay 5 ms, pipeline depth 2; warmup() captures the buckets 1..32;
   lone requests and a full bucket equal predict_pipeline on the same
   canvases; both kernels in the profile of one bucket's replay; then a
   closed loop of C client threads calling predict_sync on 480x640 images
   for 2 s at C = 64 with the default intra-op threads, then with one (as
   serve.main sets it) at C = 1, 8, 32, 64, and at C = 32 with warmup()
   called over and over alongside: img/s, p50/p95/p99 ms, overloads; every
   answer equal to predict_pipeline's detections of its source at one of
   the bucket sizes; one POST of a PNG to a live make_http_server: a
   status line, 501 on a host without PIL, else 200 with
   predict_pipeline's detections;
12. export: D0@512 bf16, BN folded, batch 32 exported to a .edz artifact
   on the card (export.save_exported: torch.export of the whole pipeline,
   the head and NMS kernels as torch.library ops, the weights as program
   inputs): export and load seconds, artifact, program and weights MB, the
   kernels' launches in one artifact call (2 and 1); the loaded program
   eager and as a CUDA graph replay against predict_pipeline on the same
   fused model (counts and classes exact, boxes 1e-3 px, scores 1e-5;
   whether bit for bit), ms per call (median of 10) for the three and the
   host ms of an eager call; a fresh python3 that loads the artifact with
   model building made to raise, runs one batch and hands the detections
   back through numpy; a slim artifact exported on the CPU, loaded onto the
   card and onto the CPU (the gpu_vs_cpu rule); BatchingPredictor.
   from_artifact closed loops of 1 s at C = 1 and 64 on 480x640 sources,
   every answer equal to predict_pipeline's detections of its source;
13. train: the training step (train_lib.make_train_step) at D0@512, batch
   64, TrainConfig defaults, on the JAX package's tools/bench_train.py
   batch (seed 0, 12 boxes an image), in float32 (TF32 off), bf16, and
   float32 with remat: 2 warm-up and 10 timed steps, img/s, ms/step, peak memory, every step's
   loss and gradient norm (finite, the 10th timed loss below the 1st), the
   launch counters set to 0 before and read after (the training path runs
   none of the port's kernels); one float32 step of the slim model on the
   card against the CPU; the trained state through CheckpointManager and
   Predictor.from_checkpoint (replay == eager() == the in-memory model);
   the trained weights folded through the main path (both kernels);
   with --profile-dir, two profiled float32 steps (kernels and ATen
   operators by device time, the trace as train_trace.json.gz);
14. data: 256 numpy images over the predictor phase's five shapes (1-20
   boxes of 16-256 px, 90 classes, seed 0): batch_iterator's ms per batch
   of 64 at 512 px with workers 0, with 8 workers and the default intra-op
   threads, with 8 workers and one, and with the host augmenter; the
   DeviceDataCache pool equal to batch_iterator's canvases bit for bit, its
   MB and get_batch's ms; the device augmenter at batch 64 (ms, device ms,
   the card against the CPU on the same matrices and colour factors, two
   card runs equal); the native IoU library built and equal to numpy;
15. train_cli: train.train_from_datasets (the CLI's loop) at D0@512 batch 64
   f32 (TF32 off), 2 epochs of 5 steps, in four configurations: (a)
   --workers 0, (b) --workers 8, (c) --random-transform --workers 8, (d)
   --device-cache 256 --device-augment with the epoch-end COCO evaluation on
   64 images and --reduce-lr-patience 1: ms/step and img/s after the first
   two steps (an epoch's first step, which follows its evaluation, apart),
   the idle share of two profiled steps, every loss and gradient norm
   finite and the last loss below the first; in (d) the head and NMS
   kernels launched by the evaluation, the plateau's LR cut, the snapshots;
   then the evaluation once more with its host and card time apart, an
   oracle predict function at AP 1.0 through collect_detections, and
   evaluate.py's function on (d)'s snapshots giving the same AP; then
   train.main on a CSV dataset of PNG files where PIL or cv2 imports;
16. parallel: data and spatial parallelism (parallel/). In this process,
   NCCL at world size 1, D0@512: make_sharded_predict_fn (bf16, BN folded,
   batch 128) equal to make_predict_fn bit for bit, with img/s beside the
   plain call's and phase pipeline's; make_sharded_train_step (f32, TF32
   off, batch 64) against make_train_step (the tier-1 step tolerances,
   whether bit for bit), ms/step beside the plain step's and phase train's;
   the spatial predict and step against the serial ones. Then two gloo ranks
   on the card through parallel/launch.py: the sharded step on a global
   batch of 16 and a spatial step on 2 images against the one-process steps
   (parallel/tolerances.py; the raw gradients against a float64 one-process
   step, and both steps again in float64 against it at FLOAT64_SCALE of the
   tolerances), make_spatial_predict_fn (f32, batch 2) against
   predict_pipeline (counts and classes exact, boxes 1e-3 px, scores 1e-5),
   the spatial eval-mode gradients against the serial ones (rtol 1e-4, atol
   1e-6), each rank's peak memory beside one process's, a DeviceDataCache of
   37 images split over the ranks against the unsharded cache; one record a
   check, the phase's seconds and the head and NMS launches;
17. family: D1-D7 (the JAX package's bench_phi for every phi), each at its
   own resolution, 90 classes, weights drawn with numpy from the seed phi
   at conv variance 1 / fan-in (experiments/drawn_weights.py, FAMILY_GAIN:
   well conditioned at every phi), BN folded, bf16, "anchor_major", at
   FAMILY_BATCH: one call with the launch counters
   at 0 (2 head and 1 NMS launch) and the kernels' inputs recorded, img/s
   over 5 calls after 2 warm-up ones, peak memory, the head kernel's plan
   and both kernels against their plain versions on that call's inputs
   (head: one bf16 ulp; NMS: exact), the class and box launches' ms (the
   call) and device ms (the bare launch, head_kernel.launch_into), both by
   CUDA events, beside the bound, the plain version and torch.addmm + amax
   there (the class launch must beat addmm + amax), FLOPs an image and an
   MFU (both counting convolutions and matrix products only), and the card against
   the CPU in float32 (TF32 off) at batch 1 on the same weights (the
   gpu_vs_cpu rule); D0's MFU from the pipeline phase's call; then D4@1024
   training at batch 16, float32, remat (tools/bench_train.py --phi 4
   --remat): 2 warm-up and 4 timed steps, ms/step, img/s, peak memory,
   every loss and gradient norm finite, the last timed loss below the
   first;
18. entry_points: every entry point above D0 at D4@1024 and D7@1536, on
   weights drawn at FAMILY_GAIN with their BN statistics calibrated
   (experiments/drawn_weights.calibrate_bn): the Predictor in f32 and bf16,
   score threshold 0, at 1080x1920 and 300x200 sources: each shape's graph
   holds 1 NMS launch (counted at capture; its heads are convolutions, as
   the JAX Predictor's), two replays equal eager() bit for bit, ms per
   image (median of 10 replays and 3 eager calls), capture seconds, the graph
   pool's MB; the anchor-major pipeline on the Predictor's model in a graph
   (2 head launches, the streamed plan in bf16 and the f32 kernel in f32 at
   Cin 224/384, and 1 NMS launch; replay equal to eager bit for bit); in
   f32 both against the CPU at the Predictor rule (counts and classes
   exact, boxes 1e-3 px, scores 1e-5, near-ties in either order); the server (bf16, BN folded,
   batch 16 at D4 and 8 at D7, every bucket captured by warmup()) in
   closed loops at C = 1 and C = batch on 480x640 sources, every answer
   equal to predict_pipeline's detections of its source, img/s and
   p50/p95 (p99 from 200 answers; each level runs 2 s and until 40
   answers came back); the .edz artifact (bf16, BN folded, batch 8)
   exported on the card, its manifest's model block, eager and replayed
   equal to predict_pipeline bit for bit, export and load seconds,
   artifact MB, from_artifact at C = 1 and 8, and, after every timed
   section, a fresh process that loads and runs it, equal bit for bit;
   make_sharded_predict_fn at D7 on an NCCL group of one rank, batch 8,
   equal to make_predict_fn bit for bit, img/s of both; one training step
   (TF32 off) of the CPU tests' reduced D4 and D7 (256 px, BiFPN width 64)
   on the card and the CPU in float32 and float64: the float64 steps to
   each other by the step rule at FLOAT64_SCALE, the card's float32 step
   against the CPU's float64 step by parallel/tolerances.deep_step_errors
   (loss, BN statistics, gradient norm); the phase's launches and the
   launches its graphs hold;
19. stages: device time by stage (efficientdet_tpu_torch/tools/
   analyze_trace.py) in a fresh process (python3 chip_smoke.py
   --stages-child DIR: torch.profiler with the CUDA activity alone has
   recorded no kernel late in this script; what this process's profiler
   sees at that point is printed first): two warm-up and three profiled eager calls (utils/profiling.
   trace, a ProfilerStep range each) of D0@512 b128 (bf16, BN folded,
   anchor_major, the main path), D1-D7 at FAMILY_BATCH on weights drawn at
   FAMILY_GAIN, the D0@512 b64 f32 training step (TF32 off, phase train's
   batch) and the D4@1024 b16 f32 remat step; each table (per stage and
   forward/backward: ms a call, share, launches, TFLOP/s and GB/s against
   the card's peaks, the JAX tool's verdict; by kernel family; the top
   kernels) one JSON line, its trace under chiprun_out/stages/; every
   device event in exactly one stage, the stages summing to the busy time
   within 0.1%, in inference "other" under 5% of it and the head launches
   in heads, the NMS launch in postprocess; the D0 call's kernel count the
   same with every stage range a nullcontext;
20. parity_drill: tools/parity_run.py on the card: archives of TF-named
   arrays written by utils/convert.export_detector_tf_style from D0@512 and
   D7@1536 (full width, 90 classes, weights drawn at FAMILY_GAIN with
   calibrated BN), the drill in f32 (strict full-coverage import, sharded
   predict at world size 1, EvalConfig.exact, the exact COCO evaluation)
   on 16 numpy images with boxes: both kernels launched, the AP finite; a
   truncated array fails the strict import; the card's D0 detections
   (--save-detections) on 4 images against the CPU drill's on the same
   archive (counts and classes exact, boxes 1e-3 px, scores 1e-5);
21. int8: experiments/int8_microbench.py (the JAX script's keys: int8
   against bf16 for a 4096^3 product, a 3x3 and a depthwise 3x3 conv at
   (8, 224, 128, 128), two-point slopes over CUDA graphs of chained
   iterations, *_int8_error where an int8 op does not run) beside the
   card's bf16 and int8 dense peaks;
22. stage1_packing: experiments/stage1_packing.py (the stage-1 block's four
   formulations at batch 16, 512 px, 48 -> 24, bf16, forward and weight
   gradients; each against ref at rtol/atol 3e-2, then its ms);
23. the kernels line, the card line, and the last line,
   {"ok": true, "device": {...}}.

Before each phase a line {"phase": "<name>"}; a phase's failure prints
its traceback to stdout and ends the run with a non-zero exit code.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

from efficientdet_tpu_torch.experiments.drawn_weights import drawn_model, drawn_state_dict
from efficientdet_tpu_torch.experiments.timing import (
    HBM_BYTES_S,
    PEAK_BF16,
    PEAK_F32_CUDA_CORES,
    bound,
    cuda_ms,
    kernel_ms,
)
from efficientdet_tpu_torch.utils.detections import detection_mismatch

ROOT = os.path.dirname(os.path.abspath(__file__))

# float32 operations of one IoU test in the NMS mask: 2 min, 2 max, 2 sub,
# 2 clamp, 1 mul (intersection), 1 add + 1 sub (union), 1 max, 1 div,
# 1 compare; the areas (per box) are not counted
NMS_OPS_PER_PAIR = 14

SOURCES = ["head_pointwise", "nms_suppress", "fused_mbconv", "tap_floor", "conv_epilogue",
           "depthwise_conv", "bifpn_node"]
D0_PIXELS = 64 * 64 + 32 * 32 + 16 * 16 + 8 * 8 + 4 * 4  # pixel rows per image at 512
# the JAX tests' tiny MBConv cases (name, batch, side, cin, cexp, cout, k, se)
MBCONV_TINY = [("tiny_exp_skip", 2, 16, 8, 48, 8, 3, 2),
                      ("tiny_noexp", 2, 16, 8, 8, 4, 3, 2),
                      ("tiny_k5", 2, 8, 8, 24, 8, 5, 2)]
# the kernel's edges: sides that are no multiple of the 16 x 32 (bf16) or
# 8 x 32 (f32) tile, a single partial tile, odd sides (rows that start on odd
# pixels), a side one past a tile edge (33; the row-padded 29 + 4 too),
# Cin 24/40/56 (K padded to 16), Ce 24 without expand (a partial chunk),
# Cout 16/40/56, k3 and k5, with and without skip, batch 1; odd widths (the
# weights' rows are not aligned words: they are staged without cp.async)
MBCONV_EDGES = [("hw20_cin24_skip", 1, 20, 24, 144, 24, 3, 4),
                ("hw72_cin40_k5_skip", 1, 72, 40, 240, 40, 5, 6),
                ("hw8_ce24_noexpand_cout16", 1, 8, 24, 24, 16, 3, 6),
                ("hw30_cin56_k5_skip", 2, 30, 56, 336, 56, 5, 14),
                ("hw33_cout40_noskip", 1, 33, 24, 144, 40, 3, 4),
                ("hw29_k5_skip", 1, 29, 16, 96, 16, 5, 4),
                ("hw12_odd_widths", 1, 12, 7, 21, 9, 3, 2)]
MBCONV_STEPS = 10  # timed calls per kernel and block (the plain version: a fifth)
CHAIN_STEPS = 10
EPILOGUE_STEPS = 10  # timed launches a shape (the twin: a fourth)
# the depthwise kernel's phase: (phi, batch), the benchmark's inference
# cells, each checked and timed at its batch
DEPTHWISE_CELLS = ((0, 128), (4, 64), ("7x", 16))
DEPTHWISE_STEPS = 10
# the node op's phase: the same cells, and the seed of d7x-b16's levels
NODE_STEPS = 10
LEVELS_SEED = 1312312312
FLOOR_REPEATS = 512
FLOOR_STEPS = 10
CHECK_BATCH = 16   # the kernels against their plain versions; the main-path calls
BENCH_BATCH = 128  # timing: the batch the JAX package's bench.py measures
# the Predictor's source shapes (h, w): landscape and portrait VGA, square at
# the model's size, 1080p, and one the letterbox enlarges
PREDICT_SHAPES = [(480, 640), (640, 480), (512, 512), (1080, 1920), (300, 200)]
PREDICT_STEPS = 20  # timed calls per shape, graph and eager (the median is kept)
PREDICT_THREADS = 8  # threads sharing one Predictor at two source shapes
SERVE_BATCH = 32
SERVE_CLIENTS = (1, 8, 32, 64)
SERVE_SECONDS = 2.0
SERVE_WARMUP_CLIENTS = 32  # the closed loop with warmup() called alongside
# training: the JAX package's tools/bench_train.py batch (64, 12 boxes an
# image in 100 slots), 2 warm-up and 10 timed steps
TRAIN_SIZE = 512
TRAIN_BATCH = 64
TRAIN_GT = 12
TRAIN_MAX_GT = 100
TRAIN_WARMUP = 2
TRAIN_STEPS = 10


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
    import importlib.util

    # the host's image libraries: the HTTP handler decodes with PIL
    host_modules = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2")}
    emit({"phase": "device", "name": name, "power_limit": limit, "build_s": build_s,
          "host_modules": host_modules, "registers": regs, "spill_store_bytes": spills})
    return line


# the kernels whose ptxas report the device line carries, every instance
_MAIN_PATH_KERNELS = ("head_pw_resident_kernel", "head_pw_streamed_kernel", "head_pw_kernel",
                      "nms_suppress_kernel", "mbconv_pass_kernel", "mbconv_se_kernel",
                      "mbconv_rp_ring_kernel", "tap_floor_fma_f32", "tap_floor_fma_bf16",
                      "tap_floor_swish_f32", "conv_epilogue_kernel", "depthwise_conv_kernel",
                      "bifpn_node_kernel")


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


def _streamed_smem_fn():
    """The kernel's own count of the streamed plan's shared memory
    (``head_pointwise_streamed_smem``: bytes, 0 if it does not fit)."""
    from efficientdet_tpu_torch.ops import cuda_build

    fn = cuda_build.load("head_pointwise").head_pointwise_streamed_smem
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    return fn


def phase_head(hk):
    """Kernel vs plain at batch 16; timing at batch 128 (bf16, the main path)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    checks = []
    worst_bf16 = 0.0
    rows = CHECK_BATCH * D0_PIXELS
    heads = ((9, 90), (1, 36))  # the class and the box launch
    cases = [(dtype, rows, 64, "D0 batch 16", heads) for dtype in (torch.bfloat16, torch.float32)]
    cases += [(torch.bfloat16, rows - 77, 64, "tail tile", heads)]
    # the streamed plan (Cin > 64): every phi's width from D1's 88 to D6/D7's
    # 384, a row count under one 128-row tile, one that is a whole number of
    # tiles, and one that ends 77 rows into a tile at the widest x (the last
    # x row read: TMA's out-of-bounds fill past it)
    cases += [(torch.bfloat16, 3000, cin, f"Cin {cin}", heads) for cin in (88, 112, 160, 224, 288, 384)]
    cases += [(torch.bfloat16, 77, cin, "under one tile", heads) for cin in (88, 384)]
    cases += [(torch.bfloat16, 8 * 128, cin, "whole tiles", heads) for cin in (160, 384)]
    cases += [(torch.bfloat16, rows - 77, 384, "tail tile, Cin 384", heads)]
    # other class counts: odd widths (scalar stores, no packed max), a
    # small one, and the widest the kernel takes (out 128)
    cases += [(torch.bfloat16, 3000, 160, "other widths", ((9, 91), (9, 21), (1, 128)))]
    smem = _streamed_smem_fn()
    for dtype, rows, cin, label, widths in cases:
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for a, out in widths:
            x, k, b = _head_inputs(rows, cin, a * out, dtype, seed=a + cin)
            z, amax, m = hk.head_pointwise_anchor_major(x, k, b, a)
            z2, amax2, _ = hk.head_pointwise_anchor_major(x, k, b, a)
            zr, ar, _ = hk.head_pointwise_reference(x, k, b, a)
            torch.cuda.synchronize()
            zf, zrf = z.float(), zr.float()
            af, arf = amax.float(), ar.float()
            dz = (zf - zrf).abs()
            da = (af - arf).abs()
            if dtype == torch.bfloat16:
                # the two sum Cin products in another order before rounding:
                # one bf16 ulp relative (2^-7 |ref|), plus 1e-4 for sums
                # that cancel to near zero
                tol_z, tol_a = 2.0 ** -7 * zrf.abs() + 1e-4, 2.0 ** -7 * arf.abs() + 1e-4
                rule = "|d| <= 2^-7 |ref| + 1e-4"
            else:
                tol_z, tol_a = 1e-4 * zrf.abs() + 1e-5, 1e-4 * arf.abs() + 1e-5
                rule = "|d| <= 1e-4 |ref| + 1e-5"
            # two launches on the same inputs: the same bits
            same = bool(torch.equal(z, z2) and torch.equal(amax, amax2))
            ok = bool((dz <= tol_z).all() and (da <= tol_a).all()) and same
            rec = {"case": label, "dtype": name, "A": a, "out": out, "Cin": cin, "M": m,
                   "Mp": z.shape[1], "max_abs_dz": dz.max().item(),
                   "max_abs_damax": da.max().item(), "tolerance": rule,
                   "two_launches_equal": same, "ok": ok}
            if dtype == torch.bfloat16:
                rec["plan"] = hk.bf16_plan(cin, a, out)
                if rec["plan"] == "streamed":
                    # the wrapper's mirror of the streamed plan's shared memory
                    rec["smem_bytes"] = smem(cin, a, out)
                    if rec["smem_bytes"] != hk.streamed_smem_bytes(cin, a, out):
                        raise AssertionError(f"the streamed plan takes {rec['smem_bytes']} B, "
                                             f"streamed_smem_bytes counts "
                                             f"{hk.streamed_smem_bytes(cin, a, out)}: {rec}")
            checks.append(rec)
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, rec["max_abs_dz"], rec["max_abs_damax"])
            if not ok:
                raise AssertionError(f"head kernel disagrees with its plain version: {rec}")
            del x, z, z2, zr, zf, zrf, dz

    timing = []
    for a, out in ((9, 90), (1, 36)):
        x, k, b = _head_inputs(BENCH_BATCH * D0_PIXELS, 64, a * out, torch.bfloat16, seed=7)
        m, cin = x.shape
        mp = m + (-m) % hk.ROW_TILE
        kb = k.bfloat16()
        # as the heads pass it: the transposed view of a bf16 conv weight
        kt = kb.t().contiguous().t()
        ms = cuda_ms(lambda: hk.head_pointwise_anchor_major(x, kt, b, a))
        device = kernel_ms(lambda: hk.head_pointwise_anchor_major(x, kt, b, a), calls=5)
        plain = cuda_ms(lambda: hk.head_pointwise_reference(x, k, b, a), iters=5, warmup=1)
        bb = b.bfloat16()
        library = cuda_ms(lambda: torch.addmm(bb, x, kb).view(m, a, out).amax(-1))
        nbytes = m * cin * 2 + cin * a * out * 2 + a * out * 4 + a * mp * out * 2 + a * mp * 2
        b_ms, b_by = bound(nbytes, 2.0 * m * cin * a * out, PEAK_BF16)
        timing.append({"A": a, "out": out, "M": m, "ms": ms, "device_ms": sum(device.values()),
                       "plain_ms": plain,
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


def _main_path_candidates(rng, b, k, classes=90, per_box=4, size=512):
    """Candidates shaped like the main path's: boxes clipped to the image,
    each box the candidate of ``per_box`` distinct classes (one anchor's
    top classes), in an order unrelated to position (score order)."""
    import torch

    n_box = k // per_box
    xy = rng.uniform(-20, size, (b, n_box, 2))
    wh = rng.uniform(8, 220, (b, n_box, 2))
    boxes = np.clip(np.concatenate([xy, xy + wh], -1), 0, size).astype(np.float32)
    cls = np.stack([np.stack([rng.choice(classes, per_box, replace=False) for _ in range(n_box)])
                    for _ in range(b)]).astype(np.int32)
    order = np.stack([rng.permutation(k) for _ in range(b)])
    boxes = np.take_along_axis(np.repeat(boxes, per_box, axis=1), order[..., None], axis=1)
    cls = np.take_along_axis(cls.reshape(b, k), order, axis=1)
    valid = rng.rand(b, k) > 0.05
    return (torch.from_numpy(np.ascontiguousarray(boxes)).cuda(),
            torch.from_numpy(np.ascontiguousarray(cls)).cuda(), torch.from_numpy(valid).cuda())


def phase_nms(nk):
    import torch

    cases = {
        "parity_data_B4_K1024": _nms_inputs(np.random.RandomState(0), 4, 1024, 16, 400, 150),
        "random_bench_K1024": _nms_inputs(np.random.RandomState(1), BENCH_BATCH, 1024, 16, 400, 150),
        "dense_B8_K1000": _nms_inputs(np.random.RandomState(2), 8, 1000, 2, 100, 80),
        "main_path_B16_K1024_C90": _main_path_candidates(np.random.RandomState(4), 16, 1024),
        "small_B8_K40": _nms_inputs(np.random.RandomState(5), 8, 40, 3, 60, 50),
        f"limit_B2_K{nk.MAX_CANDIDATES}": _nms_inputs(np.random.RandomState(6), 2, nk.MAX_CANDIDATES,
                                                      16, 400, 150),
    }
    # the wrapper's shared-memory budget is the kernel's layout
    from efficientdet_tpu_torch.ops import cuda_build

    smem = cuda_build.load("nms_suppress").nms_suppress_smem_bytes
    smem.restype, smem.argtypes = ctypes.c_longlong, [ctypes.c_int]
    for k in (1, 40, 64, 1000, 1024, nk.MAX_CANDIDATES, nk.MAX_CANDIDATES + 1):
        if smem(k) != nk.smem_bytes(k):
            raise AssertionError(f"K={k}: the kernel takes {smem(k)} B, the wrapper counts {nk.smem_bytes(k)}")
    # the threshold 0.5 everywhere; the parity data also at 0 (any overlap
    # suppresses) and below 0 (pairs that do not intersect suppress too)
    runs = [(name, inputs, 0.5) for name, inputs in cases.items()]
    runs += [("parity_data_B4_K1024", cases["parity_data_B4_K1024"], t) for t in (0.0, -0.1)]
    checks = []
    for name, (boxes, cls, valid), thr in runs:
        got = nk.suppression_keep_mask(boxes, cls, valid, thr)
        want = nk.suppression_keep_mask_reference(boxes, cls, valid, thr)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        checks.append({"case": name, "iou_threshold": thr, "kept": int(want.sum()),
                       "valid": int(valid.sum()), "differ": diff})
        if diff:
            raise AssertionError(f"NMS kernel differs from its plain version: {checks[-1]}")
    boxes, cls, valid = cases["random_bench_K1024"]
    b, k = cls.shape
    ms = cuda_ms(lambda: nk.suppression_keep_mask(boxes, cls, valid, 0.5))
    device = kernel_ms(lambda: nk.suppression_keep_mask(boxes, cls, valid, 0.5), calls=10)
    plain = cuda_ms(lambda: nk.suppression_keep_mask_reference(boxes, cls, valid, 0.5),
                    iters=3, warmup=1)
    nbytes = b * k * (16 + 4 + 1) + b * k
    # this data's work: a class compare for every pair j < i, the IoU only
    # for the pairs of one class
    per_class = torch.stack([torch.bincount(c.long(), minlength=16) for c in cls])
    same_class_pairs = int((per_class * (per_class - 1) // 2).sum())
    ops = b * k * (k - 1) / 2 + same_class_pairs * NMS_OPS_PER_PAIR
    b_ms, b_by = bound(nbytes, ops, PEAK_F32_CUDA_CORES)
    timing = {"B": b, "K": k, "ms": ms, "device_ms": sum(device.values()), "plain_ms": plain,
              "library_ms": None,
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


def phase_pipeline(et, hk, nk, ce, dc, bn, card, profile_dir):
    import torch

    model, cfg = et.build_efficientdet(0, num_classes=90, dtype=torch.bfloat16, seed=0)
    model = et.fuse_for_inference(model)
    predict = et.make_predict_fn(model)
    size = cfg.image_size
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (CHECK_BATCH, size, size, 3)).astype(np.uint8)).cuda()

    hk.head_pointwise_anchor_major.launches = 0
    nk.suppression_keep_mask.launches = 0
    ce.conv_epilogue.launches = ce.conv_epilogue.padded = 0
    dc.depthwise_conv.launches = 0
    bn.bifpn_node.launches = 0
    calls = 3
    for _ in range(calls):
        dets = predict(images)
        n = _check_detections(dets, cfg.num_classes, CHECK_BATCH)
    torch.cuda.synchronize()
    launches = {"head_pointwise": hk.head_pointwise_anchor_major.launches,
                "nms_suppress": nk.suppression_keep_mask.launches,
                "conv_epilogue": ce.conv_epilogue.launches,
                "conv_epilogue_padded": ce.conv_epilogue.padded,
                "depthwise_conv": dc.depthwise_conv.launches,
                "bifpn_node": bn.bifpn_node.launches}
    if launches != {"head_pointwise": 2 * calls, "nms_suppress": calls,
                    "conv_epilogue": 32 * calls, "conv_epilogue_padded": 4 * calls,
                    "depthwise_conv": 16 * calls, "bifpn_node": 24 * calls}:
        raise AssertionError(f"the main path did not go through its kernels: {launches}")

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
              **_profile(lambda: predict(big), profile_dir, rec["ms_per_call"])})
    del big, images, model
    torch.cuda.empty_cache()
    return launches, rec["ms_per_call"]


def _profile(call, out_dir, ms_per_call, calls: int = 3, trace: str = "pipeline_trace.json"):
    """Device time by kernel and by ATen operator, per call, over ``calls``
    back-to-back calls of ``call()``; the chrome trace goes to
    ``out_dir/trace``.

    Idle share twice: against the profiled wall time (the profiler adds host
    work) and against ``ms_per_call``, the unprofiled steady-state time. An
    operator's device time is that of the kernels it launched itself (its
    self device time), so the operators' rows add up to the busy time.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_ms(ev):
        dev = getattr(ev, "self_device_time_total", None)
        return (ev.self_cuda_time_total if dev is None else dev) / 1e3 / calls

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    rows, ops = [], []
    for ev in prof.key_averages():
        ms = device_ms(ev)
        if ms <= 0:
            continue
        if ev.device_type == DeviceType.CUDA:  # kernels
            rows.append((ms, ev.count / calls, ev.key))
        else:  # the operators that launched them
            ops.append((ms, ev.count / calls, ev.key))
    rows.sort(reverse=True)
    ops.sort(reverse=True)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, trace))
    busy = sum(r[0] for r in rows)
    return {"calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy,
            "launches": sum(r[1] for r in rows),
            "idle_share_profiled": max(0.0, 1.0 - busy / wall_ms),
            "idle_share_steady": max(0.0, 1.0 - busy / ms_per_call),
            "top": [{"ms": r[0], "count": r[1], "name": r[2][:100]} for r in rows[:30]],
            "top_ops": [{"ms": r[0], "count": r[1], "name": r[2][:100]} for r in ops[:25]],
            # the port's own kernels, wherever they rank
            "port_kernels": [{"ms": r[0], "count": r[1], "name": _demangle_key(r[2])}
                             for r in rows if _demangle_key(r[2])]}


def _demangle_key(key):
    """``name<args>`` of a profiler kernel name if it is one of the port's kernels."""
    m = re.search(r"\b(" + "|".join(_MAIN_PATH_KERNELS) + r")(<[^()]*>)?", key)
    return m.group() if m else None


def _card_vs_cpu(dets, n_images):
    """The gpu_vs_cpu phase's end-to-end rule on ``dets = {"cuda": ...,
    "cpu": ...}`` (CPU tensors): counts exactly; at least 98% of the card's
    detections have a CPU detection of the same class, box within 0.01 px
    and score within 1e-4 (ranks of near-equal scores may swap where the
    head outputs differ in the last digits). Raises on a disagreement."""
    import torch

    matched = total = 0
    for i in range(n_images):
        kg, kc = int(dets["cuda"][3][i]), int(dets["cpu"][3][i])
        total += kg
        for j in range(kg):
            hit = ((dets["cpu"][2][i, :kc] == dets["cuda"][2][i, j])
                   & ((dets["cpu"][0][i, :kc] - dets["cuda"][0][i, j]).abs().amax(-1) <= 1e-2)
                   & ((dets["cpu"][1][i, :kc] - dets["cuda"][1][i, j]).abs() <= 1e-4))
            matched += int(hit.any())
    rec = {"num_valid_cuda": [int(v) for v in dets["cuda"][3]],
           "num_valid_cpu": [int(v) for v in dets["cpu"][3]],
           "matched": matched, "total": total}
    if not torch.equal(dets["cuda"][3], dets["cpu"][3]) or matched < 0.98 * total:
        raise AssertionError(f"card and CPU detections differ: {rec}")
    return rec


def _heads_card_vs_cpu(tn, models, images):
    """The gpu_vs_cpu rule on ``models`` ({"cuda": ..., "cpu": ...}, the same
    folded float32 weights; TF32 off) and uint8 ``images``: raw head outputs
    within 1e-4 of their scale (float32 convs in other algorithms and
    summation orders, through some 90 layers and more); the CPU's head
    outputs through the NMS on both devices, exactly. Raises on a
    disagreement; returns (heads, nms, the CPU forward's seconds)."""
    import torch

    from efficientdet_tpu_torch.ops.preprocess import preprocess_batch_fixed

    outs, cpu_s = {}, 0.0
    with torch.inference_mode():
        for key, dev in (("cuda", DEVICE), ("cpu", "cpu")):
            t0 = time.perf_counter()
            (z, amax, hws), (zb, _) = models[key](preprocess_batch_fixed(images.to(dev)),
                                                  anchor_major=True)
            outs[key] = (z.cpu(), amax.cpu(), zb.cpu(), hws)
            cpu_s = time.perf_counter() - t0
    heads = {}
    for i, name in enumerate(("z", "amax", "zb")):
        g, c = outs["cuda"][i], outs["cpu"][i]
        scale = c.abs().max().item()
        err = (g - c).abs().max().item()
        heads[name] = {"max_abs_err": err, "scale": scale, "err_over_tol": err / (1e-4 * scale)}
    if not all(h["err_over_tol"] <= 1.0 for h in heads.values()):
        raise AssertionError(f"card and CPU head outputs differ: {heads}")

    z, amax, zb, hws = outs["cpu"]
    size = images.shape[1]
    anchors = models["cpu"].anchors(size, torch.device("cpu"))
    cpu = tn.batched_filter_from_anchor_major_levels(anchors, (zb, hws), (z, amax, hws), (size, size))
    gpu = [t.cpu() for t in tn.batched_filter_from_anchor_major_levels(
        anchors.to(DEVICE), (zb.to(DEVICE), hws), (z.to(DEVICE), amax.to(DEVICE), hws),
        (size, size))]
    nms = {"boxes_equal": bool(torch.equal(gpu[0], cpu[0])),
           "classes_equal": bool(torch.equal(gpu[2], cpu[2])),
           "num_valid_equal": bool(torch.equal(gpu[3], cpu[3])),
           "num_valid": [int(v) for v in cpu[3]],
           "max_abs_dscore": (gpu[1] - cpu[1]).abs().max().item()}
    if not (nms["boxes_equal"] and nms["classes_equal"] and nms["num_valid_equal"]
            and nms["max_abs_dscore"] <= 1e-6):
        raise AssertionError(f"NMS on the card differs from the CPU's: {nms}")
    return heads, nms, cpu_s


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
    heads, same_heads, _ = _heads_card_vs_cpu(tn, models, images)

    # end to end: each card detection has a CPU detection of the same class
    dets = {dev: [t.cpu() for t in et.make_predict_fn(m)(images.to(dev))]
            for dev, m in models.items()}
    end_to_end = _card_vs_cpu(dets, images.shape[0])
    emit({"phase": "gpu_vs_cpu", "batch": 2, "dtype": "float32, TF32 off",
          "head_outputs": heads, "nms_same_heads": same_heads, "end_to_end": end_to_end})


def phase_mbconv(mk, pm):
    """The three launchers vs their plain versions at small shapes; then the
    per-block harness, which holds them against their plain versions again
    at every BLOCKS shape (D0 at batch 128, D4 at 16) before timing them."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = ([pm.BlockShape(*c) for c in MBCONV_TINY + MBCONV_EDGES]
             + [pm.BLOCKS[n]._replace(batch=2) for n in ("d0s1", "d0s2b1", "d0s3b1")])
    # the wrapper's shared-memory count is the kernel's plan
    from efficientdet_tpu_torch.ops import cuda_build

    smem = cuda_build.load("fused_mbconv").fused_mbconv_smem_bytes
    smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int] * 7
    tiles = cuda_build.load("fused_mbconv").fused_mbconv_tiles
    tiles.restype, tiles.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    for shape in cases + list(pm.BLOCKS.values()):
        for dtype in (torch.float32, torch.bfloat16):
            if tiles(shape.hw, shape.hw, int(dtype == torch.bfloat16)) != mk.tiles_of(
                    shape.hw, shape.hw, dtype):
                raise AssertionError(f"{shape.name} {dtype}: the wrapper's tile count is not the kernel's")
            for project in (False, True):
                args = (shape.cin, shape.cexp, shape.cout, shape.ksize, shape.has_expand)
                got = smem(*(int(a) for a in args), int(dtype == torch.bfloat16), int(project))
                want = mk.smem_bytes(*args, dtype, project)
                if got != want or want > mk.SMEM_MAX:
                    raise AssertionError(f"{shape.name} {dtype} project={project}: the kernel takes "
                                         f"{got} B of shared memory, the wrapper counts {want}")
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
            if shape.has_skip:  # the gap lanes must leave as x's own: give them values
                xrp = xrp + (1 - mask) * 0.25
            twice = mk.packed_mbconv_rp(xrp, mask, packed, shape)
            pairs = {
                "packed": (mk.packed_mbconv(xp, packed, shape),
                           mk.packed_mbconv_reference(xp, packed, shape)),
                "rp": (mk.packed_mbconv_rp(xrp, mask, packed, shape),
                       mk.packed_mbconv_rp_reference(xrp, mask, packed, shape)),
                "nhwc": (mk.fused_mbconv_nhwc(x, packed, shape.ksize, shape.has_skip),
                         mk.fused_mbconv_nhwc_reference(x, packed, shape.ksize, shape.has_skip)),
            }
            torch.cuda.synchronize()
            # gap lanes: exactly 0, or exactly x's own under a skip; a second run
            # gives the same bits
            out_rp = pairs["rp"][0]
            x_gap = xrp * (1 - mask) if shape.has_skip else torch.zeros_like(out_rp)
            gap = ((out_rp.float() - x_gap.float()) * (1 - mask.float())).abs().max().item()
            if not torch.equal(out_rp, twice):
                raise AssertionError(f"{shape.name} {dname}: two runs of the rp kernel differ")
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
    # the main row's launch alone (f32, taps 9, chains 4), by torch.profiler:
    # the mean over the launches it recorded (and how many of 5 it did)
    main["device_ms"], main["profiled_launches"] = _launch_device_ms(
        lambda: tk.tap_floor(x, "fma", 9, FLOOR_REPEATS, 4), "tap_floor", calls=5)
    plain = cuda_ms(lambda: tk.tap_floor_reference(x, "fma", 9, FLOOR_REPEATS, 4), iters=1, warmup=0)
    ceiling = tf.ceiling_from_rates(floor["tap_fma_g_s"], floor["swish_g_s"], floor["t_mm_ms"],
                                    HBM_BYTES_S, chain_d0_ms, d0_ms)
    emit({"phase": "tap_floor", "checks": checks, "repeats": FLOOR_REPEATS, **floor,
          "harness_launches": launches, "plain_ms_f32_chains4": plain,
          "ceiling": ceiling})
    return worst, main, plain, launches


def _launch_device_ms(fn, name, calls):
    """(mean device ms of a kernel whose name holds ``name``, its launches
    recorded) over ``calls`` calls of ``fn()`` under torch.profiler, after
    a warm-up call and, inside the window, a small kernel of its own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and name in ev.key:
            dev = getattr(ev, "self_device_time_total", None)
            total += (ev.self_cuda_time_total if dev is None else dev) / 1e3
            count += ev.count
    if count == 0:
        raise AssertionError(f"the profiler saw no {name} kernel")
    return total / count, count


def _median_ms(fn, steps):
    """Median host time of ``fn()`` in ms over ``steps`` calls (each call
    ends with its results on the host)."""
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _traced(call):
    """Device operations of one ``call()`` by torch.profiler: their count,
    their summed device ms, and the port's kernels among them by name
    (kernels a CUDA graph replays are traced one by one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    total, busy, port = 0, 0.0, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        total += ev.count
        dev = getattr(ev, "self_device_time_total", None)
        busy += (ev.self_cuda_time_total if dev is None else dev) / 1e3
        name = _demangle_key(ev.key)
        if name:
            port[name] = port.get(name, 0) + ev.count
    return total, busy, port


def _has(kernels, prefix):
    return any(k.startswith(prefix) for k in kernels)


def _matched(got, want, box_tol, score_tol):
    """How many of ``got``'s detections have a detection in ``want`` of the
    same class, box within ``box_tol`` and score within ``score_tol``."""
    gb, gs, gc = got
    wb, ws, wc = want
    hits = 0
    for j in range(len(gs)):
        hits += bool(((wc == gc[j]) & (np.abs(wb - gb[j]).max(-1) <= box_tol)
                      & (np.abs(ws - gs[j]) <= score_tol)).any())
    return hits


def _valid(dets, num_classes):
    boxes, scores, classes = dets
    return bool(np.isfinite(boxes).all() and ((scores > 0) & (scores <= 1)).all()
                and ((classes >= 0) & (classes < num_classes)).all())


def _op_record(rec, name):
    """One op's record from ``folded_ops.run``'s: the run's fields and the
    op's own, its calls left out."""
    return {**{k: v for k, v in rec.items() if k not in ("launches", "conv_epilogue",
                                                         "depthwise_conv", "bifpn_node")},
            **{k: v for k, v in rec[name].items() if k != "calls"}}


def phase_conv_epilogue(xf):
    """The folded model's ops against their twins at every call of one
    folded D0@512 backbone and BiFPN forward in float32 at CHECK_BATCH and
    one in bf16 at BENCH_BATCH; then the conv epilogue's time at the
    batch-128 shapes beside its bound and the twin's. Returns the phase's
    record and the D0 results of the other ops (every op's float32 check
    and the bf16 run) for their own phases."""
    import torch

    model, cfg = xf.folded_model(0, torch.float32)
    images = xf.nhwc_images(CHECK_BATCH, cfg.image_size, torch.float32,
                            torch.Generator(device="cuda").manual_seed(3))
    _, f32 = xf.forward_calls(model, images, check=xf.OPS)
    del model, images
    torch.cuda.empty_cache()
    rec = xf.run(0, BENCH_BATCH, torch.bfloat16, EPILOGUE_STEPS)
    out = {"phase": "conv_epilogue", "f32_batch": CHECK_BATCH,
           "f32_max_abs_err": f32["conv_epilogue"]["max_abs_err"],
           "launches": rec["launches"]["conv_epilogue.launches"],
           "padded": rec["launches"]["conv_epilogue.padded"],
           **_op_record(rec, "conv_epilogue"),
           "note": "check: the worst over the bf16 forward's calls (ulps against the twin in "
                   "float32 rounded once; ulps_vs_bf16_ops against the twin in bf16); ms the "
                   "launches by CUDA events, device_ms the kernel by torch.profiler, plain_ms "
                   "the twin, bound_ms the bytes at 3.35 TB/s, each summed over the calls"}
    emit(out)
    if (out["f32_max_abs_err"] != 0.0 or out["check"]["ulps"] > 1 or out["launches"] != 32
            or out["padded"] != 4):
        raise AssertionError(f"conv_epilogue: the kernel left its twin or the path: {out}")
    torch.cuda.empty_cache()
    return out, (f32, rec)


def phase_depthwise_conv(xf, d0):
    """The depthwise kernel against its twin at every depthwise call of a
    folded backbone forward (D0 in float32 at CHECK_BATCH; the benchmark's
    inference cells in bf16 at their batches, D4's call past 2^31 input
    elements among them), then its time there beside its bound, cuDNN's
    conv and the epilogue, and the SE's mean. ``d0``: D0's float32 check
    and bf16 run, from phase conv_epilogue's forwards."""
    import torch

    f32, d0_run = d0
    f32 = f32["depthwise_conv"]
    out = {"phase": "depthwise_conv", "f32_batch": CHECK_BATCH, "f32_check": f32, "cells": {}}
    want = {"0": (16, 32), "4": (32, 63), "7x": (55, 107)}
    bad = f32["excess"] > 1 or f32["sums_excess"] > 1
    for phi, batch in DEPTHWISE_CELLS:
        rec = d0_run if (phi, batch) == (0, BENCH_BATCH) else xf.run(
            phi, batch, torch.bfloat16, DEPTHWISE_STEPS, ops=("depthwise_conv",))
        cell = {"launches": rec["launches"]["depthwise_conv.launches"],
                "epilogue_launches": rec["launches"]["conv_epilogue.launches"],
                **_op_record(rec, "depthwise_conv")}
        out["cells"][str(phi)] = cell
        bad |= (cell["check"]["excess"] > 1 or cell["check"]["sums_excess"] > 1
                or cell["check"]["ulps"] > 1
                or (cell["launches"], cell["epilogue_launches"]) != want[str(phi)])
        torch.cuda.empty_cache()
    out["note"] = ("check: the worst over each forward's calls (excess: the distance from the twin "
                   "run in float32 over its stated allowance; sums_excess likewise for the SE sums; "
                   "ulps against the twin rounded once, bf16); ms the launches by CUDA events, "
                   "device_ms the kernel by torch.profiler, library_ms cuDNN's conv and the "
                   "epilogue, mean_ms the SE's torch.mean, bound_ms the bytes at 3.35 TB/s, each "
                   "summed over a forward's calls at the batch")
    emit(out)
    if bad:
        raise AssertionError(f"depthwise_conv: the kernel left its twin or the path: {out}")
    return out


def phase_bifpn_node(xf, d0):
    """The BiFPN node kernel against its twin run in float32 at every node
    call of a folded forward (D0 in float32 at CHECK_BATCH; the benchmark's
    inference cells in bf16 at their batches), then its time there beside
    its bound and ATen's resample and fusion; then d7x-b16's levels P3..P8
    against the float32 reference (``portbench/readings_levels.py``, one
    seed). ``d0``: D0's float32 checks and bf16 run, from phase
    conv_epilogue's forwards."""
    import torch

    f32, d0_run = d0
    f32 = f32["bifpn_node"]
    out = {"phase": "bifpn_node", "f32_batch": CHECK_BATCH, "f32_check": f32, "cells": {}}
    want = {"0": 24, "4": 56, "7x": 80}
    bad = f32["excess"] > 1
    for phi, batch in DEPTHWISE_CELLS:
        rec = d0_run if (phi, batch) == (0, BENCH_BATCH) else xf.run(
            phi, batch, torch.bfloat16, NODE_STEPS, ops=("bifpn_node",))
        cell = {"launches": rec["launches"]["bifpn_node.launches"],
                **_op_record(rec, "bifpn_node")}
        out["cells"][str(phi)] = cell
        bad |= (cell["check"]["excess"] > 1 or cell["check"]["ulps"] > 1
                or cell["launches"] != want[str(phi)])
        torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "readings_levels.py"), "--workload",
         "d7x-b16", "--levels-seed", str(LEVELS_SEED)],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"readings_levels.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    levels = lines[-1]["levels"]
    out["d7x_levels"] = {"seed": LEVELS_SEED, "fusion_nodes": levels["fusion_nodes"],
                         **{side: levels[side] for side in ("port", "control")}}
    out["note"] = ("check: the worst over each forward's calls (excess: the distance from the twin "
                   "run in float32 over its stated allowance; ulps against the twin rounded once, "
                   "bf16); ms the launches by CUDA events, device_ms the kernel by "
                   "torch.profiler, library_ms ATen's resample and fusion, bound_ms the bytes at "
                   "3.35 TB/s, each summed over a forward's calls at the batch; d7x_levels: each "
                   "tap's and level's largest gap from the float32 reference over its largest "
                   "magnitude, the port's and the fp8 control's")
    emit(out)
    if bad or out["d7x_levels"]["fusion_nodes"] != {"sum": 80, "weighted": 0}:
        raise AssertionError(f"bifpn_node: the kernel left its twin or the path: {out}")
    return out


def phase_predictor(et, nk, card):
    """Predictor(phi=0), one CUDA graph per source shape, f32 and bf16."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    images = {hw: [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for _ in range(2)]
              for hw in PREDICT_SHAPES}
    out = {}
    for dtype in ("f32", "bf16"):
        # random bf16 weights put few logits above the 0.01 prior at most
        # shapes; threshold 0 keeps every candidate, so no output is empty
        p = et.Predictor(phi=0, dtype=dtype, seed=0, score_threshold=0.01 if dtype == "f32" else 0.0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        nk.suppression_keep_mask.launches = 0
        rows = []
        for hw in PREDICT_SHAPES:
            first, second = images[hw]
            t0 = time.perf_counter()
            replays = [p(first)]  # two warm-up calls, the capture, the first replay
            capture_s = time.perf_counter() - t0
            replays.append(p(second))
            for img, got in zip((first, second), replays):
                want = p.eager(img)
                if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"Predictor {dtype} {hw}: the graph replay differs from eager")
                if not _valid(got, p.config.num_classes):
                    raise AssertionError(f"Predictor {dtype} {hw}: invalid detections")
            rows.append({"shape": list(hw), "detections": [len(r[1]) for r in replays],
                         "capture_s": capture_s,
                         "graph_ms": _median_ms(lambda: p(first), PREDICT_STEPS),
                         "eager_ms": _median_ms(lambda: p.eager(first), PREDICT_STEPS)})
        # warm-up, capture and eager calls launch the NMS kernel; a replay
        # ticks no counter, so the trace of one replay shows it
        launches = nk.suppression_keep_mask.launches
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pool_mb = (torch.cuda.memory_reserved() - reserved0) / 2 ** 20
        device_ops, busy_ms, kernels = _traced(lambda: p(images[PREDICT_SHAPES[0]][0]))
        if not _has(kernels, "nms_suppress_kernel"):
            raise AssertionError(f"Predictor {dtype}: no NMS kernel in a replay's trace: {kernels}")
        rec = {"shapes": rows, "nms_launches_outside_replays": launches,
               "graph_pool_reserved_mb": pool_mb, "replay_device_ops": device_ops,
               "replay_device_busy_ms": busy_ms, "replay_port_kernels": kernels}
        rec["threads"] = _predictor_threads(p, [images[hw][i] for hw in PREDICT_SHAPES[:2]
                                                for i in range(2)])
        if dtype == "f32":
            # the card against the CPU (the kernels' plain versions), one shape
            cpu = et.Predictor(phi=0, dtype="f32", seed=0, device="cpu")
            img = images[PREDICT_SHAPES[0]][0]
            g, c = p(img), cpu(img)
            hits = _matched(g, c, 1e-3, 1e-5)
            rec["vs_cpu"] = {"shape": list(PREDICT_SHAPES[0]), "detections": [len(g[1]), len(c[1])],
                             "matched": hits, "box_tol_px": 1e-3, "score_tol": 1e-5}
            if len(g[1]) != len(c[1]) or hits != len(g[1]) or not np.array_equal(
                    np.sort(g[2]), np.sort(c[2])):
                raise AssertionError(f"Predictor f32: card and CPU differ: {rec['vs_cpu']}")
            # a ninth shape evicts the oldest graph
            for i in range(9 - len(PREDICT_SHAPES)):
                p(np.zeros((200 + 8 * i, 320, 3), np.uint8))
            cached = list(p._run_cache)
            if len(cached) != 8 or tuple(PREDICT_SHAPES[0]) in cached:
                raise AssertionError(f"the ninth shape did not evict the oldest graph: {cached}")
            rec["cache_after_nine_shapes"] = [list(k) for k in cached]
        out[dtype] = rec
        del p
        torch.cuda.empty_cache()
    emit({"phase": "predictor", "model": "D0@512, 90 classes, random weights from seed 0, unfused",
          "tf32": False, "steps": PREDICT_STEPS, **out, "card": card})
    return out


def _predictor_threads(p, images, threads=PREDICT_THREADS, calls=5):
    """``threads`` threads calling one Predictor on ``images`` (two source
    shapes, so two graphs of one pool): every answer must equal ``eager()``
    of the caller's own image."""
    want = [p.eager(img) for img in images]
    errors, done = [], []

    def caller(k):
        j = k % len(images)
        for _ in range(calls):
            got = p(images[j])
            if not all(np.array_equal(g, w) for g, w in zip(got, want[j])):
                errors.append(j)
        done.append(k)

    pool = [threading.Thread(target=caller, args=(k,)) for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=300)
    if errors or len(done) != threads:
        raise AssertionError(f"Predictor threads: {len(errors)} answers differ from eager(), "
                             f"{len(done)} of {threads} threads finished")
    return {"threads": threads, "calls": threads * calls,
            "shapes": sorted({tuple(int(v) for v in img.shape[:2]) for img in images}),
            "answers": "each equal to eager() of its own image"}


def _png_bytes(img):
    """An RGB uint8 image as PNG bytes, with the standard library alone (the
    check must run on a host without an image library too)."""
    import struct
    import zlib

    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _http_check(pred, src, expected):
    """One POST of ``src`` as a PNG to a live make_http_server: a status
    line, 501 where PIL is missing, else 200 with the detections of one of
    ``expected`` (predict_pipeline's at each bucket size), as the handler
    rounds them."""
    import http.client
    import importlib.util
    import json as json_

    from efficientdet_tpu_torch.serve import make_http_server

    server = make_http_server(pred, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("POST", "/predict", body=_png_bytes(src))
        resp = conn.getresponse()
        status, reason, body = resp.status, resp.reason, resp.read()
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    has_pil = importlib.util.find_spec("PIL") is not None
    rec = {"status": status, "reason": reason, "pil": has_pil}
    if not has_pil:
        if status != 501:
            raise AssertionError(f"HTTP without PIL: status {status}, not 501")
        return rec
    if status != 200:
        raise AssertionError(f"HTTP: status {status}: {reason}")
    dets = json_.loads(body)["detections"]

    def rounded(ans):
        return [{"box": [round(float(x), 2) for x in b], "score": round(float(s), 4), "class": int(c)}
                for b, s, c in zip(*ans)]

    if not any(dets == rounded(e) for e in expected):
        raise AssertionError("HTTP: the detections differ from predict_pipeline's")
    rec["detections"] = len(dets)
    return rec


P99_MIN_ANSWERS = 200  # fewer answers leave a p99 that is one of the few slowest: not printed


def _closed_loop(pred, images, expected, clients, seconds, warmups=False, min_answers=0):
    """C client threads, each calling predict_sync in a loop for ``seconds``
    and until ``min_answers`` answers came back (the JAX package's
    tools/bench_serve.py load, in process). Every answer must equal one of
    ``expected[j]``, the pipeline's detections of source j at each bucket
    size. ``warmups``: another thread calls ``warmup()`` over and over
    meanwhile, as a live server may. p99 is None under P99_MIN_ANSWERS
    answers."""
    from efficientdet_tpu_torch.serve import PredictorOverloaded

    lat, counts, lock = [], {"overloaded": 0, "timeouts": 0, "warmups": 0}, threading.Lock()
    errors = []
    stop = time.perf_counter() + seconds

    def running():
        return time.perf_counter() < stop or len(lat) < min_answers

    def client(k):
        i = k
        while running() and not errors:
            j = i % len(images)
            i += 1
            t0 = time.perf_counter()
            try:
                got = pred.predict_sync(images[j], timeout=60)
            except PredictorOverloaded:
                with lock:
                    counts["overloaded"] += 1
                time.sleep(0.005)
                continue
            except TimeoutError:
                with lock:
                    counts["timeouts"] += 1
                continue
            except Exception as e:  # noqa: BLE001 — reported below, the run fails
                errors.append(repr(e))
                return
            ms = (time.perf_counter() - t0) * 1e3
            if not any(all(np.array_equal(g, w) for g, w in zip(got, want)) for want in expected[j]):
                errors.append(f"source {j}: the answer differs from predict_pipeline's")
                return
            with lock:
                lat.append(ms)

    def warmer():
        try:
            while running() and not errors:
                pred.warmup()
                counts["warmups"] += 1
        except Exception as e:  # noqa: BLE001 — reported below, the run fails
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    if warmups:
        threads.append(threading.Thread(target=warmer))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    if errors or not lat or (warmups and not counts["warmups"]):
        raise AssertionError(f"serve, {clients} clients: {len(lat)} answered, errors {errors[:3]}, "
                             f"{counts}")
    lat_a = np.asarray(lat)
    return {"clients": clients, "n": len(lat), "img_s": len(lat) / elapsed,
            "p50_ms": float(np.percentile(lat_a, 50)), "p95_ms": float(np.percentile(lat_a, 95)),
            "p99_ms": float(np.percentile(lat_a, 99)) if len(lat) >= P99_MIN_ANSWERS else None,
            **counts, "elapsed_s": elapsed}


def phase_serve(et, hk, nk, card):
    """BatchingPredictor over D0@512 bf16, BN folded: buckets, exactness, load."""
    import torch
    from efficientdet_tpu_torch.data.common import letterbox_hostside

    model, cfg = et.build_efficientdet(0, num_classes=90, dtype=torch.bfloat16, seed=0)
    model = et.fuse_for_inference(model)
    hk.head_pointwise_anchor_major.launches = 0
    nk.suppression_keep_mask.launches = 0
    # threshold 0 keeps all K = 1024 candidates valid (random weights put
    # few logits above the 0.01 prior on letterboxed images): the NMS does
    # the most work, and no answer is empty
    ec = et.EvalConfig(score_threshold=0.0)
    pred = et.BatchingPredictor(model, batch_size=SERVE_BATCH, max_delay_ms=5.0, eval_config=ec,
                                pipeline_depth=2)
    threads = torch.get_num_threads()
    try:
        t0 = time.perf_counter()
        pred.warmup()
        warmup_s = time.perf_counter() - t0
        # warm-up and capture launch the kernels; a replay ticks no counter
        launches = {"head_pointwise": hk.head_pointwise_anchor_major.launches,
                    "nms_suppress": nk.suppression_keep_mask.launches}
        if sorted(pred._graphs) != pred._buckets or min(launches.values()) == 0:
            raise AssertionError(f"warmup: graphs {sorted(pred._graphs)}, launches {launches}")

        rng = np.random.RandomState(5)
        srcs = [rng.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(16)]
        canvases = [letterbox_hostside(im, cfg.image_size) for im in srcs]
        # lone requests ride bucket 1: equal to predict_pipeline at batch 1
        for i in range(3):
            got = pred.predict_sync(srcs[i], timeout=60)
            canvas, scale = canvases[i]
            b, s, c, n = (t.cpu() for t in et.predict_pipeline(model, torch.from_numpy(canvas[None]).cuda(), ec))
            k = int(n[0])
            want = (b[0, :k].numpy() / scale, s[0, :k].numpy(), c[0, :k].numpy())
            if not all(np.array_equal(g, w) for g, w in zip(got, want)) or k == 0:
                raise AssertionError(f"serve: request {i} differs from predict_pipeline (n={k})")
        # every source's detections at every bucket size: a closed-loop
        # answer must equal one of them (its batch's size decides which;
        # batch neighbours do not change an image's detections)
        expected = [[] for _ in srcs]
        for b in pred._buckets:
            order = [j % len(srcs) for j in range(-(-max(b, len(srcs)) // b) * b)]
            for start in range(0, len(order), b):
                idx = order[start:start + b]
                batch = torch.from_numpy(np.stack([canvases[j][0] for j in idx])).cuda()
                bx, sc, cl, nv = (t.cpu().numpy() for t in et.predict_pipeline(model, batch, ec))
                for r, j in enumerate(idx):
                    k = int(nv[r])
                    ans = (bx[r, :k] / canvases[j][1], sc[r, :k], cl[r, :k])
                    if not any(all(np.array_equal(g, w) for g, w in zip(ans, e)) for e in expected[j]):
                        expected[j].append(ans)
        variants = max(len(e) for e in expected)
        # so an answer handed to the wrong caller cannot pass
        owner = {}
        for j, per_src in enumerate(expected):
            for e in per_src:
                owner.setdefault(b"".join(t.tobytes() for t in e), set()).add(j)
        if any(len(js) > 1 for js in owner.values()):
            raise AssertionError("serve: two sources share their detections; the check would be blind")
        # a full bucket through the server's own device call
        full = np.stack([cv for cv, _ in canvases] * (SERVE_BATCH // len(canvases)))

        def one_batch():
            with pred._device_lock:
                staged = pred._stage(SERVE_BATCH)
                staged.copy_(torch.from_numpy(full))
                out = pred._predict(staged)
            return [np.asarray(o) for o in out]

        got = one_batch()
        want = [t.cpu().numpy() for t in et.predict_pipeline(model, torch.from_numpy(full).cuda(), ec)]
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("serve: the full bucket's replay differs from predict_pipeline")
        device_ops, busy_ms, kernels = _traced(one_batch)
        if not (_has(kernels, "head_pw") and _has(kernels, "nms_suppress_kernel")):
            raise AssertionError(f"serve: the replay's trace lacks a kernel: {kernels}")
        # the load at the process's default intra-op threads, then at one a
        # thread (serve.main's setting on the card)
        default_threads = _closed_loop(pred, srcs, expected, SERVE_CLIENTS[-1], SERVE_SECONDS)
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        for im in srcs:
            letterbox_hostside(im, cfg.image_size)
        letterbox_ms = (time.perf_counter() - t0) * 1e3 / len(srcs)
        levels = [_closed_loop(pred, srcs, expected, c, SERVE_SECONDS) for c in SERVE_CLIENTS]
        # warmup() on a live server: its replays run beside the traffic's
        with_warmups = _closed_loop(pred, srcs, expected, SERVE_WARMUP_CLIENTS, SERVE_SECONDS,
                                    warmups=True)
        http = _http_check(pred, srcs[0], expected[0])
    finally:
        pred.close()
        torch.set_num_threads(threads)
    emit({"phase": "serve", "model": "D0@512, 90 classes, BN folded, bf16", "score_threshold": 0.0,
          "batch_size": SERVE_BATCH,
          "max_delay_ms": 5.0, "pipeline_depth": 2, "warmup_s": warmup_s,
          "launches_warmup": launches, "full_bucket_replay_device_ops": device_ops,
          "full_bucket_replay_device_busy_ms": busy_ms,
          "full_bucket_replay_port_kernels": kernels, "source": [480, 640],
          "letterbox_ms_one_thread": letterbox_ms, "intraop_threads": 1,
          "answers": "each equal to predict_pipeline's at some bucket size",
          "answer_variants_across_buckets": variants, "levels": levels,
          f"at_{threads}_intraop_threads": default_threads, "with_warmups": with_warmups,
          "http": http, "card": card})
    del model
    torch.cuda.empty_cache()
    return levels


EXPORT_BATCH = SERVE_BATCH  # the serve phase's batch
EXPORT_STEPS = 10  # timed calls of the artifact, eager and replayed, and of predict_pipeline
EXPORT_CLIENTS = (1, 64)
EXPORT_SECONDS = 1.0

# run by the export phase in a fresh python3: loads the artifact with the op
# registry alone (building a model or folding BNs raises), runs one batch and
# writes the detections with numpy
_FRESH_LOAD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import efficientdet_tpu_torch.models.detector as det
from efficientdet_tpu_torch.export import load_exported
from efficientdet_tpu_torch.ops import head_kernel, nms_kernel

def refuse(*args, **kwargs):
    raise AssertionError("loading the artifact built a model")

det.EfficientDet.__init__ = refuse
det.fuse_for_inference = refuse
predict, manifest = load_exported(sys.argv[2])
out = predict(torch.from_numpy(np.load(sys.argv[3])).cuda())
np.savez(sys.argv[4], *[t.cpu().numpy() for t in out])
print(json.dumps({"head_pointwise": head_kernel.head_pointwise_anchor_major.launches,
                  "nms_suppress": nms_kernel.suppression_keep_mask.launches}))
"""


def _close_detections(got, want, label):
    """Counts and classes exact, boxes within 1e-3 px, scores within 1e-5
    (the predictor phase's card-vs-CPU rule); returns the worst differences
    and whether the two are equal bit for bit."""
    got = [np.asarray(t.cpu() if hasattr(t, "cpu") else t) for t in got]
    want = [np.asarray(t.cpu() if hasattr(t, "cpu") else t) for t in want]
    rec = {"bit_for_bit": all(np.array_equal(g, w) for g, w in zip(got, want)),
           "num_valid": [int(v) for v in want[3]],
           "max_abs_dbox_px": float(np.abs(got[0] - want[0]).max()),
           "max_abs_dscore": float(np.abs(got[1] - want[1]).max())}
    if not (np.array_equal(got[3], want[3]) and np.array_equal(got[2], want[2])
            and rec["max_abs_dbox_px"] <= 1e-3 and rec["max_abs_dscore"] <= 1e-5):
        raise AssertionError(f"{label}: the detections differ: {rec}")
    return rec


def phase_export(et, hk, nk, card):
    """The .edz artifact: export D0@512 bf16 (batch 32) on the card, the loaded
    program eager and replayed against predict_pipeline, a fresh process,
    a CPU-made artifact on the card, and BatchingPredictor.from_artifact."""
    import dataclasses
    import shutil
    import zipfile

    import torch
    from efficientdet_tpu_torch import export as ex
    from efficientdet_tpu_torch.data.common import letterbox_hostside
    from efficientdet_tpu_torch.models.detector import init_weights
    from efficientdet_tpu_torch.utils.cuda_graph import GraphedCall

    root = os.path.join(ROOT, "efficientdet_tpu_torch", "_build", "smoke_export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    model, cfg = et.build_efficientdet(0, num_classes=90, dtype=torch.bfloat16, seed=0)
    model = et.fuse_for_inference(model)
    # threshold 0, as in the serve phase: all 1024 candidates valid, no empty answer
    ec = et.EvalConfig(score_threshold=0.0)
    t_phase = time.perf_counter()
    rec = {"model": "D0@512, 90 classes, random weights from seed 0, BN folded, bf16",
           "batch_size": EXPORT_BATCH, "score_threshold": 0.0}
    threads = torch.get_num_threads()
    try:
        # (a) export on the card, load, one call's launches
        path = os.path.join(root, "d0_b32.edz")
        t0 = time.perf_counter()
        ex.save_exported(path, model, EXPORT_BATCH, eval_config=ec)
        rec["export_s"] = time.perf_counter() - t0
        with zipfile.ZipFile(path) as zf:
            infos = zf.infolist()
        rec["artifact_mb"] = os.path.getsize(path) / 1e6
        rec["program_mb"] = sum(i.file_size for i in infos if i.filename == "program.pt2") / 1e6
        rec["weights_mb"] = sum(i.file_size for i in infos if i.filename.startswith("vars/")) / 1e6
        t0 = time.perf_counter()
        predict, manifest = ex.load_exported(path)
        rec["load_s"] = time.perf_counter() - t0
        rec["torch_version"] = manifest["torch_version"]
        rng = np.random.RandomState(7)
        size = cfg.image_size
        images = rng.randint(0, 256, (EXPORT_BATCH, size, size, 3)).astype(np.uint8)
        x = torch.from_numpy(images).cuda()
        hk.head_pointwise_anchor_major.launches = 0
        nk.suppression_keep_mask.launches = 0
        eager = predict(x)
        torch.cuda.synchronize()
        launches = {"head_pointwise": hk.head_pointwise_anchor_major.launches,
                    "nms_suppress": nk.suppression_keep_mask.launches}
        rec["launches_one_call"] = launches
        if launches != {"head_pointwise": 2, "nms_suppress": 1}:
            raise AssertionError(f"export: one artifact call launched {launches}, not 2 and 1")

        # (b) eager and replayed against predict_pipeline on the same fused model
        want = et.predict_pipeline(model, x, ec)
        rec["eager_vs_pipeline"] = _close_detections(eager, want, "artifact eager")
        graph = GraphedCall(predict, x, pool=torch.cuda.graph_pool_handle())
        replay = [t.clone() for t in graph(x)]
        rec["replay_vs_pipeline"] = _close_detections(replay, want, "artifact replay")
        device_ops, busy_ms, kernels = _traced(lambda: graph(x))
        if not (_has(kernels, "head_pw") and _has(kernels, "nms_suppress_kernel")):
            raise AssertionError(f"export: the replay's trace lacks a kernel: {kernels}")
        rec.update(replay_device_ops=device_ops, replay_device_busy_ms=busy_ms,
                   replay_port_kernels=kernels)

        def synced(fn):
            def call():
                fn()
                torch.cuda.synchronize()
            return call

        rec["ms"] = {"artifact_eager": _median_ms(synced(lambda: predict(x)), EXPORT_STEPS),
                     "artifact_replay": _median_ms(synced(lambda: graph(x)), EXPORT_STEPS),
                     "pipeline_eager": _median_ms(synced(lambda: et.predict_pipeline(model, x, ec)),
                                                  EXPORT_STEPS)}
        # the host's share of an eager call, without waiting for the card:
        # the artifact's adds the input dict's checks and the graph's
        # interpretation to the launches
        for name, fn in (("artifact_eager", lambda: predict(x)),
                         ("pipeline_eager", lambda: et.predict_pipeline(model, x, ec))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            rec[f"{name}_host_ms"] = (time.perf_counter() - t0) * 1e3 / 5
        torch.cuda.synchronize()
        del graph

        # (c) a fresh process loads the artifact and runs one batch
        np.save(os.path.join(root, "images.npy"), images)
        fresh = subprocess.Popen(
            [sys.executable, "-c", _FRESH_LOAD, ROOT, path, os.path.join(root, "images.npy"),
             os.path.join(root, "fresh.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        # (d) a slim artifact made on the CPU, on the card and on the CPU, f32
        slim_cfg = dataclasses.replace(et.ModelConfig.for_phi(0, num_classes=6, image_size=128),
                                       bifpn_width=16, bifpn_depth=2, head_depth=2)
        slim = init_weights(et.EfficientDet(slim_cfg), seed=0).eval()
        slim_path = os.path.join(root, "slim_cpu.edz")
        t0 = time.perf_counter()
        ex.save_exported(slim_path, slim, 2)
        slim_export_s = time.perf_counter() - t0
        slim_images = torch.from_numpy(rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8))
        dets = {}
        for key, dev in (("cuda", DEVICE), ("cpu", "cpu")):
            run, _ = ex.load_exported(slim_path, device=dev)
            dets[key] = [t.cpu() for t in run(slim_images.to(dev))]
        rec["cpu_made_artifact"] = {"export_s": slim_export_s, "exported_on": "cpu",
                                    "model": "slim D0 (width 16, depth 2), 128 px, 6 classes, f32",
                                    **_card_vs_cpu(dets, 2)}

        try:
            log, _ = fresh.communicate(timeout=300)
        finally:
            if fresh.poll() is None:
                fresh.kill()
        if fresh.returncode != 0:
            raise AssertionError(f"export: the fresh process failed:\n{log}")
        with np.load(os.path.join(root, "fresh.npz")) as z:
            fresh_out = [z[f"arr_{i}"] for i in range(4)]
        rec["fresh_process"] = {"launches": json.loads(log.strip().splitlines()[-1]),
                                **_close_detections(fresh_out, want, "fresh process")}

        # BatchingPredictor.from_artifact: closed loops at C = 1 and 64 on 480x640 sources
        torch.set_num_threads(1)  # serve.main's setting on the card
        pred = et.BatchingPredictor.from_artifact(path, max_delay_ms=5.0, pipeline_depth=2)
        try:
            t0 = time.perf_counter()
            pred.warmup()
            rec["serve_warmup_s"] = time.perf_counter() - t0
            srcs = [rng.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(16)]
            canvases = [letterbox_hostside(im, size) for im in srcs]
            # every request pads to the exported batch: one answer per source
            # (batch neighbours do not change an image's detections)
            expected = [None] * len(srcs)
            order = [j % len(srcs) for j in range(-(-len(srcs) // EXPORT_BATCH) * EXPORT_BATCH)]
            for start in range(0, len(order), EXPORT_BATCH):
                idx = order[start:start + EXPORT_BATCH]
                batch = torch.from_numpy(np.stack([canvases[j][0] for j in idx])).cuda()
                bx, sc, cl, nv = (t.cpu().numpy() for t in et.predict_pipeline(model, batch, ec))
                for r, j in enumerate(idx):
                    k = int(nv[r])
                    expected[j] = expected[j] or [(bx[r, :k] / canvases[j][1], sc[r, :k], cl[r, :k])]
            rec["serve"] = {"buckets": pred._buckets, "source": [480, 640], "intraop_threads": 1,
                            "levels": [_closed_loop(pred, srcs, expected, c, EXPORT_SECONDS)
                                       for c in EXPORT_CLIENTS],
                            "answers": "each equal to predict_pipeline's detections of its source"}
        finally:
            pred.close()
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "export", **rec, "elapsed_s": time.perf_counter() - t_phase, "card": card})
    del model
    torch.cuda.empty_cache()
    return launches


def _bench_train_batch(size, batch, seed=0):
    """The JAX package's tools/bench_train.py batch: uint8 noise images,
    TRAIN_GT boxes an image of 16-64 px, 90 classes, TRAIN_MAX_GT slots; the
    same draws from the same numpy seed."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, TRAIN_MAX_GT, 4), np.float32)
    labels = np.full((batch, TRAIN_MAX_GT), -1, np.int32)
    x1 = rng.uniform(0, size - 64, (batch, TRAIN_GT))
    y1 = rng.uniform(0, size - 64, (batch, TRAIN_GT))
    boxes[:, :TRAIN_GT, 0] = x1
    boxes[:, :TRAIN_GT, 1] = y1
    boxes[:, :TRAIN_GT, 2] = x1 + rng.uniform(16, 64, (batch, TRAIN_GT))
    boxes[:, :TRAIN_GT, 3] = y1 + rng.uniform(16, 64, (batch, TRAIN_GT))
    labels[:, :TRAIN_GT] = rng.randint(0, 90, (batch, TRAIN_GT))
    images = rng.randint(0, 256, (batch, size, size, 3)).astype(np.uint8)
    return {"images": images, "gt_boxes": boxes, "gt_labels": labels}


def _launch_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def _train_timed(et, dtype, batch, kernels, card, remat=False, phi=0,
                 warmup=TRAIN_WARMUP, steps=TRAIN_STEPS):
    """D``phi`` at the batch's size (D0@512 at TRAIN_BATCH unless told):
    ``warmup`` + ``steps`` steps on one batch, the timed ones fenced by
    torch.cuda.synchronize(); the launch counters set to 0 before and read
    after (the training path runs no kernel of the port). Returns the record
    and the trained model and state."""
    import torch

    n_img, size = batch["images"].shape[:2]
    model, cfg = et.build_efficientdet(phi, num_classes=90, dtype=dtype, seed=0, remat=remat,
                                       image_size=size)
    tc = et.TrainConfig(batch_size=n_img, max_gt_boxes=TRAIN_MAX_GT)
    state = et.create_train_state(model, tc)
    step = et.make_train_step(model, tc)
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    metrics = []
    t_first = time.perf_counter()
    for _ in range(warmup):
        state, m = step(state, batch, gen)
        metrics.append(m)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t_first
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch, gen)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _launch_counts(kernels)
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    timed = losses[warmup:]
    rec = {"model": f"D{phi}@{size}", "dtype": str(dtype).replace("torch.", ""), "batch": n_img,
           "remat": remat,
           "tf32": torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32,
           "warmup_steps": warmup, "warmup_s": warmup_s, "steps": steps,
           "img_s": steps * n_img / dt, "ms_per_step": dt / steps * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": losses, "grad_norm": norms,
           "cls_loss_last": float(metrics[-1]["cls_loss"]), "box_loss_last": float(metrics[-1]["box_loss"]),
           "num_positives": float(metrics[-1]["num_positives"]), "kernel_launches": launches,
           "card": card}
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"train {rec['model']} {rec['dtype']}: a non-finite loss or gradient norm: {rec}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"train {rec['model']} {rec['dtype']}: the last timed loss is not below the first: {timed}")
    return rec, model, state, step, gen


def _slim_train_case(et):
    """tests/conftest.py's ``slim_d0`` (B0, BiFPN and heads at width 16,
    depth 2, 128 px, 6 classes; survival 1.0) with drawn weights and a
    uint8 batch of 2: ``_train_card_vs_cpu``'s arguments."""
    import dataclasses

    cfg = dataclasses.replace(et.ModelConfig.for_phi(0, num_classes=6, image_size=128),
                              bifpn_width=16, bifpn_depth=2, head_depth=2, survival_prob=1.0)
    weights = drawn_state_dict(et.EfficientDet(cfg), seed=0)
    batch = _bench_train_batch(128, 2, seed=4)
    batch["gt_labels"] = np.where(batch["gt_labels"] >= 0, batch["gt_labels"] % 6, -1).astype(np.int32)
    batch["gt_boxes"] = np.clip(batch["gt_boxes"], 0, 127)
    label = "slim D0: B0, BiFPN/heads width 16 depth 2, 128 px, 6 classes, survival 1.0"
    return cfg, weights, batch, label, False


def _train_card_vs_cpu(et, cfg, weights, batch, label, deep, devices=("cuda", "cpu")):
    """One f32 step (TF32 off) of ``cfg`` from ``weights`` on ``batch`` on
    the card and on the CPU, held by efficientdet_tpu_torch/parallel/
    tolerances.py. Not ``deep``: the tier-1 rules (``step_errors``: loss
    1e-5 relative, the gradient 1e-4 of each leaf's largest plus 1e-6 of
    the model's, BN statistics 1e-5). ``deep`` (D4/D7, where float32
    rounding alone moves the gradients past those rules): both devices
    also step in float64; the two float64 steps are held to each other by
    ``step_errors`` at FLOAT64_SCALE, and the card's float32 step (the
    CPU's reported beside it) against the CPU's float64 step by
    ``deep_step_errors`` (loss, BN statistics, the gradient norm within
    1e-2). The batch's images are float32, which every step takes as
    normalised."""
    import torch

    from efficientdet_tpu_torch.parallel import tolerances as T

    runs = [("card", devices[0], torch.float32), ("cpu", devices[1], torch.float32)]
    if deep:
        runs += [("card_float64", devices[0], torch.float64), ("cpu_float64", devices[1], torch.float64)]
    tc = et.TrainConfig(batch_size=len(batch["images"]))
    out = {}
    for name, dev, dtype in runs:
        model = et.EfficientDet(cfg, dtype).to(dtype)
        model.load_state_dict(weights)
        model.to(dev)
        state = et.create_train_state(model, tc, device=dev)
        state, m = et.make_train_step(model, tc, device=dev)(state, batch)
        out[name] = _step_outputs(state, m)
        del model, state
    rec = {"model": label, "batch": len(batch["images"]), "dtype": "float32, TF32 off",
           "loss": {k: v[0]["loss"] for k, v in out.items()},
           "grad_norm": {k: v[0]["grad_norm"] for k, v in out.items()},
           "num_positives": out["cpu"][0]["num_positives"]}
    if deep:
        exact = out["cpu_float64"]
        rec["errors_over_tolerance"] = T.deep_step_errors(out["card"], exact, lr=tc.learning_rate)
        rec["cpu_float32_errors_over_tolerance"] = T.deep_step_errors(out["cpu"], exact, lr=tc.learning_rate)
        rec["float64_errors_over_tolerance"] = T.step_errors(out["card_float64"], exact,
                                                             lr=tc.learning_rate, scale=T.FLOAT64_SCALE)
        held = (T.step_holds(rec["errors_over_tolerance"], T.DEEP_HELD)
                and T.step_holds(rec["float64_errors_over_tolerance"]))
    else:
        rec["errors_over_tolerance"] = T.step_errors(out["card"], out["cpu"], lr=tc.learning_rate)
        held = T.step_holds(rec["errors_over_tolerance"], ("loss", "grad_norm", "grad", "bn_stats"))
    if not held or not rec["num_positives"] > 0:
        raise AssertionError(f"train: card and CPU steps differ: {rec}")
    return rec


def phase_train(et, kernels, card, profile_dir):
    """The training step at D0@512 batch 64, f32 (TF32 off) and bf16; the
    card against the CPU on the slim model; the trained weights through
    CheckpointManager, Predictor.from_checkpoint and the main path."""
    import shutil

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = _bench_train_batch(TRAIN_SIZE, TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    runs = {}
    f32, model, state, step, gen = _train_timed(et, torch.float32, batch, kernels, card)
    runs["f32"] = f32
    profile = None
    if profile_dir:
        holder = {"state": state}

        def one_step():
            holder["state"], _ = step(holder["state"], batch, gen)

        profile = _profile(one_step, profile_dir, f32["ms_per_step"], calls=2,
                           trace="train_trace.json.gz")
        state = holder["state"]
    runs["bf16"] = _train_timed(et, torch.bfloat16, batch, kernels, card)[0]
    torch.cuda.empty_cache()
    # what remat (remat_scope "full", every stage) costs in time and saves in memory
    runs["f32_remat"] = _train_timed(et, torch.float32, batch, kernels, card, remat=True)[0]
    torch.cuda.empty_cache()
    for rec in runs.values():
        emit({"phase": "train_run", **rec})

    vs_cpu = _train_card_vs_cpu(et, *_slim_train_case(et))

    # the trained weights: CheckpointManager -> Predictor.from_checkpoint
    # inside the checkout, in the kernels' build directory (not committed)
    ckpt = os.path.join(ROOT, "efficientdet_tpu_torch", "_build", "smoke_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        mgr = et.CheckpointManager(ckpt, keep=1)
        mgr.save(state.step, state, {"loss": runs["f32"]["loss"][-1]})
        rng = np.random.RandomState(6)
        img = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
        loaded = et.Predictor.from_checkpoint(ckpt, phi=0, dtype="f32", score_threshold=0.0)
        memory = et.Predictor(phi=0, dtype="f32", score_threshold=0.0,
                              variables={k: v.detach() for k, v in model.state_dict().items()})
        replay, eager, in_memory = loaded(img), loaded.eager(img), memory.eager(img)
        if not all(np.array_equal(a, b) and np.array_equal(a, c)
                   for a, b, c in zip(replay, eager, in_memory)) or not len(replay[1]):
            raise AssertionError("train: the checkpoint's Predictor differs from the trained model")
        if not _valid(replay, 90):
            raise AssertionError("train: invalid detections from the trained weights")
        restored = mgr.restore(et.create_train_state(loaded.model, et.TrainConfig(
            batch_size=TRAIN_BATCH, max_gt_boxes=TRAIN_MAX_GT)))
        if restored.step != state.step or restored.opt_state["count"] != state.opt_state["count"]:
            raise AssertionError("train: the restored state's counts differ")
        del loaded, memory, restored
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    # the trained weights through the main path: fused, both kernels
    fused = et.fuse_for_inference(model.eval())
    images = batch["images"][:CHECK_BATCH]
    for fn in kernels.values():
        fn.launches = 0
    dets = et.predict_pipeline(fused, images)
    torch.cuda.synchronize()
    main_launches = _launch_counts(kernels)
    n = _check_detections(dets, 90, CHECK_BATCH)
    if main_launches["head_pointwise"] != 2 or main_launches["nms_suppress"] != 1:
        raise AssertionError(f"train: the trained model's main path missed a kernel: {main_launches}")
    rec = {"phase": "train", "model": "D0@512, 90 classes, random weights from seed 0",
           "config": "TrainConfig defaults (Adam 1e-3, per-level loss), batch 64, "
                     "tools/bench_train.py's batch (seed 0, 12 boxes an image)",
           "f32": {k: runs["f32"][k] for k in ("img_s", "ms_per_step", "peak_mem_gb", "remat", "tf32")},
           "bf16": {k: runs["bf16"][k] for k in ("img_s", "ms_per_step", "peak_mem_gb", "remat", "tf32")},
           "f32_remat": {k: runs["f32_remat"][k]
                         for k in ("img_s", "ms_per_step", "peak_mem_gb", "remat", "tf32")},
           "launches_in_training": {d: runs[d]["kernel_launches"] for d in runs},
           "card_vs_cpu": vs_cpu, "checkpoint": "Predictor.from_checkpoint replay == eager() == "
           "the in-memory model", "trained_main_path_launches": main_launches,
           "trained_num_valid": [int(v) for v in n], "card": card}
    emit(rec)
    if profile:
        emit({"phase": "train_profile", "dtype": "float32", "batch": TRAIN_BATCH, **profile})
    del model, state, step, fused, batch
    torch.cuda.empty_cache()
    return rec


# the data-fed training phases: an in-memory dataset made with numpy (seed 0)
DATA_IMAGES = 256
DATA_SHAPES = PREDICT_SHAPES  # the predictor phase's five source shapes (h, w)
DATA_BATCH = 64
DATA_WORKERS = 8
DATA_BATCHES = 3  # timed batches per pipeline configuration, after one warm-up
CLI_EPOCHS = 2
CLI_STEPS = 5
EVAL_IMAGES = 64
DEVICE = "cuda"  # the data and export phases' device (a rehearsal on the CPU sets "cpu")


def _smoke_dataset(et, n=DATA_IMAGES, seed=0):
    """``n`` noise images over ``DATA_SHAPES``, 1-20 boxes an image of 16-256
    px sides inside the image, 90 classes; a COCO-style index (category id =
    label + 1, image id = index) for ``evaluate_coco``."""

    class SmokeDataset(et.DetectionDataset):
        def __init__(self):
            rng = np.random.RandomState(seed)
            self.images, self.anns, annotations = [], [], []
            for i in range(n):
                h, w = DATA_SHAPES[i % len(DATA_SHAPES)]
                self.images.append(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
                k = rng.randint(1, 21)
                bw = rng.uniform(16, min(256, w - 2), k)
                bh = rng.uniform(16, min(256, h - 2), k)
                x1 = rng.uniform(0, w - 1 - bw)
                y1 = rng.uniform(0, h - 1 - bh)
                boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)
                labels = rng.randint(0, 90, k).astype(np.int32)
                self.anns.append((boxes, labels))
                annotations += [{"image_id": i, "category_id": int(c) + 1, "iscrowd": 0,
                                 "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])],
                                 "area": float((b[2] - b[0]) * (b[3] - b[1]))}
                                for b, c in zip(boxes, labels)]
            self.cat_ids = list(range(1, 91))
            self.label_to_coco_label = {i: i + 1 for i in range(90)}
            self.coco = type("CocoIndex", (), {"dataset": {"annotations": annotations}})()

        def __len__(self):
            return len(self.images)

        def load_image(self, index):
            return self.images[index]

        def load_annotations(self, index):
            return self.anns[index]

        def num_classes(self):
            return 90

        def image_aspect_ratio(self, index):
            h, w = self.images[index].shape[:2]
            return w / h

    return SmokeDataset()


def _head(ds, k):
    """The first ``k`` images of ``ds`` as a dataset of its own class."""
    sub = object.__new__(type(ds))
    sub.__dict__.update(ds.__dict__)
    sub.images, sub.anns = ds.images[:k], ds.anns[:k]
    sub.coco = type("CocoIndex", (), {"dataset": {"annotations": [
        a for a in ds.coco.dataset["annotations"] if a["image_id"] < k]}})()
    return sub


def _pipeline_ms(et, ds, size, **kw):
    """ms per batch of DATA_BATCH from batch_iterator (its first batch, which
    starts the pool and builds the colour tables, apart)."""
    it = et.batch_iterator(ds, DATA_BATCH, target_size=size, max_gt=TRAIN_MAX_GT, repeat=True,
                           seed=1, **kw)
    t0 = time.perf_counter()
    next(it)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(DATA_BATCHES):
        next(it)
    dt = (time.perf_counter() - t0) / DATA_BATCHES
    it.close()
    return {"ms_per_batch": dt * 1e3, "img_s": DATA_BATCH / dt, "first_batch_ms": first * 1e3}


def _with_threads(n, fn):
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)


def phase_data(et, card):
    """The host pipeline's ms per batch of 64 (workers 0; workers 8 with the
    default intra-op threads and with one; the host augmenter with workers
    8), the DeviceDataCache pool against batch_iterator's canvases, the
    gather, the device augmenter at batch 64 (card against CPU on the same
    draws, two card runs equal) and the native IoU library."""
    import torch

    from efficientdet_tpu_torch.data.augment import make_augmenter
    from efficientdet_tpu_torch.data.device_cache import DeviceDataCache
    from efficientdet_tpu_torch.evaluation import host_overlap
    from efficientdet_tpu_torch.ops import augment as dev_aug

    t0 = time.perf_counter()
    ds = _smoke_dataset(et)
    make_s = time.perf_counter() - t0
    size = TRAIN_SIZE
    threads = torch.get_num_threads()
    pipe = {"workers0": _pipeline_ms(et, ds, size),
            "workers8_default_threads": _pipeline_ms(et, ds, size, workers=DATA_WORKERS),
            "workers8_one_thread": _with_threads(1, lambda: _pipeline_ms(et, ds, size, workers=DATA_WORKERS))}
    one = pipe["workers8_one_thread"]["ms_per_batch"] < pipe["workers8_default_threads"]["ms_per_batch"]
    t0 = time.perf_counter()
    augment = make_augmenter()  # makes the colour tables, once a process
    tables_s = time.perf_counter() - t0
    pipe["augmenter_workers8_default_threads"] = _pipeline_ms(
        et, ds, size, workers=DATA_WORKERS, augment=augment)
    pipe["augmenter_workers8_one_thread"] = _with_threads(1, lambda: _pipeline_ms(
        et, ds, size, workers=DATA_WORKERS, augment=augment))

    t0 = time.perf_counter()
    cache = DeviceDataCache(ds, size, max_gt=TRAIN_MAX_GT, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for batch in et.batch_iterator(ds, DATA_BATCH, target_size=size, max_gt=TRAIN_MAX_GT,
                                   shuffle=False, drop_last=False):
        got = cache.get_batch(batch["indices"])
        for k in ("images", "gt_boxes", "gt_labels", "extents", "scales"):
            if not np.array_equal(got[k].cpu().numpy(), batch[k]):
                raise AssertionError(f"data: the cache's {k} differ from batch_iterator's")
    idx = np.random.RandomState(2).permutation(len(ds))[:DATA_BATCH]
    get_ms = cuda_ms(lambda: cache.get_batch(idx))

    batch = cache.get_batch(idx)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    mats = dev_aug.sample_transform_matrices(gen, DATA_BATCH, size, extents=batch["extents"], device=DEVICE)
    factors = dev_aug.sample_color_factors(gen, DATA_BATCH, device=DEVICE)

    def apply():
        return dev_aug.apply_augment(batch["images"], batch["gt_boxes"], batch["gt_labels"],
                                     batch["extents"], mats, factors)

    a, b = apply(), apply()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("data: two runs of the device augmenter differ")
    aug_ms = cuda_ms(apply, iters=5, warmup=1)
    aug_device_ms = sum(kernel_ms(apply, calls=2).values())
    cpu = dev_aug.apply_augment(*(t.cpu() for t in (batch["images"], batch["gt_boxes"], batch["gt_labels"],
                                                   batch["extents"], mats)),
                                {k: v.cpu() for k, v in factors.items()})
    img_err = float((a[0].cpu() - cpu[0]).abs().max())
    box_err = float((a[1].cpu() - cpu[1]).abs().max())
    labels_equal = bool(torch.equal(a[2].cpu(), cpu[2]))
    # images within 2e-3 of their [0, 255] scale (0.51 grey levels): on noise
    # images a float32 coordinate a few ulps apart at 512 px moves a sample
    # by up to 255 x 1e-4
    if img_err > 2e-3 * 255 or box_err > 1e-4 or not labels_equal:
        raise AssertionError(f"data: the device augmenter's card and CPU results differ: images {img_err}, "
                             f"boxes {box_err}, labels equal {labels_equal}")

    if not host_overlap.using_native():
        raise AssertionError(f"data: the native IoU library did not build: {host_overlap.build_error}")
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 500, (2, 500, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(-5, 200, (2, 500, 2))], -1)
    if not np.array_equal(host_overlap.compute_overlap(boxes[0], boxes[1]),
                          host_overlap.compute_overlap_numpy(boxes[0], boxes[1])):
        raise AssertionError("data: the native IoU differs from numpy")
    rec = {"phase": "data", "images": len(ds), "shapes": DATA_SHAPES, "make_dataset_s": make_s,
           "batch": DATA_BATCH, "target_size": size, "intra_op_threads_default": threads,
           "pipeline": pipe, "faster_workers8": "one thread" if one else "default threads",
           "color_tables_s": tables_s,
           "cache_build_s": build_s, "cache_mb": cache.nbytes() / 1e6,
           "cache_equals_batch_iterator": True, "get_batch_ms": get_ms,
           "device_augment": {"batch": DATA_BATCH, "ms": aug_ms, "device_ms": aug_device_ms,
                              "card_vs_cpu": {"images_max_abs": img_err, "boxes_max_abs": box_err,
                                              "labels_equal": labels_equal,
                                              "tolerance": "images 2e-3 x 255, boxes 1e-4 px, labels exact"},
                              "two_runs_equal": True},
           "native_iou": True, "card": card}
    emit(rec)
    del cache, batch, a, b, cpu
    torch.cuda.empty_cache()
    return rec, ds


class _StepClock:
    """on_step for train_from_datasets: each step's interval (ending in a
    synchronize), its loss and gradient norm, and a torch.profiler window over
    two steps (``profile_at``: the step after which it starts)."""

    def __init__(self, profile_at=3):
        self.intervals, self.losses, self.norms = [], [], []
        self.profile_at, self.prof, self.prof_t0, self.idle = profile_at, None, None, None
        self.t = None

    def __call__(self, epoch, s, state, metrics):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        now = time.perf_counter()
        n = len(self.losses)
        # the interval before the first step of a later epoch holds the
        # epoch's evaluation and checkpoint: not a step
        self.intervals.append(None if self.t is None or s == 0 else now - self.t)
        self.losses.append(float(metrics["loss"]))
        self.norms.append(float(metrics["grad_norm"]))
        if n + 1 == self.profile_at and s + 2 < CLI_STEPS:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.prof_t0 = time.perf_counter()
        elif self.prof is not None and n + 1 == self.profile_at + 2:
            wall = (time.perf_counter() - self.prof_t0) * 1e3
            self.prof.stop()
            busy = 0.0
            for ev in self.prof.key_averages():
                if ev.device_type == DeviceType.CUDA:
                    dev = getattr(ev, "self_device_time_total", None)
                    busy += (ev.self_cuda_time_total if dev is None else dev) / 1e3
            self.idle = {"steps": 2, "wall_ms": wall, "device_busy_ms": busy,
                         "idle_share": max(0.0, 1.0 - busy / wall)}
            self.prof = None
        self.t = time.perf_counter()

    def record(self, batch):
        timed = [x for x in self.intervals[2:] if x is not None]
        ms = float(np.mean(timed)) * 1e3
        return {"ms_per_step": ms, "img_s": batch / ms * 1e3, "timed_steps": len(timed),
                "loss": self.losses, "grad_norm": self.norms, "profile": self.idle}


def _cli_args(et_train, snapshot, *extra):
    return et_train.parse_args(["coco", "unused", "--device", DEVICE, "--phi", "0", "--image-size", str(TRAIN_SIZE),
                                "--batch-size", str(TRAIN_BATCH), "--epochs", str(CLI_EPOCHS),
                                "--steps", str(CLI_STEPS), "--max-gt", str(TRAIN_MAX_GT),
                                "--snapshot-path", snapshot, *extra])


def phase_train_cli(et, kernels, card, ds):
    """train.train_from_datasets (the CLI's loop) at D0@512 batch 64 f32 for
    2 epochs of 5 steps: (a) --workers 0, (b) --workers 8, (c)
    --random-transform --workers 8, (d) --device-cache 256 --device-augment
    with the epoch-end COCO evaluation on 64 images; then the evaluation's
    host/card split, an oracle at AP 1, the plateau's LR cut, the snapshots
    and evaluate.py on them; then train.main on PNG files where the host
    has an image library."""
    import shutil

    import torch

    from efficientdet_tpu_torch import evaluate as et_evaluate
    from efficientdet_tpu_torch import train as et_train
    from efficientdet_tpu_torch.evaluation.coco_eval import evaluate_coco, make_batch_predict_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = os.path.join(ROOT, "efficientdet_tpu_torch", "_build")
    val = _head(ds, EVAL_IMAGES)
    configs = {"a_host_workers0": ("--no-eval", "--workers", "0"),
               "b_host_workers8": ("--no-eval", "--workers", str(DATA_WORKERS)),
               "c_random_transform_workers8": ("--no-eval", "--random-transform", "--workers",
                                               str(DATA_WORKERS)),
               "d_device_cache_augment": ("--device-cache", str(DATA_IMAGES), "--device-augment",
                                          "--reduce-lr-patience", "1")}
    runs = {}
    for name, extra in configs.items():
        snap = os.path.join(build, f"smoke_cli_{name}")
        shutil.rmtree(snap, ignore_errors=True)
        args = _cli_args(et_train, snap, *extra)
        clock = _StepClock()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        model, state, history = et_train.train_from_datasets(args, ds, val if name.startswith("d") else None,
                                                      on_step=clock)
        torch.cuda.synchronize()
        rec = {"config": " ".join(extra), "wall_s": time.perf_counter() - t0, **clock.record(TRAIN_BATCH),
               "launches": _launch_counts(kernels), "history": history}
        if not (np.isfinite(rec["loss"]).all() and np.isfinite(rec["grad_norm"]).all()):
            raise AssertionError(f"train_cli {name}: a non-finite loss or gradient norm: {rec}")
        if not rec["loss"][-1] < rec["loss"][0]:
            raise AssertionError(f"train_cli {name}: the last loss is not below the first: {rec['loss']}")
        if name.startswith("d"):
            steps = sorted(int(d) for d in os.listdir(snap) if d.isdigit())
            if steps != [CLI_STEPS, 2 * CLI_STEPS]:
                raise AssertionError(f"train_cli: the snapshots are {steps}")
            if not (rec["launches"]["head_pointwise"] > 0 and rec["launches"]["nms_suppress"] > 0):
                raise AssertionError(f"train_cli: the epoch evaluation missed a kernel: {rec['launches']}")
            maps = [h["mAP"] for h in history]
            if not (maps[1] <= maps[0] and history[-1]["lr_scale"] < 1.0):
                raise AssertionError(f"train_cli: no plateau cut with patience 1: {history}")
            with open(os.path.join(snap, "train_log.jsonl")) as f:
                rec["eval_stats"] = [json.loads(line) for line in f if '"AP"' in line]
            model_d, state_d, snap_d = model, state, snap
        runs[name] = rec
        emit({"phase": "train_cli_run", "name": name, **{k: v for k, v in rec.items() if k != "history"},
              "history": history, "card": card})
        if not name.startswith("d"):
            shutil.rmtree(snap, ignore_errors=True)
        del model, state
        torch.cuda.empty_cache()

    # the epoch evaluation once more, its host and card time apart
    card_s = []

    def timed(predict):
        def fn(images):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = predict(images)
            torch.cuda.synchronize()
            card_s.append(time.perf_counter() - t0)
            return out
        return fn

    for fn in kernels.values():
        fn.launches = 0
    with et_train.eval_weights(model_d, state_d):
        t0 = time.perf_counter()
        stats = evaluate_coco(val, timed(make_batch_predict_fn(model_d)), TRAIN_SIZE, batch_size=TRAIN_BATCH,
                              max_images=500)
        total_s = time.perf_counter() - t0
    eval_launches = _launch_counts(kernels)
    if not (eval_launches["head_pointwise"] > 0 and eval_launches["nms_suppress"] > 0):
        raise AssertionError(f"train_cli: the evaluation missed a kernel: {eval_launches}")
    if abs(stats["AP"] - runs["d_device_cache_augment"]["history"][-1]["mAP"]) > 1e-6:
        raise AssertionError(f"train_cli: the evaluation's AP {stats['AP']} differs from the loop's")

    def oracle(images):
        """Each canvas's ground truth, letterboxed: the batch is the first
        len(images) images in order (shuffle off)."""
        b = len(images)
        boxes = torch.zeros((b, TRAIN_MAX_GT, 4))
        scores = torch.zeros((b, TRAIN_MAX_GT))
        classes = torch.zeros((b, TRAIN_MAX_GT), dtype=torch.int32)
        n = torch.zeros((b,), dtype=torch.int32)
        for i in range(b):
            img = val.load_image(i)
            gb, gl = val.filter_annotations(*val.load_annotations(i), img.shape[:2])
            k = len(gb)
            boxes[i, :k] = torch.from_numpy(gb) * (TRAIN_SIZE / max(img.shape[:2]))
            scores[i, :k] = 1.0
            classes[i, :k] = torch.from_numpy(gl)
            n[i] = k
        return boxes, scores, classes, n

    oracle_stats = evaluate_coco(val, oracle, TRAIN_SIZE, batch_size=EVAL_IMAGES)
    if abs(oracle_stats["AP"] - 1.0) > 1e-12:
        raise AssertionError(f"train_cli: the oracle's AP is {oracle_stats['AP']}, not 1")

    # evaluate.py's function on the snapshots of (d), with the loop's EvalConfig
    eargs = et_evaluate.parse_args(["coco", "unused", "--device", DEVICE, "--snapshot", snap_d, "--dtype", "f32",
                                    "--batch-size", str(TRAIN_BATCH), "--fast-eval"])
    restored = et_evaluate.evaluate_snapshot(eargs, val)
    if any(abs(restored[k] - stats[k]) > 1e-6 for k in stats):
        raise AssertionError(f"train_cli: evaluate.py's AP {restored} differs from the loop's {stats}")
    shutil.rmtree(snap_d, ignore_errors=True)
    del model_d, state_d
    torch.cuda.empty_cache()

    files = _train_cli_files(et_train, ds, build)
    card_ms = sum(card_s) * 1e3
    rec = {"phase": "train_cli", "model": "D0@512, 90 classes, f32 (TF32 off), batch 64, random weights",
           "epochs": CLI_EPOCHS, "steps_per_epoch": CLI_STEPS,
           "runs": {k: {"ms_per_step": r["ms_per_step"], "img_s": r["img_s"],
                        "idle_share": (r["profile"] or {}).get("idle_share"),
                        "loss_first_last": [r["loss"][0], r["loss"][-1]]} for k, r in runs.items()},
           "eval": {"images": EVAL_IMAGES, "batch": TRAIN_BATCH, "ms_per_image": total_s * 1e3 / EVAL_IMAGES,
                    "card_ms_per_image": card_ms / EVAL_IMAGES,
                    "host_ms_per_image": (total_s * 1e3 - card_ms) / EVAL_IMAGES,
                    "launches": eval_launches, "stats": stats},
           "loop_eval_launches": runs["d_device_cache_augment"]["launches"],
           "oracle_AP": oracle_stats["AP"], "plateau_lr_scale": runs["d_device_cache_augment"]["history"][-1]["lr_scale"],
           "evaluate_py": "restored the snapshots, same AP", "files": files, "card": card}
    emit(rec)
    return rec


def _train_cli_files(et_train, ds, build):
    """train.main on a CSV dataset of PNG files (1 epoch of 2 steps, batch 8)
    where PIL or cv2 reads them on this host; else a record that it could
    not run."""
    import importlib.util
    import shutil

    host_modules = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2")}
    emit({"phase": "train_cli_files_host", "host_modules": host_modules})
    if not any(host_modules.values()):
        return {"run": False, "why": "neither PIL nor cv2 imports on this host: "
                                     "the file-reading run was not possible"}
    root = os.path.join(build, "smoke_cli_files")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rows = []
    for i in range(16):
        img = ds.load_image(i)
        with open(os.path.join(root, f"img{i}.png"), "wb") as f:
            f.write(_png_bytes(img))
        for b, c in zip(*ds.load_annotations(i)):
            rows.append(f"img{i}.png,{b[0]:.3f},{b[1]:.3f},{b[2]:.3f},{b[3]:.3f},class{c}")
    with open(os.path.join(root, "annots.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "classes.csv"), "w") as f:
        f.write("".join(f"class{c},{c}\n" for c in range(90)))
    t0 = time.perf_counter()
    state = et_train.main(["csv", os.path.join(root, "annots.csv"), os.path.join(root, "classes.csv"),
                           "--image-size", str(TRAIN_SIZE), "--batch-size", "8", "--epochs", "1",
                           "--steps", "2", "--workers", str(DATA_WORKERS), "--device", DEVICE,
                           "--snapshot-path", os.path.join(root, "ckpt")])
    out = {"run": True, "host_modules": host_modules, "steps": int(state.step),
           "wall_s": time.perf_counter() - t0}
    shutil.rmtree(root, ignore_errors=True)
    if out["steps"] != 2:
        raise AssertionError(f"train_cli: the file-reading run took {out['steps']} steps")
    return out


# phase parallel: data and spatial parallelism (parallel/)
PAR_PREDICT_BATCH = BENCH_BATCH  # sharded predict at world size 1, bf16, BN folded
PAR_TRAIN_BATCH = TRAIN_BATCH  # sharded train step at world size 1, f32
PAR_TRAIN_STEPS = 4  # timed steps (after the compared one and a warm-up), sharded and one-process
PAR_RANKS = 2  # gloo ranks on the one card
PAR_GLOBAL_BATCH = 16  # the two-rank sharded step's global batch
PAR_SPATIAL_BATCH = 2  # spatial predict and step
PAR_CACHE_IMAGES = 37  # an odd pool: the sharded cache wrap-pads it
PAR_TIMEOUT = 420  # seconds the two ranks may take, start-up included


def _step_outputs(state, metrics):
    """What a step leaves, on the host: metrics, Adam's first moments (0.1
    g after one step), BN statistics and parameters."""
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.detach().cpu() for k, v in state.opt_state["mu"].items()},
            {k: v.detach().cpu() for k, v in state.batch_stats.items()
             if not k.endswith("num_batches_tracked")},
            {k: v.detach().cpu() for k, v in state.params.items()})


def _compare_steps(got, want, scale=1.0):
    """Two ``_step_outputs`` by the CPU tests' rules
    (efficientdet_tpu_torch/parallel/tolerances.py ``step_errors``; ``scale``
    FLOAT64_SCALE for float64 steps): each error over its tolerance (<= 1
    holds), the worst gradient leaf with its largest |g| and the model's,
    and whether the parameters are equal bit for bit."""
    import torch

    from efficientdet_tpu_torch.configs import TrainConfig
    from efficientdet_tpu_torch.parallel.tolerances import step_errors

    cmp = step_errors(got, want, lr=TrainConfig().learning_rate, scale=scale)
    mu = want[1]
    cmp["grad_worst_leaf_max"] = float(mu[cmp["grad_worst_leaf"]].abs().max()) / 0.1
    cmp["model_max_grad"] = max(float(v.abs().max()) for v in mu.values()) / 0.1
    cmp["params_bit_for_bit"] = all(torch.equal(got[3][k], v) for k, v in want[3].items())
    return cmp


def _step_ok(cmp):
    """A float32 step against another in everything but the raw gradient:
    at D0@512 float32 regrouping alone moves one BiFPN leaf's gradient past
    the slim model's tolerance (PERF.md, PR 9), so the two-rank steps hold
    their gradients against a float64 step instead (``grad_against_exact``),
    and the world-size-1 steps at batch 64, which have no float64 reference
    (about twice their 43 GB), report theirs."""
    from efficientdet_tpu_torch.parallel.tolerances import step_holds

    return step_holds(cmp, ("loss", "grad_norm", "bn_stats", "params"))


def _close_dets(got, want, box_tol=1e-3, score_tol=1e-5):
    """Counts and classes exact, boxes and scores within the gpu_vs_cpu rule;
    whether bit for bit."""
    import torch

    got = [t.cpu() for t in got]
    want = [t.cpu() for t in want]
    box = float((got[0] - want[0]).abs().max())
    score = float((got[1].float() - want[1].float()).abs().max())
    rec = {"counts_classes_exact": bool(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])),
           "box_err_px": box, "score_err": score,
           "bit_for_bit": all(torch.equal(a, b) for a, b in zip(got, want))}
    rec["ok"] = rec["counts_classes_exact"] and box <= box_tol and score <= score_tol
    return rec


def _eval_grads(et, host, mesh=None):
    """Eval-mode (running BN) gradients of the detection loss of ``host``'s
    batch at D0@512 (the drawn weights): through ``band_loss`` with the
    activations in height bands, summed over the ranks, when a mesh is
    given (tests/test_train.py::TestSpatialTrain's setup), else the
    one-process loss. By parameter name, on the host."""
    import torch

    from efficientdet_tpu_torch.ops.preprocess import preprocess_batch_fixed
    from efficientdet_tpu_torch.parallel import collectives
    from efficientdet_tpu_torch.parallel.context import ParallelContext, parallel_context
    from efficientdet_tpu_torch.parallel.spatial import band_loss
    from efficientdet_tpu_torch.train_lib import _loss

    device = DEVICE if mesh is None else mesh.device
    model = drawn_model(device)
    tc = et.TrainConfig(batch_size=len(host["images"]), max_gt_boxes=TRAIN_MAX_GT)
    b = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    images = preprocess_batch_fixed(b["images"])
    params = list(model.parameters())
    if mesh is None:
        total = _loss(model, tc, images, b["gt_boxes"], b["gt_labels"], None)[0]
        grads = torch.autograd.grad(total, params)
    else:
        ctx = ParallelContext(mesh, "spatial", images.shape[1])
        with parallel_context(ctx):
            total = band_loss(model, tc, images, b["gt_boxes"], b["gt_labels"], None, ctx)[0]
            grads = torch.autograd.grad(total, params)
        grads = collectives.all_reduce_grads(grads, mesh.group)
        total = collectives.sum_over_ranks([total.detach().reshape(1)], mesh.group)[0][0]
    names = [k for k, _ in model.named_parameters()]
    return ({k: g.cpu() for k, g in zip(names, grads)} if mesh is None
            else ({k: g.cpu() for k, g in zip(names, grads)}, float(total)))


def _fresh_peak():
    """Reset the card's peak-memory counter; the bytes this process holds
    now, which ``_added_peak_gb`` subtracts (a long-lived process and a
    fresh rank then read the same thing: what the measured work added)."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _added_peak_gb(held):
    import torch

    return (torch.cuda.max_memory_allocated() - held) / 1e9


def _parallel_rank(mesh, global_batch, spatial_batch, cache_indices):
    """One of phase parallel's two gloo ranks on the card: the sharded step
    at D0@512 on its rows of ``global_batch``, spatial predict and one
    spatial step on ``spatial_batch``, its share of a DeviceDataCache; each
    with the peak memory it added to what this process held before it; the
    two steps again in float64; the head and NMS launches."""
    import torch

    import efficientdet_tpu_torch as et
    import efficientdet_tpu_torch.ops.head_kernel as hk
    import efficientdet_tpu_torch.ops.nms_kernel as nk
    from efficientdet_tpu_torch.parallel import (make_sharded_train_step, make_spatial_predict_fn,
                                                 make_spatial_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hk.head_pointwise_anchor_major.launches = 0
    nk.suppression_keep_mask.launches = 0
    out = {"rank": mesh.rank, "backend": mesh.backend}
    dev = mesh.device

    def train(make, batch, dtype=None):
        model = drawn_model(dev, dtype=dtype).train()
        tc = et.TrainConfig(batch_size=len(batch["images"]), max_gt_boxes=TRAIN_MAX_GT)
        step = make(model, tc, mesh)  # rank 0's weights, then the state made from them
        state = et.create_train_state(model, tc, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        return _step_outputs(state, m)

    lo, hi = mesh.rows(len(global_batch["images"]))
    local = {k: v[lo:hi].to(dev) for k, v in global_batch.items()}
    held = _fresh_peak()
    t0 = time.perf_counter()
    out["sharded"] = train(make_sharded_train_step, local)
    out["sharded_s"] = time.perf_counter() - t0
    out["sharded_peak_gb"] = _added_peak_gb(held)
    out["sharded_f64"] = train(make_sharded_train_step, local, torch.float64)
    del local

    held = _fresh_peak()
    model, _ = et.build_efficientdet(0, num_classes=90, seed=0, device=dev)
    predict = make_spatial_predict_fn(model, mesh)
    images = spatial_batch["images"].to(dev)
    predict(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = predict(images)
    torch.cuda.synchronize()
    out["spatial_predict_ms"] = (time.perf_counter() - t0) * 1e3
    out["spatial_dets"] = [t.cpu() for t in dets]
    out["spatial_predict_peak_gb"] = _added_peak_gb(held)
    del model, predict

    whole = {k: v.to(dev) for k, v in spatial_batch.items()}
    held = _fresh_peak()
    t0 = time.perf_counter()
    out["spatial_step"] = train(make_spatial_train_step, whole)
    out["spatial_step_s"] = time.perf_counter() - t0
    out["spatial_step_peak_gb"] = _added_peak_gb(held)
    out["spatial_step_f64"] = train(make_spatial_train_step, whole, torch.float64)
    out["spatial_grads"], out["spatial_grads_loss"] = _eval_grads(
        et, {k: v.numpy() for k, v in spatial_batch.items()}, mesh)

    ds = _smoke_dataset(et, n=PAR_CACHE_IMAGES, seed=3)
    cache = et.DeviceDataCache(ds, target_size=TRAIN_SIZE, max_gt=TRAIN_MAX_GT, mesh=mesh)
    rows = cache.get_batch(cache_indices)
    out["cache"] = {"len": len(cache), "nbytes": cache.nbytes(), "rank_nbytes": cache.local_nbytes(),
                    "rows": {k: v.cpu() for k, v in rows.items()}}
    out["launches"] = {"head_pointwise": hk.head_pointwise_anchor_major.launches,
                       "nms_suppress": nk.suppression_keep_mask.launches}
    return out


def phase_parallel(et, kernels, card, pipeline_ms, train_rec):
    """Data and spatial parallelism. In this process, NCCL at world size 1
    at D0@512: make_sharded_predict_fn (bf16, BN folded, batch 128) against
    make_predict_fn, make_sharded_train_step (f32, TF32 off, batch 64)
    against make_train_step, the spatial predict and step against the
    serial ones. Then two gloo ranks on the card (parallel/launch.py): the
    sharded step on a global batch of 16 against the one-process step on it,
    make_spatial_predict_fn (f32, batch 2) against predict_pipeline, one
    spatial step (batch 2) against the one-process step and its eval-mode
    gradients against the serial ones, each rank's peak memory beside one
    process's (each the peak above what its process held before), and a
    DeviceDataCache split over the ranks against the unsharded cache. Both
    two-rank steps run again in float64, the witness that tells float32
    regrouping from a defect: held against the one-process float64 step,
    which also anchors the float32 steps' gradients."""
    import torch

    from efficientdet_tpu_torch.parallel import (make_mesh, make_sharded_predict_fn,
                                                 make_sharded_train_step, make_spatial_predict_fn,
                                                 make_spatial_train_step)
    from efficientdet_tpu_torch.parallel import tolerances as T
    from efficientdet_tpu_torch.parallel.launch import free_port, spawn

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = []

    def check(name, ok, **rec):
        checks.append({"check": name, "ok": bool(ok), **rec})
        emit({"phase": "parallel_check", "check": name, "ok": bool(ok), **rec})

    def timed(fn, steps):
        fn()  # a warm-up call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / steps * 1e3

    in_process = {name: 0 for name in kernels}

    def counted(fn):
        """``fn`` whose kernel launches add to the phase's count (the plain
        functions it is held against count none)."""
        def call(*args):
            for k in kernels.values():
                k.launches = 0
            out = fn(*args)
            torch.cuda.synchronize()
            for name, k in kernels.items():
                in_process[name] += k.launches
            return out
        return call

    rng = np.random.RandomState(0)
    size = TRAIN_SIZE
    mesh = make_mesh(init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                     backend="nccl" if DEVICE == "cuda" else "gloo", device=DEVICE, timeout_s=120)
    try:
        # sharded predict, world size 1: the same call as make_predict_fn
        model, _ = et.build_efficientdet(0, num_classes=90, dtype=torch.bfloat16, seed=0,
                                          device=DEVICE)
        fused = et.fuse_for_inference(model)
        big = torch.from_numpy(rng.randint(0, 256, (PAR_PREDICT_BATCH, size, size, 3))
                               .astype(np.uint8)).to(DEVICE)
        sharded = counted(make_sharded_predict_fn(fused, mesh))
        plain = et.make_predict_fn(fused)
        got, sharded_ms = timed(lambda: sharded(big), 5)
        want, plain_ms = timed(lambda: plain(big), 5)
        _check_detections(got, 90, PAR_PREDICT_BATCH)
        bit = all(torch.equal(a, b) for a, b in zip(got, want))
        check("sharded_predict_world1_equals_make_predict_fn", bit, bit_for_bit=bit,
              batch=PAR_PREDICT_BATCH, img_s=PAR_PREDICT_BATCH / sharded_ms * 1e3,
              ms_per_call=sharded_ms, make_predict_fn_img_s=PAR_PREDICT_BATCH / plain_ms * 1e3,
              pipeline_phase_img_s=BENCH_BATCH / pipeline_ms * 1e3)
        del model, fused, big, sharded, plain, got, want
        torch.cuda.empty_cache()

        # sharded train step, world size 1, against make_train_step
        host = _bench_train_batch(size, PAR_TRAIN_BATCH, seed=0)
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
        outs, ms = {}, {}
        for name, make in (("sharded", make_sharded_train_step), ("one_process", None)):
            model = drawn_model(DEVICE)
            tc = et.TrainConfig(batch_size=PAR_TRAIN_BATCH, max_gt_boxes=TRAIN_MAX_GT)
            step = counted(make(model, tc, mesh)) if make else et.make_train_step(model, tc, DEVICE)
            holder = {"state": et.create_train_state(model, tc, DEVICE)}
            gen = torch.Generator(device=DEVICE).manual_seed(1)

            def one():
                holder["state"], m = step(holder["state"], batch, gen)
                return m

            # the first step is compared; it is also the timing's warm-up
            outs[name] = _step_outputs(holder["state"], one())
            _, ms[name] = timed(one, PAR_TRAIN_STEPS)
            del model, holder, step
            torch.cuda.empty_cache()
        cmp = _compare_steps(outs["sharded"], outs["one_process"])
        check("sharded_step_world1_equals_make_train_step", _step_ok(cmp),
              timed_steps=PAR_TRAIN_STEPS, errors_over_tolerance=cmp, ms_per_step=ms["sharded"],
              one_process_ms_per_step=ms["one_process"],
              train_phase_ms_per_step=train_rec["f32"]["ms_per_step"])
        del batch, outs
        torch.cuda.empty_cache()

        # the spatial functions at world size 1: one band, the halo rows all pads
        small = {k: v[:PAR_SPATIAL_BATCH] for k, v in host.items()}
        images = torch.from_numpy(small["images"]).to(DEVICE)
        model, _ = et.build_efficientdet(0, num_classes=90, seed=0, device=DEVICE)
        got = counted(make_spatial_predict_fn(model, mesh))(images)
        want = et.predict_pipeline(model, images)
        rec = _close_dets(got, want)
        check("spatial_predict_world1_equals_predict_pipeline", rec.pop("ok"), **rec)
        step_outs = {}
        for name, make in (("spatial", make_spatial_train_step), ("one_process", None)):
            model = drawn_model(DEVICE)
            tc = et.TrainConfig(batch_size=PAR_SPATIAL_BATCH, max_gt_boxes=TRAIN_MAX_GT)
            step = counted(make(model, tc, mesh)) if make else et.make_train_step(model, tc, DEVICE)
            state = et.create_train_state(model, tc, DEVICE)
            state, m = step(state, {k: torch.from_numpy(v).to(DEVICE) for k, v in small.items()},
                            torch.Generator(device=DEVICE).manual_seed(1))
            step_outs[name] = _step_outputs(state, m)
        cmp = _compare_steps(step_outs["spatial"], step_outs["one_process"])
        check("spatial_step_world1_equals_make_train_step", _step_ok(cmp),
              errors_over_tolerance=cmp)
        del model, state, step, step_outs
        torch.cuda.empty_cache()
    finally:
        mesh.close()
    if in_process["head_pointwise"] == 0 or in_process["nms_suppress"] == 0:
        raise AssertionError(f"parallel: the world-size-1 paths missed a kernel: {in_process}")

    # two gloo ranks on the card
    global_host = _bench_train_batch(size, PAR_GLOBAL_BATCH, seed=2)
    spatial_host = _bench_train_batch(size, PAR_SPATIAL_BATCH, seed=3)
    cache_idx = np.random.RandomState(4).randint(0, PAR_CACHE_IMAGES, 8)
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke.py:_parallel_rank", PAR_RANKS, dict(
        global_batch={k: torch.from_numpy(v) for k, v in global_host.items()},
        spatial_batch={k: torch.from_numpy(v) for k, v in spatial_host.items()},
        cache_indices=cache_idx.tolist()), device=DEVICE, backend="gloo", timeout_s=PAR_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    for r in ranks[1:]:
        for key in ("sharded", "sharded_f64", "spatial_step", "spatial_step_f64"):
            if not all(torch.equal(r[key][3][k], v) for k, v in ranks[0][key][3].items()):
                raise AssertionError(f"parallel: the ranks' parameters differ after the {key} step")

    def one_process(batch, dtype=None):
        held = _fresh_peak()
        model = drawn_model(DEVICE, dtype=dtype)
        tc = et.TrainConfig(batch_size=len(batch["images"]), max_gt_boxes=TRAIN_MAX_GT)
        state, m = et.make_train_step(model.train(), tc, DEVICE)(
            et.create_train_state(model, tc, DEVICE),
            {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()},
            torch.Generator(device=DEVICE).manual_seed(1))
        torch.cuda.synchronize()
        return _step_outputs(state, m), _added_peak_gb(held)

    def two_rank_step(name, key, batch, **rec):
        """The ranks' float32 step against the one-process float32 step, its
        gradient against the one-process float64 step's (grad_against_exact),
        and the ranks' float64 step against the one-process float64 step at
        FLOAT64_SCALE of the tolerances, where regrouping moves nothing a
        defect would hide behind."""
        want, peak = one_process(batch)
        exact = one_process(batch, torch.float64)[0]
        got = ranks[0][key]
        cmp = _compare_steps(got, want)
        vs_exact, vs_leaf = T.grad_against_exact(got[1], want[1], exact[1])
        # how far each float32 gradient is from the float64 one in the leaf
        # where the two differ most, over that leaf's largest |g|
        leaf = cmp["grad_worst_leaf"]
        top = float(exact[1][leaf].abs().max())
        apart = {who: T.grad_errors({leaf: mu[leaf]}, {leaf: exact[1][leaf]})[leaf] / top
                 for who, mu in (("two_rank", got[1]), ("one_process", want[1]))}
        check(f"two_rank_{name}_equals_one_process", _step_ok(cmp) and vs_exact <= 1.0,
              errors_over_tolerance=cmp, grad_against_float64=vs_exact,
              grad_against_float64_leaf=vs_leaf, worst_leaf_distance_from_float64=apart,
              rank_peak_gb=[r[f"{key}_peak_gb"] for r in ranks], one_process_peak_gb=peak,
              rank_step_s=[r[f"{key}_s"] for r in ranks], **rec)
        cmp64 = _compare_steps(ranks[0][f"{key}_f64"], exact, scale=T.FLOAT64_SCALE)
        check(f"two_rank_{name}_float64_equals_one_process", T.step_holds(cmp64),
              errors_over_float64_tolerance=cmp64)

    two_rank_step("sharded_step", "sharded", global_host, global_batch=PAR_GLOBAL_BATCH)

    model, _ = et.build_efficientdet(0, num_classes=90, seed=0, device=DEVICE)
    held = _fresh_peak()
    want = et.predict_pipeline(model, torch.from_numpy(spatial_host["images"]).to(DEVICE))
    predict_peak = _added_peak_gb(held)
    for r in ranks:
        rec = _close_dets(r["spatial_dets"], want)
        check(f"two_rank_spatial_predict_rank{r['rank']}", rec.pop("ok"), **rec,
              rank_peak_gb=r["spatial_predict_peak_gb"], one_process_peak_gb=predict_peak,
              ms_per_call=r["spatial_predict_ms"])
    del model
    two_rank_step("spatial_step", "spatial_step", spatial_host, images=PAR_SPATIAL_BATCH)
    want_grads = _eval_grads(et, spatial_host)
    worst, leaf = 0.0, None
    for k, w in want_grads.items():
        err = float(((ranks[0]["spatial_grads"][k] - w).abs() / (1e-6 + 1e-4 * w.abs())).max())
        if err > worst:
            worst, leaf = err, k
    check("two_rank_spatial_gradients", worst <= 1.0, err_over_rtol1e4_atol1e6=worst,
          worst_leaf=leaf, loss=ranks[0]["spatial_grads_loss"])

    plain = et.DeviceDataCache(_smoke_dataset(et, n=PAR_CACHE_IMAGES, seed=3), target_size=size,
                               max_gt=TRAIN_MAX_GT, device=DEVICE)
    rows = plain.get_batch(cache_idx)
    same = all(torch.equal(r["cache"]["rows"][k], v[lo:hi].cpu())
               for r, (lo, hi) in zip(ranks, ((0, 4), (4, 8))) for k, v in rows.items())
    check("two_rank_device_cache_equals_unsharded", same and ranks[0]["cache"]["nbytes"]
          == 2 * ranks[0]["cache"]["rank_nbytes"], images=PAR_CACHE_IMAGES,
          pool_mb=ranks[0]["cache"]["nbytes"] / 1e6,
          rank_pool_mb=[r["cache"]["rank_nbytes"] / 1e6 for r in ranks],
          unsharded_pool_mb=plain.nbytes() / 1e6)
    del plain, rows
    torch.cuda.empty_cache()
    rank_launches = {k: sum(r["launches"][k] for r in ranks) for k in ("head_pointwise", "nms_suppress")}
    launches = {k: v + rank_launches.get(k, 0) for k, v in in_process.items()}
    if min(rank_launches.values()) == 0:
        raise AssertionError(f"parallel: the ranks' spatial predict missed a kernel: {rank_launches}")
    rec = {"phase": "parallel", "model": "D0@512, 90 classes, random weights from seed 0",
           "checks": {c["check"]: c["ok"] for c in checks}, "ranks": PAR_RANKS,
           "rank_backend": ranks[0]["backend"], "ranks_s": ranks_s,
           "launches_in_process": in_process, "launches_ranks": rank_launches, "launches": launches,
           "seconds": time.perf_counter() - t_start, "card": card}
    emit(rec)
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"parallel: checks failed: {[c['check'] for c in checks if not c['ok']]}")
    return rec


# the family phase: bench.py's batch for D4, the JAX README's elsewhere
FAMILY_BATCH = {1: 64, 2: 64, 3: 32, 4: 64, 5: 16, 6: 16, 7: 8}
FAMILY_STEPS = 5  # timed calls a phi after FAMILY_WARMUP
FAMILY_WARMUP = 2
# the family's weights: drawn with conv variance 1 / fan-in (at the tests'
# 1.5 the B6 backbone of D6/D7 amplifies float32 rounding past the
# gpu_vs_cpu rule on the CPU alone; build_efficientdet's init grows D1-D7's
# features to 1e2-1e11)
FAMILY_GAIN = 1.0
# tools/bench_train.py --phi 4 --remat: D4@1024, batch 16, 2 warm-up and 4 timed steps
FAMILY_TRAIN_PHI = 4
FAMILY_TRAIN_SIZE = 1024
FAMILY_TRAIN_BATCH = 16
FAMILY_TRAIN_WARMUP = 2
FAMILY_TRAIN_STEPS = 4


def _recording(module, name, calls):
    """Swap ``module.name`` for a wrapper that appends each call's arguments
    to ``calls``; returns the restore function."""
    orig = getattr(module, name)

    def wrapper(*args):
        calls.append(args)
        return orig(*args)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def _head_check(hk, x, k, b, a):
    """The head kernel against its plain version on the main path's own
    inputs: at most one bf16 ulp (phase head_kernel's rule)."""
    import torch

    z, amax, _ = hk.head_pointwise_anchor_major(x, k, b, a)
    zr, ar, _ = hk.head_pointwise_reference(x, k, b, a)
    out = k.shape[1] // a
    over = (z.float() - zr.float()).abs() / (2.0 ** -7 * zr.float().abs() + 1e-4)
    over_a = (amax.float() - ar.float()).abs() / (2.0 ** -7 * ar.float().abs() + 1e-4)
    ok = bool(over.max() <= 1.0 and over_a.max() <= 1.0)
    rec = {"M": x.shape[0], "Cin": x.shape[1], "A": a, "out": out,
           "max_abs_dz": (z.float() - zr.float()).abs().max().item(),
           "max_abs_damax": (amax.float() - ar.float()).abs().max().item(),
           "scale": zr.float().abs().max().item(), "tolerance": "|d| <= 2^-7 |ref| + 1e-4",
           "err_over_tol": max(over.max().item(), over_a.max().item()), "ok": ok}
    if not ok:  # the worst element against its float64 sum
        ai, ri, ci = np.unravel_index(int(over.argmax()), tuple(over.shape))
        terms = x[ri].double() * k[:, ai * out + ci].to(x.dtype).double()
        rec["worst"] = {"anchor": int(ai), "row": int(ri), "col": int(ci),
                        "kernel": z[ai, ri, ci].item(), "plain": zr[ai, ri, ci].item(),
                        "float64": (terms.sum() + b[ai * out + ci].double()).item(),
                        "sum_abs_terms": terms.abs().sum().item()}
    del z, zr, over, over_a
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"head kernel disagrees with its plain version: {rec}")
    return rec


def _head_launch_timing(hk, x, k, b, a):
    """One head launch at the main path's shapes (the class or the box
    launch): the call's ms (CUDA events over 10 calls, the time to read),
    the kernel's device ms (CUDA events over 10 bare launches into outputs
    allocated once: ``head_kernel.launch_into``), its bound, its plain
    version (3 calls) and torch.addmm + amax on the same inputs."""
    import torch

    m, cin = x.shape
    out = k.shape[1] // a
    mp = m + (-m) % hk.ROW_TILE
    ms = cuda_ms(lambda: hk.head_pointwise_anchor_major(x, k, b, a), iters=10)
    # what the custom op hands the launcher: no copy of a transposed bf16 view
    kt, bf = k.to(x.dtype).t().contiguous(), b.float().contiguous()
    z = torch.empty((a, mp, out), dtype=x.dtype, device=x.device)
    amax = torch.empty((a, mp), dtype=x.dtype, device=x.device)
    device = cuda_ms(lambda: hk.launch_into(x, kt, bf, z, amax, a), iters=10)
    del z, amax
    plain = cuda_ms(lambda: hk.head_pointwise_reference(x, k, b, a), iters=3, warmup=1)
    kb, bb = k.to(x.dtype).contiguous(), b.to(x.dtype)
    library = cuda_ms(lambda: torch.addmm(bb, x, kb).view(m, a, out).amax(-1), iters=10)
    nbytes = m * cin * 2 + cin * a * out * 2 + a * out * 4 + a * mp * out * 2 + a * mp * 2
    b_ms, b_by = bound(nbytes, 2.0 * m * cin * a * out, PEAK_BF16)
    torch.cuda.empty_cache()
    return {"A": a, "out": out, "M": m, "Cin": cin, "plan": hk.bf16_plan(cin, a, out), "ms": ms,
            "device_ms": device, "bound_ms": b_ms, "bound_by": b_by, "ms_over_bound": ms / b_ms,
            "plain_ms": plain, "library_ms": library, "ms_over_library": ms / library,
            "bytes": nbytes}


def _model_flops(et, model, size):
    """FLOPs of one image through ``model``'s convolutions and matrix
    products (utils/profiling.flops_estimate: FlopCounterMode counts those
    only, where XLA's cost analysis counts every operation)."""
    import torch

    from efficientdet_tpu_torch.utils.profiling import flops_estimate

    x = torch.zeros((1, size, size, 3), dtype=model.dtype, device=DEVICE)
    flops = flops_estimate(lambda t: model(t), x)  # the "concat" heads: cuDNN's 1x1 convs
    if not flops:
        raise AssertionError("flops_estimate counted nothing")
    return flops


def _family_card_vs_cpu(et, tn, model):
    """Card against CPU, ``model`` (float32, on the card) at its full
    resolution, batch 1, its folded weights on both devices (the gpu_vs_cpu
    rule, ``_heads_card_vs_cpu``)."""
    import torch

    cfg = model.config
    cpu = et.EfficientDet(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    models = {"cpu": et.fuse_for_inference(cpu.eval()), "cuda": et.fuse_for_inference(model)}
    rng = np.random.RandomState(100 + cfg.phi)
    size = cfg.image_size
    images = torch.from_numpy(rng.randint(0, 256, (1, size, size, 3)).astype(np.uint8))
    heads, nms, cpu_s = _heads_card_vs_cpu(tn, models, images)
    return {"heads": heads, "nms_same_heads": nms, "cpu_forward_s": cpu_s}


def _family_phi(et, hk, nk, tn, phi, card):
    """One phi of the family at its own resolution: bf16, BN folded,
    "anchor_major", FAMILY_BATCH[phi] images."""
    import torch

    import efficientdet_tpu_torch.models.heads as heads_mod

    t_phase = time.perf_counter()
    # the variance-preserving numpy draw: well conditioned at every phi
    # (experiments/drawn_weights.py)
    drawn = drawn_model(DEVICE, seed=phi, phi=phi, gain=FAMILY_GAIN)
    card_vs_cpu = _family_card_vs_cpu(et, tn, drawn)
    state = drawn.state_dict()
    del drawn
    model, cfg = et.build_efficientdet(phi, num_classes=90, dtype=torch.bfloat16, seed=phi,
                                       device=DEVICE)
    model.load_state_dict(state)
    model = et.fuse_for_inference(model)
    size, batch = cfg.image_size, FAMILY_BATCH[phi]
    gen = torch.Generator(device=DEVICE).manual_seed(phi)
    images = torch.randint(0, 256, (batch, size, size, 3), generator=gen, device=DEVICE,
                           dtype=torch.uint8)
    predict = et.make_predict_fn(model)
    for _ in range(FAMILY_WARMUP):
        _check_detections(predict(images), cfg.num_classes, batch)
    torch.cuda.synchronize()

    # one call with the counters at 0 and the kernels' inputs recorded
    head_calls, nms_calls = [], []
    restore = [_recording(heads_mod, "head_pointwise_anchor_major", head_calls),
               _recording(tn, "suppression_keep_mask", nms_calls)]
    hk.head_pointwise_anchor_major.launches = 0
    nk.suppression_keep_mask.launches = 0
    try:
        n = _check_detections(predict(images), cfg.num_classes, batch)
        torch.cuda.synchronize()
    finally:
        for r in restore:
            r()
    launches = {"head_pointwise": hk.head_pointwise_anchor_major.launches,
                "nms_suppress": nk.suppression_keep_mask.launches}
    if launches != {"head_pointwise": 2, "nms_suppress": 1}:
        raise AssertionError(f"D{phi}: a call did not go through both kernels: {launches}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(FAMILY_STEPS):
        out = predict(images)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / FAMILY_STEPS
    peak = torch.cuda.max_memory_allocated() / 1e9
    _check_detections(out, cfg.num_classes, batch)
    del out

    # the kernels on the inputs the call gave them (inference tensors)
    (xc, kc, bc, ac), (xb, kb, bb, ab) = head_calls
    plan = hk.bf16_plan(xc.shape[1], ac, kc.shape[1] // ac)
    boxes, classes, valid, iou = nms_calls[0]
    with torch.inference_mode():
        head = {"class": _head_check(hk, xc, kc, bc, ac), "box": _head_check(hk, xb, kb, bb, ab)}
        keep = nk.suppression_keep_mask(boxes, classes, valid, iou)
        keep_ref = nk.suppression_keep_mask_reference(boxes, classes, valid, iou)
        nms = {"B": boxes.shape[0], "K": boxes.shape[1], "valid": int(valid.sum()),
               "kept": int(keep.sum()), "equal": bool(torch.equal(keep, keep_ref))}
        if not nms["equal"]:
            raise AssertionError(f"D{phi}: NMS kernel differs from its plain version: {nms}")
        timing = {"class": _head_launch_timing(hk, xc, kc, bc, ac),
                  "box": _head_launch_timing(hk, xb, kb, bb, ab)}
        if timing["class"]["ms"] >= timing["class"]["library_ms"]:
            raise AssertionError(f"D{phi}: the class launch is no faster than addmm + amax: "
                                 f"{timing['class']}")
    del head_calls, nms_calls, xc, xb, boxes, classes, valid, keep, keep_ref
    flops = _model_flops(et, model, size)
    img_s = batch / dt
    del model, images, predict
    torch.cuda.empty_cache()
    return {"phi": phi, "model": f"D{phi}@{size}, 90 classes, BN folded, bf16, anchor_major",
            "batch": batch, "steps": FAMILY_STEPS, "img_s": img_s, "ms_per_call": dt * 1e3,
            "peak_mem_gb": peak, "launches_a_call": launches, "num_valid": [int(v) for v in n],
            "head_plan": plan, "head_check": head, "nms_check": nms, "head_launches": timing,
            "gflops_per_image": flops / 1e9,
            "mfu_convs_and_matmuls": flops * img_s / PEAK_BF16,
            "card_vs_cpu_f32": card_vs_cpu,
            "seconds": time.perf_counter() - t_phase, "card": card}


def phase_family(et, hk, nk, tn, card, pipeline_ms):
    """D1-D7 at their own resolutions through the main path's two kernels
    (bench.py's bench_phi for every phi), D0's MFU from phase pipeline's
    call, and the D4@1024 batch-16 remat training step
    (tools/bench_train.py --phi 4 --remat)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    d0, d0_cfg = et.build_efficientdet(0, num_classes=90, dtype=torch.bfloat16, seed=0,
                                       device=DEVICE)
    d0_flops = _model_flops(et, et.fuse_for_inference(d0), d0_cfg.image_size)
    del d0
    d0_img_s = BENCH_BATCH / (pipeline_ms / 1e3)
    emit({"phase": "family", "model": "D0@512 (phase pipeline, batch 128)",
          "gflops_per_image": d0_flops / 1e9, "img_s": d0_img_s,
          "d0_512px_mfu_convs_and_matmuls": d0_flops * d0_img_s / PEAK_BF16,
          "peak_flops": PEAK_BF16,
          "note": "mfu counts convolutions and matrix products only (FlopCounterMode), "
                  "where XLA's cost analysis in bench.py counts every operation",
          "card": card})
    launches = {"head_pointwise": 0, "nms_suppress": 0}
    streamed = {}  # the head kernel's two launches at each phi's shapes
    for phi in sorted(FAMILY_BATCH):
        rec = _family_phi(et, hk, nk, tn, phi, card)
        for name, v in rec["launches_a_call"].items():
            launches[name] += v
        streamed[f"D{phi}"] = {
            launch: {key: t[key] for key in ("plan", "M", "Cin", "ms", "device_ms", "bound_ms",
                                             "plain_ms", "library_ms")}
            for launch, t in rec["head_launches"].items()}
        emit({"phase": "family", **rec})

    host = _bench_train_batch(FAMILY_TRAIN_SIZE, FAMILY_TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    kernels = {"head_pointwise": hk.head_pointwise_anchor_major,
               "nms_suppress": nk.suppression_keep_mask}
    train, model, state, _, _ = _train_timed(
        et, torch.float32, batch, kernels, card, remat=True, phi=FAMILY_TRAIN_PHI,
        warmup=FAMILY_TRAIN_WARMUP, steps=FAMILY_TRAIN_STEPS)
    del model, state, batch
    torch.cuda.empty_cache()
    emit({"phase": "family", "train": train})
    emit({"phase": "family", "launches": launches, "seconds": time.perf_counter() - t0})
    return launches, streamed


def phase_int8(card):
    """experiments/int8_microbench.py: int8 against bf16, two-point slopes."""
    from efficientdet_tpu_torch.experiments import int8_microbench
    from efficientdet_tpu_torch.experiments.timing import PEAK_INT8

    rec = int8_microbench.run()
    emit({"phase": "int8", "results": rec, "peak_bf16_tflops": PEAK_BF16 / 1e12,
          "peak_int8_tops": PEAK_INT8 / 1e12, "card": card})


def phase_stage1(card):
    """experiments/stage1_packing.py: the four stage-1 formulations, forward
    and weight gradients, bf16, batch 16, 512 px, 48 -> 24; each against ref
    at 3e-2 before it is timed."""
    from efficientdet_tpu_torch.experiments import stage1_packing as sp

    recs = sp.run()
    ref = recs[0]["ms"]
    for r in recs:
        r["vs_ref"] = r["ms"] / ref
    emit({"phase": "stage1_packing", "shape": [sp.BATCH, sp.SIZE, sp.SIZE, sp.CIN, sp.COUT],
          "dtype": "bf16", "variants": recs, "card": card})


# the entry_points phase: every entry point above D0 at D4@1024 and D7@1536
ENTRY_PHIS = (4, 7)
# two of the predictor phase's five source shapes: one the model shrinks
# with antialiasing, one it enlarges
ENTRY_SHAPES = [(1080, 1920), (300, 200)]
ENTRY_STEPS = 10  # timed replays a shape (the median is kept)
ENTRY_EAGER_STEPS = 3  # timed eager calls a shape
ENTRY_SERVE_BATCH = {4: 16, 7: 8}
ENTRY_SERVE_SOURCES = 8
ENTRY_SERVE_SECONDS = 2.0
ENTRY_SERVE_ANSWERS = 40  # each closed-loop level runs on until this many came back
ENTRY_EXPORT_BATCH = 8
ENTRY_EXPORT_STEPS = 3  # timed calls of the artifact, replayed and eager, and of predict_pipeline
ENTRY_SHARDED_BATCH = 8
ENTRY_SHARDED_STEPS = 3
# the training step: tests/torch_entry_train.py's reduced configs and draws
ENTRY_TRAIN_SIZE = 256
ENTRY_TRAIN_WIDTH = 64
ENTRY_TRAIN_BATCH = 2
ENTRY_FINAL_STD = 0.01


class _Captured:
    """Records the port's kernel launches while open: ``counts``, those made
    while the launching stream was being captured into a CUDA graph (the
    launches a graph replays; a replay ticks no Python counter), and, for
    every head launch, its widths, whether it was captured and its plan.
    Every wrapper calls ``cuda_build.check`` right after its launch; the
    head's wrapper goes through ``head_kernel.launch_into``. Blocks may
    nest: each records what runs inside it."""

    def __init__(self, hk, cuda_build):
        self.hk, self.cuda_build = hk, cuda_build
        self.counts = {"head_pointwise": 0, "nms_suppress": 0}
        self.heads = []

    def __enter__(self):
        import torch

        check, launch = self.cuda_build.check, self.hk.launch_into

        def counting_check(lib, name, err):
            check(lib, name, err)
            if torch.cuda.is_current_stream_capturing() and name in self.counts:
                self.counts[name] += 1

        def recording_launch(x2d, kt, bias, z, amax, num_anchors):
            self.heads.append((x2d.shape[1], num_anchors, z.shape[2], x2d.dtype,
                               torch.cuda.is_current_stream_capturing()))
            return launch(x2d, kt, bias, z, amax, num_anchors)

        self._restore = (check, launch)
        self.cuda_build.check, self.hk.launch_into = counting_check, recording_launch
        return self

    def __exit__(self, *exc):
        self.cuda_build.check, self.hk.launch_into = self._restore
        return False

    def _plan(self, cin, a, out, dtype):
        import torch

        return self.hk.bf16_plan(cin, a, out) if dtype == torch.bfloat16 else "f32"

    def plans(self):
        """Each captured head launch: its widths and the plan it took."""
        return [{"Cin": cin, "A": a, "out": out, "plan": self._plan(cin, a, out, dtype)}
                for cin, a, out, dtype, captured in self.heads if captured]

    def plan_counts(self):
        """Every head launch in the block (captured or not) by plan."""
        counts = {}
        for cin, a, out, dtype, _ in self.heads:
            plan = self._plan(cin, a, out, dtype)
            counts[plan] = counts.get(plan, 0) + 1
        return counts


def _entry_model(et, phi, state, dtype, fused=True):
    """D``phi`` at its own resolution on the card holding ``state``."""
    model, cfg = et.build_efficientdet(phi, num_classes=90, dtype=dtype, seed=phi, device=DEVICE)
    model.load_state_dict(state)
    return (et.fuse_for_inference(model) if fused else model), cfg


def _entry_predictor(et, hk, cuda_build, phi, state, card):
    """The Predictor at D``phi``, f32 and bf16, score threshold 0, on the
    ENTRY_SHAPES: each shape's first call captures its graph (its launches
    counted at capture: the NMS kernel once; the heads are convolutions, as
    in the JAX package's Predictor), two replays equal eager() bit for bit,
    ms per image (median) replayed and eager, the graph pool's memory; the
    anchor-major pipeline on the same model in a graph (the head kernel's
    two launches and their plan: streamed in bf16, the f32 kernel in f32;
    replay equal to eager bit for bit); in f32 both against the CPU (the
    Predictor rule, near-ties in either order)."""
    import torch
    from efficientdet_tpu_torch.data.common import letterbox_hostside
    from efficientdet_tpu_torch.utils.cuda_graph import GraphedCall

    rng = np.random.RandomState(40 + phi)
    images = {hw: [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for _ in range(2)]
              for hw in ENTRY_SHAPES}
    out = {}
    for dtype in ("f32", "bf16"):
        p = et.Predictor(phi=phi, dtype=dtype, score_threshold=0.0, variables=state, seed=phi)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        rows = []
        for hw in ENTRY_SHAPES:
            first, second = images[hw]
            with _Captured(hk, cuda_build) as cap:
                t0 = time.perf_counter()
                replays = [p(first)]  # two warm-up calls, the capture, the first replay
                capture_s = time.perf_counter() - t0
            # the JAX Predictor's path: the heads' convolutions (cuDNN here,
            # XLA there), then the single-image NMS on its kernel
            if cap.counts != {"head_pointwise": 0, "nms_suppress": 1}:
                raise AssertionError(f"Predictor D{phi} {dtype} {hw}: the graph holds {cap.counts}")
            replays.append(p(second))
            for img, got in zip((first, second), replays):
                want = p.eager(img)
                if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"Predictor D{phi} {dtype} {hw}: a replay differs from eager")
                if not _valid(got, 90) or len(got[1]) == 0:
                    raise AssertionError(f"Predictor D{phi} {dtype} {hw}: invalid detections")
            rows.append({"shape": list(hw), "detections": [len(r[1]) for r in replays],
                         "capture_s": capture_s, "captured_launches": cap.counts,
                         "graph_ms": _median_ms(lambda: p(first), ENTRY_STEPS),
                         "eager_ms": _median_ms(lambda: p.eager(first), ENTRY_EAGER_STEPS)})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rec = {"shapes": rows, "replay_equals_eager": "bit for bit",
               "graph_pool_reserved_mb": (torch.cuda.memory_reserved() - reserved0) / 2 ** 20}
        # the anchor-major pipeline (the server's and the artifact's path) on
        # the Predictor's model: the head kernel at this phi's Cin (the
        # streamed plan in bf16, the f32 kernel in f32) inside a graph
        canvas = letterbox_hostside(images[ENTRY_SHAPES[0]][0], p.config.image_size)[0]
        x = torch.from_numpy(canvas[None]).to(DEVICE)

        def pipeline(t, model=p.model):
            return et.predict_pipeline(model, t, p.eval_config)

        with _Captured(hk, cuda_build) as cap:
            graph = GraphedCall(pipeline, x, pool=torch.cuda.graph_pool_handle())
        want_plan = "streamed" if dtype == "bf16" else "f32"
        plans = cap.plans()
        replay = [t.clone() for t in graph(x)]
        with torch.inference_mode():
            eager = pipeline(x)
        bit = all(torch.equal(a, b) for a, b in zip(replay, eager))
        rec["pipeline_graph"] = {"canvas": list(canvas.shape), "captured_launches": cap.counts,
                                 "head_launches": plans, "replay_equals_eager": bit}
        if (cap.counts != {"head_pointwise": 2, "nms_suppress": 1} or not bit
                or any(h["plan"] != want_plan for h in plans)):
            raise AssertionError(f"pipeline graph D{phi} {dtype}: {rec['pipeline_graph']}")
        _check_detections(replay, 90, 1)
        del graph
        if dtype == "f32":
            cpu = et.Predictor(phi=phi, dtype="f32", score_threshold=0.0, seed=phi, device="cpu",
                               variables={k: v.cpu() for k, v in state.items()})
            img = images[ENTRY_SHAPES[1]][0]
            t0 = time.perf_counter()
            c = cpu(img)
            cpu_s = time.perf_counter() - t0
            g = p(img)
            fault = detection_mismatch(g, c, 1e-3, 1e-5)
            with torch.inference_mode():
                cpipe = [t.numpy() for t in pipeline(x.cpu(), cpu.model)]
            rpipe = [t.cpu().numpy() for t in replay]
            n = int(cpipe[3][0])
            pipe_fault = (f"counts {int(rpipe[3][0])} and {n}" if int(rpipe[3][0]) != n else
                          detection_mismatch([t[0, :n] for t in rpipe[:3]], [t[0, :n] for t in cpipe[:3]],
                                             1e-3, 1e-5))
            rec["vs_cpu"] = {"shape": list(ENTRY_SHAPES[1]), "detections": [len(g[1]), len(c[1])],
                             "box_tol_px": 1e-3, "score_tol": 1e-5, "cpu_s": cpu_s,
                             "held": fault is None,
                             "pipeline_f32_head_kernel_held": pipe_fault is None}
            if fault is None and pipe_fault is None:  # scores place by place (sorted on both)
                rec["vs_cpu"]["max_abs_dscore"] = float(np.abs(g[1] - c[1]).max())
                rec["vs_cpu"]["pipeline_max_abs_dscore"] = float(
                    np.abs(rpipe[1][0, :n] - cpipe[1][0, :n]).max())
            if fault is not None or pipe_fault is not None:
                raise AssertionError(f"D{phi} f32: card and CPU differ: Predictor {fault}, "
                                     f"pipeline {pipe_fault}, {rec['vs_cpu']}")
            del cpu
        out[dtype] = rec
        del p
        torch.cuda.empty_cache()
    return out


def _entry_serve(et, hk, cuda_build, phi, model, cfg, ec, card):
    """BatchingPredictor over ``model`` (bf16, BN folded): warmup() captures
    every bucket (launches counted at capture); closed loops at C = 1 and
    C = batch on 480x640 sources, every answer equal to predict_pipeline's
    detections of its source at one of the bucket sizes."""
    import torch
    from efficientdet_tpu_torch.data.common import letterbox_hostside

    batch = ENTRY_SERVE_BATCH[phi]
    size = cfg.image_size
    pred = et.BatchingPredictor(model, batch_size=batch, max_delay_ms=5.0, eval_config=ec,
                                pipeline_depth=2)
    threads = torch.get_num_threads()
    try:
        with _Captured(hk, cuda_build) as cap:
            t0 = time.perf_counter()
            pred.warmup()
            warmup_s = time.perf_counter() - t0
        buckets = pred._buckets
        if cap.counts != {"head_pointwise": 2 * len(buckets), "nms_suppress": len(buckets)}:
            raise AssertionError(f"serve D{phi}: the bucket graphs hold {cap.counts}")
        rng = np.random.RandomState(50 + phi)
        srcs = [rng.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(ENTRY_SERVE_SOURCES)]
        canvases = [letterbox_hostside(im, size) for im in srcs]
        expected = [[] for _ in srcs]
        for b in buckets:
            order = [j % len(srcs) for j in range(-(-max(b, len(srcs)) // b) * b)]
            for start in range(0, len(order), b):
                idx = order[start:start + b]
                x = torch.from_numpy(np.stack([canvases[j][0] for j in idx])).to(DEVICE)
                bx, sc, cl, nv = (t.cpu().numpy() for t in et.predict_pipeline(model, x, ec))
                for r, j in enumerate(idx):
                    k = int(nv[r])
                    ans = (bx[r, :k] / canvases[j][1], sc[r, :k], cl[r, :k])
                    if not any(all(np.array_equal(g, w) for g, w in zip(ans, e)) for e in expected[j]):
                        expected[j].append(ans)
        torch.set_num_threads(1)  # serve.main's setting on the card
        levels = [_closed_loop(pred, srcs, expected, c, ENTRY_SERVE_SECONDS,
                               min_answers=ENTRY_SERVE_ANSWERS) for c in (1, batch)]
    finally:
        pred.close()
        torch.set_num_threads(threads)
    return {"batch_size": batch, "buckets": buckets, "warmup_s": warmup_s,
            "captured_launches": cap.counts, "head_launches": cap.plans(), "source": [480, 640],
            "answers": "each equal to predict_pipeline's detections of its source at a bucket size",
            "answer_variants_across_buckets": max(len(e) for e in expected), "levels": levels}


def _entry_export(et, hk, nk, cuda_build, phi, model, cfg, ec, root):
    """The .edz artifact of ``model`` (bf16, BN folded, batch
    ENTRY_EXPORT_BATCH) exported on the card: loaded, eager and replayed
    equal to predict_pipeline bit for bit, and from_artifact at C = 1 and C
    = batch. Returns the record and (phi, path, predict_pipeline's answer)
    for the fresh process the caller starts once nothing it times runs."""
    import zipfile

    import torch
    from efficientdet_tpu_torch import export as ex
    from efficientdet_tpu_torch.data.common import letterbox_hostside
    from efficientdet_tpu_torch.utils.cuda_graph import GraphedCall

    size = cfg.image_size
    rec = {"batch_size": ENTRY_EXPORT_BATCH}
    path = os.path.join(root, f"d{phi}.edz")
    t0 = time.perf_counter()
    ex.save_exported(path, model, ENTRY_EXPORT_BATCH, eval_config=ec)
    rec["export_s"] = time.perf_counter() - t0
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
    rec["artifact_mb"] = os.path.getsize(path) / 1e6
    rec["manifest_model"] = manifest["model"]
    if manifest["model"] != {"phi": phi, "image_size": size, "num_classes": 90,
                             "weighted_bifpn": phi < 6}:
        raise AssertionError(f"export D{phi}: manifest model block {manifest['model']}")
    t0 = time.perf_counter()
    predict, _ = ex.load_exported(path)
    rec["load_s"] = time.perf_counter() - t0
    rng = np.random.RandomState(60 + phi)
    images = rng.randint(0, 256, (ENTRY_EXPORT_BATCH, size, size, 3)).astype(np.uint8)
    x = torch.from_numpy(images).to(DEVICE)
    hk.head_pointwise_anchor_major.launches = 0
    nk.suppression_keep_mask.launches = 0
    eager = predict(x)
    torch.cuda.synchronize()
    rec["launches_one_call"] = {"head_pointwise": hk.head_pointwise_anchor_major.launches,
                                "nms_suppress": nk.suppression_keep_mask.launches}
    want = et.predict_pipeline(model, x, ec)
    _check_detections(want, 90, ENTRY_EXPORT_BATCH)
    with _Captured(hk, cuda_build) as cap:
        graph = GraphedCall(predict, x, pool=torch.cuda.graph_pool_handle())
    replay = [t.clone() for t in graph(x)]
    rec["captured_launches"] = cap.counts
    rec["eager_vs_pipeline"] = _close_detections(eager, want, f"artifact D{phi} eager")
    rec["replay_vs_pipeline"] = _close_detections(replay, want, f"artifact D{phi} replay")

    def synced(fn):
        def call():
            fn()
            torch.cuda.synchronize()
        return call

    rec["ms"] = {"artifact_replay": _median_ms(synced(lambda: graph(x)), ENTRY_EXPORT_STEPS),
                 "artifact_eager": _median_ms(synced(lambda: predict(x)), ENTRY_EXPORT_STEPS),
                 "pipeline_eager": _median_ms(synced(lambda: et.predict_pipeline(model, x, ec)),
                                              ENTRY_EXPORT_STEPS)}
    if (rec["launches_one_call"] != {"head_pointwise": 2, "nms_suppress": 1}
            or cap.counts != {"head_pointwise": 2, "nms_suppress": 1}
            or not (rec["eager_vs_pipeline"]["bit_for_bit"] and rec["replay_vs_pipeline"]["bit_for_bit"])):
        raise AssertionError(f"export D{phi}: {rec}")
    del graph, replay, eager

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pred = et.BatchingPredictor.from_artifact(path, max_delay_ms=5.0, pipeline_depth=2)
    try:
        pred.warmup()
        srcs = [rng.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(ENTRY_SERVE_SOURCES)]
        canvases = [letterbox_hostside(im, size) for im in srcs]
        idx = [j % len(srcs) for j in range(ENTRY_EXPORT_BATCH)]
        batch = torch.from_numpy(np.stack([canvases[j][0] for j in idx])).to(DEVICE)
        bx, sc, cl, nv = (t.cpu().numpy() for t in et.predict_pipeline(model, batch, ec))
        expected = [[(bx[r, :int(nv[r])] / canvases[j][1], sc[r, :int(nv[r])], cl[r, :int(nv[r])])]
                     for r, j in enumerate(idx[:len(srcs)])]
        rec["from_artifact"] = {"buckets": pred._buckets, "source": [480, 640],
                                "levels": [_closed_loop(pred, srcs, expected, c, ENTRY_SERVE_SECONDS,
                                                        min_answers=ENTRY_SERVE_ANSWERS)
                                           for c in (1, ENTRY_EXPORT_BATCH)],
                                "answers": "each equal to predict_pipeline's detections of its source"}
    finally:
        pred.close()
        torch.set_num_threads(threads)

    np.save(os.path.join(root, f"images_d{phi}.npy"), images)
    return rec, (phi, path, [t.cpu().numpy() for t in want])


def _start_fresh(root, phi, path):
    """A fresh ``python3`` that loads the artifact at ``path`` (building no
    model) and runs it once on ``images_d{phi}.npy``."""
    return subprocess.Popen(
        [sys.executable, "-c", _FRESH_LOAD, ROOT, path, os.path.join(root, f"images_d{phi}.npy"),
         os.path.join(root, f"fresh_d{phi}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _fresh_result(root, phi, proc, want):
    """The fresh process's answer against ``want`` (predict_pipeline's),
    bit for bit."""
    log, _ = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"export D{phi}: the fresh process failed:\n{log}")
    with np.load(os.path.join(root, f"fresh_d{phi}.npz")) as z:
        got = [z[f"arr_{i}"] for i in range(4)]
    rec = {"launches": json.loads(log.strip().splitlines()[-1]),
           **_close_detections(got, want, f"fresh process D{phi}")}
    if not rec["bit_for_bit"]:
        raise AssertionError(f"export D{phi}: the fresh process differs: {rec}")
    return rec


def _entry_sharded(et, hk, nk, model, cfg, ec):
    """make_sharded_predict_fn on an NCCL group of one rank in this process
    against make_predict_fn, batch ENTRY_SHARDED_BATCH: bit for bit, img/s
    of both."""
    import torch

    from efficientdet_tpu_torch.parallel import make_mesh, make_sharded_predict_fn
    from efficientdet_tpu_torch.parallel.launch import free_port

    size = cfg.image_size
    gen = torch.Generator(device=DEVICE).manual_seed(70)
    x = torch.randint(0, 256, (ENTRY_SHARDED_BATCH, size, size, 3), generator=gen, device=DEVICE,
                      dtype=torch.uint8)
    mesh = make_mesh(init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                     backend="nccl" if DEVICE == "cuda" else "gloo", device=DEVICE, timeout_s=120)
    try:
        if mesh.group is None:
            raise AssertionError("sharded predict: no process group")
        sharded = make_sharded_predict_fn(model, mesh, ec)
        plain = et.make_predict_fn(model, ec)
        hk.head_pointwise_anchor_major.launches = 0
        nk.suppression_keep_mask.launches = 0
        got = sharded(x)
        torch.cuda.synchronize()
        launches = {"head_pointwise": hk.head_pointwise_anchor_major.launches,
                    "nms_suppress": nk.suppression_keep_mask.launches}
        want = plain(x)
        _check_detections(got, 90, ENTRY_SHARDED_BATCH)
        bit = all(torch.equal(a, b) for a, b in zip(got, want))
        ms = {}
        for name, fn in (("sharded", sharded), ("make_predict_fn", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ENTRY_SHARDED_STEPS):
                fn(x)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) / ENTRY_SHARDED_STEPS * 1e3
    finally:
        mesh.close()
    rec = {"backend": "nccl" if DEVICE == "cuda" else "gloo", "world_size": 1,
           "batch": ENTRY_SHARDED_BATCH, "launches_one_call": launches, "bit_for_bit": bit,
           "img_s": ENTRY_SHARDED_BATCH / ms["sharded"] * 1e3,
           "make_predict_fn_img_s": ENTRY_SHARDED_BATCH / ms["make_predict_fn"] * 1e3}
    if not bit or launches != {"head_pointwise": 2, "nms_suppress": 1}:
        raise AssertionError(f"sharded predict D7: {rec}")
    return rec


def _entry_train_case(et, phi):
    """tests/torch_entry_train.py's reduced D``phi`` (its own backbone,
    fusion, anchor scale and depths; ENTRY_TRAIN_SIZE px, BiFPN width
    ENTRY_TRAIN_WIDTH, survival 1.0, the heads' final kernels N(0,
    ENTRY_FINAL_STD)) with drawn weights and a batch of ENTRY_TRAIN_BATCH
    noise images normalised on the host (so both devices take the same
    float32 images): ``_train_card_vs_cpu``'s arguments."""
    import dataclasses

    import torch

    from efficientdet_tpu_torch.ops.preprocess import preprocess_batch_fixed

    cfg = dataclasses.replace(et.ModelConfig.for_phi(phi, num_classes=90, image_size=ENTRY_TRAIN_SIZE),
                              bifpn_width=ENTRY_TRAIN_WIDTH, survival_prob=1.0)
    weights = drawn_state_dict(et.EfficientDet(cfg), seed=phi)
    rng = np.random.RandomState(1000 + phi)
    for k, v in weights.items():
        if ".final." in k and k.endswith("weight"):
            weights[k] = torch.from_numpy(rng.normal(0, ENTRY_FINAL_STD, tuple(v.shape)).astype(np.float32))
    batch = _bench_train_batch(ENTRY_TRAIN_SIZE, ENTRY_TRAIN_BATCH, seed=phi)
    batch["images"] = preprocess_batch_fixed(torch.from_numpy(batch["images"])).numpy()
    label = (f"D{phi} reduced: {cfg.backbone}, BiFPN {ENTRY_TRAIN_WIDTH} x {cfg.bifpn_depth} "
             f"({'weighted' if cfg.weighted_bifpn else 'unweighted'}), head depth {cfg.head_depth}, "
             f"anchor scale {cfg.anchor.anchor_scale}, {ENTRY_TRAIN_SIZE} px, batch "
             f"{ENTRY_TRAIN_BATCH}, survival 1.0")
    return cfg, weights, batch, label, True


def phase_entry_points(et, hk, nk, card):
    """Every entry point above D0 at D4@1024 and D7@1536 on weights drawn
    at FAMILY_GAIN with their BN statistics calibrated
    (experiments/drawn_weights.calibrate_bn): the Predictor (f32 and bf16),
    the server (bf16, BN folded), the .edz artifact, sharded predict (D7),
    and one training step card against CPU at the CPU tests' reduced size.
    Returns the phase's kernel launches (the wrappers' counters) and the
    launches its graphs hold."""
    import shutil

    import torch

    from efficientdet_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "efficientdet_tpu_torch", "_build", "smoke_entry")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    kernels = {"head_pointwise": hk.head_pointwise_anchor_major,
               "nms_suppress": nk.suppression_keep_mask}
    launches = {name: 0 for name in kernels}
    captured = {name: 0 for name in kernels}
    ec = et.EvalConfig(score_threshold=0.0)
    jobs, fresh = [], []

    def counted(section, fn, *args):
        """``fn(*args)`` with the counters at 0, its launches added to the
        phase's; its record emitted with its seconds."""
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        for name, k in kernels.items():
            launches[name] += k.launches
        rec = out[0] if isinstance(out, tuple) else out
        emit({"phase": "entry_points", "section": section, **rec,
              "seconds": time.perf_counter() - t0, "card": card})
        return out

    try:
        with _Captured(hk, cuda_build) as whole:
            for phi in ENTRY_PHIS:
                t0 = time.perf_counter()
                drawn = drawn_model(DEVICE, seed=phi, phi=phi, gain=FAMILY_GAIN, calibrate=True)
                state = {k: v.detach().clone() for k, v in drawn.state_dict().items()}
                del drawn
                emit({"phase": "entry_points", "phi": phi, "weights": "drawn_model(gain=FAMILY_GAIN, "
                      "calibrate=True)", "seconds": time.perf_counter() - t0})
                pred = counted(f"predictor D{phi}", _entry_predictor, et, hk, cuda_build, phi, state, card)
                for dtype in pred:
                    for row in pred[dtype]["shapes"] + [pred[dtype]["pipeline_graph"]]:
                        for name, n in row["captured_launches"].items():
                            captured[name] += n
                model, cfg = _entry_model(et, phi, state, torch.bfloat16)
                serve = counted(f"serve D{phi}", _entry_serve, et, hk, cuda_build, phi, model, cfg, ec, card)
                for name, n in serve["captured_launches"].items():
                    captured[name] += n
                export, job = counted(f"export D{phi}", _entry_export, et, hk, nk, cuda_build, phi,
                                      model, cfg, ec, root)
                jobs.append(job)
                for name, n in export["captured_launches"].items():
                    captured[name] += n
                if phi == 7:
                    counted("sharded predict D7", _entry_sharded, et, hk, nk, model, cfg, ec)
                del model, state
                torch.cuda.empty_cache()
            # the artifacts in fresh processes, alongside the training checks
            # (which time nothing), after every timed section
            fresh = [(phi, _start_fresh(root, phi, path), want) for phi, path, want in jobs]
            for phi in ENTRY_PHIS:
                counted(f"train D{phi}", _train_card_vs_cpu, et, *_entry_train_case(et, phi))
            for phi, proc, want in fresh:
                emit({"phase": "entry_points", "section": f"export D{phi} fresh process",
                      **_fresh_result(root, phi, proc, want)})
    finally:
        for _, proc, _ in fresh:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    by_plan = whole.plan_counts()
    if sum(by_plan.values()) != launches["head_pointwise"] or by_plan.get("resident"):
        raise AssertionError(f"entry_points: head launches {launches} by plan {by_plan}")
    emit({"phase": "entry_points", "launches": launches, "head_launches_by_plan": by_plan,
          "captured_launches": captured, "seconds": seconds, "card": card})
    return launches, captured, by_plan


STAGE_WARMUP = 2  # eager calls before the profiled ones
STAGE_CALLS = 3  # profiled eager calls of each configuration
STAGE_DIR = os.path.join(ROOT, "chiprun_out", "stages")  # the traces (gitignored)
STAGE_TIMEOUT = 900  # seconds the child may take
STAGE_SUM_TOL = 1e-3  # the stages against the busy time
STAGE_OTHER_SHARE = 0.05  # at most this share of an inference call's busy time outside the stages
STAGE_TOP = 8


def _stage_table(label, call, out_dir, name, inference, card):
    """STAGE_WARMUP eager calls of ``call()``, then STAGE_CALLS under
    utils.profiling.trace (a ProfilerStep range each), the trace written
    to out_dir/name and analysed by tools/analyze_trace.py, the table
    printed and appended to out_dir/tables.jsonl; the table's checks
    raise. Returns the analysis."""
    import torch

    from efficientdet_tpu_torch.tools.analyze_trace import analyze
    from efficientdet_tpu_torch.utils import profiling

    for _ in range(STAGE_WARMUP):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiling.trace(out_dir, name=name) as prof:
        for _ in range(STAGE_CALLS):
            call()
            prof.step()
    profiled_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = analyze(os.path.join(out_dir, name), top=STAGE_TOP)
    analyse_s = time.perf_counter() - t0
    rows = r["stages"]
    faults = []
    if r["mode"] != "device" or not r["events"]:
        faults.append(f"the trace holds no device event (mode {r['mode']})")
    if r["n_steps"] != STAGE_CALLS:
        faults.append(f"{r['n_steps']} calls in the trace, not {STAGE_CALLS}")
    if r["assigned"] != r["events"]:
        faults.append(f"{r['events']} device events, {r['assigned']} in a stage")
    staged = sum(v["ms_per_step"] for v in rows.values())
    if abs(staged - r["busy_ms_per_step"]) > STAGE_SUM_TOL * r["busy_ms_per_step"]:
        faults.append(f"the stages sum to {staged} ms, busy {r['busy_ms_per_step']} ms")
    other = sum(v["ms_per_step"] for k, v in rows.items() if k.startswith("other"))
    port = r["port_kernels"]
    heads = {row: n for k, v in port.items() if k.startswith("head_pw") for row, n in v.items()}
    nms = port.get("nms_suppress_kernel", {})
    if inference:
        if other >= STAGE_OTHER_SHARE * r["busy_ms_per_step"]:
            faults.append(f"other {other} ms of {r['busy_ms_per_step']} busy")
        if heads != {"heads": 2.0} or nms != {"postprocess": 1.0}:
            faults.append(f"the kernels a call: head {heads}, NMS {nms}")
    elif heads or nms:
        faults.append(f"a training step launched the port's kernels: {port}")
    keys = ("ms_per_step", "share", "launches", "tflops", "pct_peak", "gbps", "pct_hbm", "verdict")
    rec = {"phase": "stages", "model": label,
          "stages": {k: {key: v[key] for key in keys} for k, v in rows.items()},
          "busy_ms": r["busy_ms_per_step"], "stages_ms": staged, "call_ms": r["step_ms"],
          "events_a_call": r["events"] / r["n_steps"], "other_ms": other,
          "families": {k: v["ms_per_step"] for k, v in r["families"].items()},
          "port_kernels": port, "top": r["top"], "trace": os.path.relpath(r["trace"], ROOT),
          "trace_mb": os.path.getsize(r["trace"]) / 1e6, "profiled_s": profiled_s,
          "analyse_s": analyse_s, "checks": "ok" if not faults else faults, "card": card}
    emit(rec)
    with open(os.path.join(out_dir, "tables.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    if faults:
        raise AssertionError(f"stages {label}: {faults}")
    return r


def _device_events(path):
    from efficientdet_tpu_torch.tools.analyze_trace import DEVICE_CATS, load_events

    return sum(e.get("ph") == "X" and e.get("cat") in DEVICE_CATS for e in load_events(path))


def stages_child(out_dir):
    """Phase stages' fresh process: the stage tables of the main path
    (D0@512 b128), D1-D7 at FAMILY_BATCH and the two training steps; the
    D0 call's kernel count with the stage ranges off; the kernels' launches
    into out_dir/launches.json."""
    import torch

    import efficientdet_tpu_torch as et
    import efficientdet_tpu_torch.ops.head_kernel as hk
    import efficientdet_tpu_torch.ops.nms_kernel as nk
    from efficientdet_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kernels = {"head_pointwise": hk.head_pointwise_anchor_major,
               "nms_suppress": nk.suppression_keep_mask}
    for k in kernels.values():
        k.launches = 0

    def inference(phi, drawn=False):
        if not drawn:  # the main path's random weights
            model, cfg = et.build_efficientdet(phi, num_classes=90, dtype=torch.bfloat16,
                                               seed=phi, device=DEVICE)
        else:  # drawn_model's weights, drawn into the model once
            cfg = et.ModelConfig.for_phi(phi, num_classes=90)
            model = et.EfficientDet(cfg, torch.bfloat16)
            model.load_state_dict(drawn_state_dict(model, seed=phi, gain=FAMILY_GAIN))
            model = model.to(DEVICE).eval()
        model = et.fuse_for_inference(model)
        batch = BENCH_BATCH if phi == 0 else FAMILY_BATCH[phi]
        gen = torch.Generator(device=DEVICE).manual_seed(phi)
        images = torch.randint(0, 256, (batch, cfg.image_size, cfg.image_size, 3), generator=gen,
                               device=DEVICE, dtype=torch.uint8)
        predict = et.make_predict_fn(model)
        label = (f"D{phi}@{cfg.image_size} b{batch}, 90 classes, bf16, BN folded, anchor_major"
                 + (", weights drawn at FAMILY_GAIN" if drawn else ""))
        return label, lambda: predict(images), batch

    label, call, _ = inference(0)
    _stage_table(label, call, out_dir, "d0_b128.json.gz", True, card)
    # the same call with every stage range a nullcontext: as many kernels
    with_ranges = _device_events(os.path.join(out_dir, "d0_b128.json.gz")) / STAGE_CALLS
    with profiling.stages_off():
        with profiling.trace(out_dir, name="d0_b128_no_ranges.json.gz") as prof:
            call()
            prof.step()
    without = _device_events(os.path.join(out_dir, "d0_b128_no_ranges.json.gz"))
    emit({"phase": "stages", "d0_kernels_a_call": {"ranges": with_ranges, "nullcontext": without}})
    if with_ranges != without:
        raise AssertionError(f"the stage ranges changed the D0 call's kernels: {with_ranges} "
                             f"against {without}")
    del call
    torch.cuda.empty_cache()

    for phi in sorted(FAMILY_BATCH):
        label, call, batch = inference(phi, drawn=True)
        _stage_table(label, call, out_dir, f"d{phi}_b{batch}.json.gz", True, card)
        del call
        torch.cuda.empty_cache()

    for phi, size, batch, remat in ((0, TRAIN_SIZE, TRAIN_BATCH, False),
                                    (FAMILY_TRAIN_PHI, FAMILY_TRAIN_SIZE, FAMILY_TRAIN_BATCH, True)):
        host = _bench_train_batch(size, batch)
        data = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
        model, _ = et.build_efficientdet(phi, num_classes=90, seed=0, remat=remat, image_size=size,
                                         device=DEVICE)
        tc = et.TrainConfig(batch_size=batch, max_gt_boxes=TRAIN_MAX_GT)
        box = {"state": et.create_train_state(model, tc)}
        step = et.make_train_step(model, tc)
        gen = torch.Generator(device=DEVICE).manual_seed(1)

        def call():
            box["state"], _ = step(box["state"], data, gen)

        name = f"train_d{phi}_b{batch}" + ("_remat" if remat else "")
        _stage_table(f"training step D{phi}@{size} b{batch}, f32 (TF32 off)"
                     + (", remat" if remat else ""), call, out_dir, f"{name}.json.gz", False, card)
        del model, box, step, data
        torch.cuda.empty_cache()

    launches = {name: k.launches for name, k in kernels.items()}
    with open(os.path.join(out_dir, "launches.json"), "w") as f:
        json.dump(launches, f)
    return 0


def phase_stages(et, card):
    """Device time by stage (tools/analyze_trace.py) in a fresh process
    (stages_child): torch.profiler with the CUDA activity alone has
    recorded no kernel late in this script.
    Returns the child's head and NMS launches."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    # what this process's profiler sees now, for the record (PERF.md: the
    # late-script silence)
    model, cfg = et.build_efficientdet(0, num_classes=90, dtype=torch.bfloat16, seed=0)
    images = torch.zeros((2, cfg.image_size, cfg.image_size, 3), dtype=torch.uint8, device=DEVICE)
    predict = et.make_predict_fn(et.fuse_for_inference(model))
    predict(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predict(images)
        torch.cuda.synchronize()
    seen = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    # and with the CUDA activity alone, as kernel_ms profiles
    cuda_alone = kernel_ms(lambda: predict(images), calls=1)
    emit({"phase": "stages", "in_process_profiler": {
        "device_events": seen,
        "cpu_events": sum(1 for e in prof.events() if e.device_type.name == "CPU"),
        "cuda_activity_alone_kernels": len(cuda_alone),
        "cuda_activity_alone_ms": sum(cuda_alone.values()),
        "supported_activities": sorted(str(a) for a in torch.profiler.supported_activities())}})
    del model, predict, images, prof
    torch.cuda.empty_cache()

    shutil.rmtree(STAGE_DIR, ignore_errors=True)
    os.makedirs(STAGE_DIR)
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--stages-child", STAGE_DIR],
                          cwd=ROOT, timeout=STAGE_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"the stages child exited with {proc.returncode}")
    with open(os.path.join(STAGE_DIR, "launches.json")) as f:
        launches = json.load(f)
    sizes = {n: os.path.getsize(os.path.join(STAGE_DIR, n)) / 1e6 for n in os.listdir(STAGE_DIR)}
    emit({"phase": "stages", "launches": launches, "trace_mb": sizes,
          "seconds": time.perf_counter() - t0, "card": card})
    return launches


DRILL_PHIS = (0, 7)
DRILL_IMAGES = 16
DRILL_CPU_IMAGES = 4  # the card's D0 detections against the CPU drill's on these
DRILL_BATCH = 8


def _drill_args(weights, phi, *extra):
    from efficientdet_tpu_torch.tools import parity_run

    return parity_run.parse_args(["--weights", weights, "--coco-path", "unused", "--phi", str(phi),
                                  "--batch-size", str(DRILL_BATCH), "--dtype", "f32", *extra])


def _detections_by_image(path, n):
    """A saved COCO results file as each of the first ``n`` images' (boxes
    xyxy, scores, classes), by falling score."""
    with open(path) as f:
        results = json.load(f)
    out = []
    for i in range(n):
        rows = sorted((r for r in results if r["image_id"] == i), key=lambda r: -r["score"])
        boxes = np.array([[x, y, x + w, y + h] for x, y, w, h in (r["bbox"] for r in rows)],
                         np.float64).reshape(-1, 4)
        out.append((boxes, np.array([r["score"] for r in rows]),
                    np.array([r["category_id"] for r in rows])))
    return out


def phase_parity_drill(et, hk, nk, card):
    """tools/parity_run.py on the card: archives of TF-named arrays written
    by utils/convert.export_detector_tf_style from D0@512 and D7@1536 (full
    width, 90 classes, weights drawn at FAMILY_GAIN with calibrated BN), the
    drill in f32 through sharded predict (world size 1), both kernels and
    the exact COCO evaluation on DRILL_IMAGES numpy images with boxes; a
    truncated array fails the strict import; the card's D0 detections on
    DRILL_CPU_IMAGES images against the CPU drill's (the Predictor rule).
    Returns the phase's head and NMS launches."""
    import tempfile

    import torch

    from efficientdet_tpu_torch.tools import parity_run
    from efficientdet_tpu_torch.utils.convert import export_detector_tf_style

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    kernels = {"head_pointwise": hk.head_pointwise_anchor_major,
               "nms_suppress": nk.suppression_keep_mask}
    launches = {name: 0 for name in kernels}
    ds = _smoke_dataset(et, n=DRILL_IMAGES, seed=5)
    with tempfile.TemporaryDirectory(prefix="parity_drill_") as tmp:
        archives = {}
        for phi in DRILL_PHIS:
            t0 = time.perf_counter()
            drawn = drawn_model(DEVICE, seed=phi, phi=phi, gain=FAMILY_GAIN, calibrate=True)
            tf_vars = export_detector_tf_style(drawn, drawn.config)
            del drawn
            archives[phi] = os.path.join(tmp, f"d{phi}.npz")
            np.savez(archives[phi], **tf_vars)
            export_s = time.perf_counter() - t0
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            result = parity_run.run(_drill_args(archives[phi], phi), dataset=ds)
            torch.cuda.synchronize()
            drill_s = time.perf_counter() - t0
            got = {name: k.launches for name, k in kernels.items()}
            for name, n in got.items():
                launches[name] += n
            rec = result["record"]
            del result
            torch.cuda.empty_cache()
            batches = -(-DRILL_IMAGES // DRILL_BATCH)
            emit({"phase": "parity_drill", "phi": phi, "variables": len(tf_vars),
                  "archive_mb": os.path.getsize(archives[phi]) / 1e6, "parity": rec,
                  "launches": got, "export_s": export_s, "drill_s": drill_s, "card": card})
            if got != {"head_pointwise": 2 * batches, "nms_suppress": batches}:
                raise AssertionError(f"parity_drill D{phi}: kernel launches {got} over {batches} "
                                     "batches")
            if not np.isfinite(rec["AP"]) or rec["images"] != DRILL_IMAGES:
                raise AssertionError(f"parity_drill D{phi}: {rec}")
            del tf_vars

        # a truncated array fails the strict import
        with np.load(archives[0]) as z:
            bad = {k: z[k] for k in z.files}
        first = sorted(bad)[0]
        bad[first] = bad[first].reshape(-1)[:max(bad[first].size - 1, 1)]
        bad_path = os.path.join(tmp, "bad.npz")
        np.savez(bad_path, **bad)
        try:
            parity_run.run(_drill_args(bad_path, 0), dataset=ds)
        except ValueError as e:
            refused = str(e)[:200]
        else:
            raise AssertionError("parity_drill: the truncated archive was imported")

        # the card's D0 detections against the CPU drill's, the Predictor rule
        dets = {}
        for device in ("cuda", "cpu"):
            path = os.path.join(tmp, f"dets_{device}.json")
            k0 = {name: k.launches for name, k in kernels.items()}
            parity_run.run(_drill_args(archives[0], 0, "--device", device, "--max-images",
                                       str(DRILL_CPU_IMAGES), "--save-detections", path),
                           dataset=ds)
            for name, k in kernels.items():
                launches[name] += k.launches - k0[name]
            dets[device] = _detections_by_image(path, DRILL_CPU_IMAGES)
        faults = [detection_mismatch(g, w, 1e-3, 1e-5) for g, w in zip(dets["cuda"], dets["cpu"])]
        counts = [len(d[1]) for d in dets["cuda"]]
        box = max(float(np.abs(g[0] - w[0]).max()) for g, w in zip(dets["cuda"], dets["cpu"]))
        score = max(float(np.abs(g[1] - w[1]).max()) for g, w in zip(dets["cuda"], dets["cpu"]))
    emit({"phase": "parity_drill", "truncated_archive": refused,
          "card_vs_cpu_d0": {"images": DRILL_CPU_IMAGES, "detections": counts,
                             "max_box_px_in_order": box, "max_score_in_order": score,
                             "faults": faults},
          "launches": launches, "seconds": time.perf_counter() - t_phase, "card": card})
    if any(faults):
        raise AssertionError(f"parity_drill: the card's D0 detections differ from the CPU's: {faults}")
    return launches


def run_phase(name, fn, *args):
    """``{"phase": name}`` on stdout, then ``fn(*args)``, then the phase's
    seconds (``{"phase_seconds": name, ...}``); a failure's traceback goes
    to stdout too (with the phase named above it) and the exception
    propagates, so the exit code stays non-zero."""
    emit({"phase": name})
    t0 = time.perf_counter()
    try:
        out = fn(*args)
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})
        return out
    except BaseException:
        print(f"chip_smoke: phase {name} failed:", flush=True)
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        raise


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-dir", default=None,
                        help="profile three batch-128 calls; write their trace here")
    parser.add_argument("--stages-child", default=None, metavar="DIR",
                        help=argparse.SUPPRESS)  # phase stages' fresh process
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if args.stages_child:
        return stages_child(args.stages_child)
    import efficientdet_tpu_torch as et
    import efficientdet_tpu_torch.ops.bifpn_node as bn
    import efficientdet_tpu_torch.ops.conv_epilogue as ce
    import efficientdet_tpu_torch.ops.depthwise_conv as dc
    import efficientdet_tpu_torch.ops.head_kernel as hk
    import efficientdet_tpu_torch.ops.nms as tn
    import efficientdet_tpu_torch.ops.nms_kernel as nk
    import efficientdet_tpu_torch.ops.mbconv_kernel as mk
    import efficientdet_tpu_torch.ops.tap_floor_kernel as tk
    from efficientdet_tpu_torch.experiments import folded_ops as xf
    from efficientdet_tpu_torch.experiments import packed_chain as pc
    from efficientdet_tpu_torch.experiments import packed_mbconv as pm
    from efficientdet_tpu_torch.experiments import tap_floor as tf
    from efficientdet_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = run_phase("device", phase_device, cuda_build)
    head_err, head_t = run_phase("head_kernel", phase_head, hk)
    nms_t = run_phase("nms_kernel", phase_nms, nk)
    launches, ms_per_call = run_phase("pipeline", phase_pipeline, et, hk, nk, ce, dc, bn, card,
                                        args.profile_dir)
    run_phase("gpu_vs_cpu", phase_gpu_vs_cpu, et, tn)
    mb_err, mb_blocks, harness = run_phase("mbconv_kernels", phase_mbconv, mk, pm)
    chains, chain_launches = run_phase("chain", phase_chain, mk, pc)
    floor_err, floor, floor_plain, floor_launches = run_phase(
        "tap_floor", phase_tap_floor, tk, tf, chains[0]["baseline_ms"], ms_per_call)
    epi, d0 = run_phase("conv_epilogue", phase_conv_epilogue, xf)
    dwc = run_phase("depthwise_conv", phase_depthwise_conv, xf, d0)
    node = run_phase("bifpn_node", phase_bifpn_node, xf, d0)
    run_phase("predictor", phase_predictor, et, nk, card)
    run_phase("serve", phase_serve, et, hk, nk, card)
    export_launches = run_phase("export", phase_export, et, hk, nk, card)
    kernels = {"head_pointwise": hk.head_pointwise_anchor_major,
               "nms_suppress": nk.suppression_keep_mask,
               "fused_mbconv_packed": mk.packed_mbconv, "fused_mbconv_rp": mk.packed_mbconv_rp,
               "fused_mbconv_nhwc": mk.fused_mbconv_nhwc, "tap_floor": tk.tap_floor}
    train = run_phase("train", phase_train, et, kernels, card, args.profile_dir)
    _, ds = run_phase("data", phase_data, et, card)
    cli = run_phase("train_cli", phase_train_cli, et, kernels, card, ds)
    eval_launches = cli["eval"]["launches"]
    par = run_phase("parallel", phase_parallel, et, kernels, card, ms_per_call, train)
    par_launches = par["launches"]
    family_launches, family_heads = run_phase("family", phase_family, et, hk, nk, tn, card,
                                              ms_per_call)
    entry_launches, entry_captured, entry_plans = run_phase("entry_points", phase_entry_points, et,
                                                            hk, nk, card)
    torch.cuda.empty_cache()
    stage_launches = run_phase("stages", phase_stages, et, card)
    drill_launches = run_phase("parity_drill", phase_parity_drill, et, hk, nk, card)
    run_phase("int8", phase_int8, card)
    run_phase("stage1_packing", phase_stage1, card)

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
                "library_ms": None, "device_ms": tot("device_ms"),
                "module_ms": sum(b["module_ms"] for b in mb_blocks),
                "train_cli_eval_launches": eval_launches[f"fused_mbconv_{layout}"],
                "parallel_launches": par_launches[f"fused_mbconv_{layout}"], "family_launches": 0,
                "stages_launches": 0, "parity_drill_launches": 0}

    emit({"kernels": [
        {"name": "head_pointwise", "route": "cuda",
         "source": "efficientdet_tpu_torch/csrc/head_pointwise.cu",
         "replaces": "efficientdet_tpu/ops/head_pallas.py:46",
         "launches": launches["head_pointwise"], "max_abs_err": head_err,
         "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
         "bound_by": head_t[0]["bound_by"], "library_ms": total("library_ms"),
         "device_ms": total("device_ms"), "train_cli_eval_launches": eval_launches["head_pointwise"],
         "export_launches": export_launches["head_pointwise"],
         "parallel_launches": par_launches["head_pointwise"],
         "family_launches": family_launches["head_pointwise"],
         "family_launch_ms": family_heads,
         "entry_points_launches": entry_launches["head_pointwise"],
         "entry_points_launches_by_plan": entry_plans,
         "entry_points_captured_launches": entry_captured["head_pointwise"],
         "stages_launches": stage_launches["head_pointwise"],
         "parity_drill_launches": drill_launches["head_pointwise"]},
        {"name": "nms_suppress", "route": "cuda",
         "source": "efficientdet_tpu_torch/csrc/nms_suppress.cu",
         "replaces": "efficientdet_tpu/ops/nms_pallas.py:34",
         "launches": launches["nms_suppress"], "max_abs_err": 0.0,
         "ms": nms_t["ms"], "plain_ms": nms_t["plain_ms"], "bound_ms": nms_t["bound_ms"],
         "bound_by": nms_t["bound_by"], "library_ms": None, "device_ms": nms_t["device_ms"],
         "train_cli_eval_launches": eval_launches["nms_suppress"],
         "export_launches": export_launches["nms_suppress"],
         "parallel_launches": par_launches["nms_suppress"],
         "family_launches": family_launches["nms_suppress"],
         "entry_points_launches": entry_launches["nms_suppress"],
         "entry_points_captured_launches": entry_captured["nms_suppress"],
         "stages_launches": stage_launches["nms_suppress"],
         "parity_drill_launches": drill_launches["nms_suppress"]},
        mbconv_row("packed", "experiments/packed_mbconv_pallas.py:201", chain_launches),
        mbconv_row("rp", "experiments/packed_mbconv_pallas.py:360", harness["rp"]),
        mbconv_row("nhwc", "experiments/mbconv_pallas.py:52", harness["nhwc"]),
        {"name": "tap_floor", "route": "cuda", "source": "efficientdet_tpu_torch/csrc/tap_floor.cu",
         "replaces": "experiments/vpu_tap_floor.py:85", "launches": floor_launches,
         "max_abs_err": floor_err, "ms": floor["kernel_ms"], "plain_ms": floor_plain,
         "bound_ms": floor["bound_ms"], "bound_by": floor["bound_by"], "library_ms": None,
         "device_ms": floor["device_ms"], "train_cli_eval_launches": eval_launches["tap_floor"],
         "parallel_launches": par_launches["tap_floor"], "family_launches": 0,
         "stages_launches": 0, "parity_drill_launches": 0},
        {"name": "conv_epilogue", "route": "cuda",
         "source": "efficientdet_tpu_torch/csrc/conv_epilogue.cu",
         "replaces": None, "launches": launches["conv_epilogue"],
         "padded": launches["conv_epilogue_padded"],
         "max_abs_err": epi["f32_max_abs_err"], "bf16_ulps": epi["check"]["ulps"],
         "ms": epi["ms"], "plain_ms": epi["plain_ms"], "bound_ms": epi["bound_ms"],
         "bound_by": epi["bound_by"], "library_ms": None, "device_ms": epi["device_ms"]},
        {"name": "depthwise_conv", "route": "cuda",
         "source": "efficientdet_tpu_torch/csrc/depthwise_conv.cu",
         "replaces": None, "launches": launches["depthwise_conv"],
         "f32_excess": dwc["f32_check"]["excess"],
         "bf16_ulps": max(c["check"]["ulps"] for c in dwc["cells"].values()),
         **{f"d{phi}_{key}": c[key] for phi, c in dwc["cells"].items()
            for key in ("ms", "device_ms", "bound_ms", "library_ms", "mean_ms", "roofline")},
         "bound_by": "bytes", "plain_ms": None},
        {"name": "bifpn_node", "route": "cuda",
         "source": "efficientdet_tpu_torch/csrc/bifpn_node.cu",
         "replaces": None, "launches": launches["bifpn_node"],
         "f32_excess": node["f32_check"]["excess"],
         "f32_max_abs_err": node["f32_check"]["max_abs_err"],
         "bf16_ulps": max(c["check"]["ulps"] for c in node["cells"].values()),
         **{f"d{phi}_{key}": c[key] for phi, c in node["cells"].items()
            for key in ("ms", "device_ms", "bound_ms", "library_ms", "roofline")},
         "bound_by": "bytes", "plain_ms": None},
    ], "note": "head_pointwise, nms_suppress: ms per main-path call at batch 128 (head: the "
               "class and the box launch together), the wrapper's call by CUDA events; "
               "device_ms the kernels alone, by torch.profiler; launches over 3 pipeline calls. "
               "fused_mbconv_*: ms summed over the six BLOCKS shapes (D0 at batch 128, D4 at 16), "
               "bf16, device_ms their launches alone (torch.profiler), module_ms the port's unfused "
               "MBConvBlock there; launches: packed over the "
               "chain phase, rp and nhwc over the block harness. tap_floor: f32, taps 9, "
               "chains 4, repeats 512 over 4 Mi elements; launches over the floor harness, device_ms "
               "its launch alone (torch.profiler). train_cli_eval_launches: each kernel's launches "
               "during the train_cli phase's timed COCO evaluation (64 images, batch 64). "
               "export_launches: the head and NMS kernels' launches in one eager call of the "
               "export phase's .edz program (D0@512 bf16, batch 32). parallel_launches: each "
               "kernel's launches in the parallel phase, its world-size-1 paths in this process "
               "and its two gloo ranks together. family_launches: the head and NMS kernels' "
               "launches in the family phase's counted calls, one a phi (D1-D7, bf16). "
               "family_launch_ms: the head kernel's class and box launches at each phi's rows "
               "and Cin (the streamed plan), ms the wrapper's call and device_ms the bare "
               "launch, both by CUDA events over 10, beside the bound, the plain version "
               "and addmm + amax. entry_points_launches: the head and NMS kernels' launches "
               "in the entry_points phase (D4@1024, D7@1536: warm-up, capture and eager calls; "
               "a replay ticks no counter), the head's also by plan; "
               "entry_points_captured_launches: the launches its CUDA graphs hold (counted at "
               "capture), which every replay runs. stages_launches: the head and NMS kernels' "
               "launches in the stages phase's fresh process (D0@512 b128 and D1-D7 at "
               "FAMILY_BATCH, warm-up and profiled eager calls; the training steps launch none). "
               "parity_drill_launches: their launches in the parity_drill phase (the drill at "
               "D0@512 and D7@1536 on 16 images, and at D0 on 4 for the card-CPU check). "
               "conv_epilogue: replaces no TPU kernel (XLA fuses a conv's epilogue); launches "
               "and padded over the same 3 pipeline calls (32 and 4 a call), ms summed over "
               "one D0 forward's 32 calls at batch 128 bf16, plain_ms ATen's add, silu, add "
               "and pad there. depthwise_conv: replaces no TPU kernel (XLA fuses the depthwise "
               "conv, its epilogue and the SE's reduction); launches over the same 3 pipeline "
               "calls (16 a call); d<phi>_*: summed over one forward's calls at the benchmark's "
               "batch (D0 128, D4 64, D7x 16), bf16; library_ms cuDNN's depthwise conv and the "
               "epilogue, mean_ms the SE's torch.mean they replace. bifpn_node: replaces no TPU "
               "kernel (XLA fuses a node's resample, sum and swish); launches over the same 3 "
               "pipeline calls (24 a call); d<phi>_*: summed over one forward's node calls at "
               "the benchmark's batch, bf16; library_ms ATen's resample and fusion it replaces.",
        "elapsed_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
