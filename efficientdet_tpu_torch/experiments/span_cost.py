"""What the port's span recorder costs on the card, off and on, and what the
profiler's own host cost does to a step.

    python3 -m efficientdet_tpu_torch.experiments.span_cost [--rounds 4] [--calls 6] [--out FILE]

In one process on one GPU (it raises without one):

1. ``span``: one span opened and closed ``SPAN_REPS`` times with recording
   off, inside ``record_spans()``, and inside a ``torch.profiler`` session
   (CPU and CUDA activities), beside its bare ``record_function`` range:
   host us a span.
2. ``train`` and ``infer``: the D0@512 f32 training step at batch 64 (TF32
   off, ``TrainConfig`` defaults, noise images with 12 boxes each) and the
   D0@512 bf16 batched call at batch 128 (BN folded, ``"anchor_major"``,
   detections copied to the host), both on drawn weights; ``--rounds``
   rounds of ``--calls`` calls, recording off and inside ``record_spans()``
   in turns (off, on, on, off, ...), ms a call by the host clock fenced at
   both ends of each round.
3. In each of those, the spans of ``--calls`` calls inside ``record_spans()``
   and again inside a profiler session as the benchmark's traced stretch
   opens it: per span name its count, host ms, self host ms and stream ms a
   call, and the spans a call.

Prints one JSON line a part and a last line with all of them and the card's
name and power limit; ``--out`` also writes that line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time

import torch

SPAN_REPS = 20000
# the cells' shapes (d0-train, d0-b128); a CPU rehearsal makes them small
DEVICE, SIZE, TRAIN_BATCH, INFER_BATCH = "cuda", 512, 64, 128


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return got.stdout.strip() or torch.cuda.get_device_name(0)


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span_us() -> dict:
    """Host us a ``loss.focal`` span: off, its bare ``record_function`` range
    (no profiler), recorded, and recorded under the profiler."""
    from efficientdet_tpu_torch.utils import profiling

    def per_span() -> float:
        t0 = time.perf_counter()
        for _ in range(SPAN_REPS):
            with profiling.span("loss.focal"):
                pass
        return (time.perf_counter() - t0) / SPAN_REPS * 1e6

    def bare_range() -> float:
        t0 = time.perf_counter()
        for _ in range(SPAN_REPS):
            with torch.profiler.record_function(profiling.SPAN_RANGES["loss.focal"]):
                pass
        return (time.perf_counter() - t0) / SPAN_REPS * 1e6

    out = {"off_us": per_span(), "record_function_us": bare_range()}
    with profiling.record_spans():
        out["recorded_us"] = per_span()
    profiling.clear()
    with _profiler():
        out["profiled_us"] = per_span()
    profiling.clear()
    return out


def spans_of(fn, calls: int, profiled: bool) -> dict:
    """Per span name, a call: count, host ms, self host ms, stream ms, over
    ``calls`` calls of ``fn`` recorded (``profiled``: under the profiler)."""
    from efficientdet_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    profiling.clear()
    with _profiler() if profiled else profiling.record_spans():
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    rows = profiling.summary()
    profiling.clear()
    per = {name: {k: (v / calls if isinstance(v, float) else v) for k, v in row.items()}
           for name, row in rows.items()}
    return {"spans_a_call": sum(r["count"] for r in rows.values()) / calls, "spans": per}


def on_off(fn, rounds: int, calls: int) -> dict:
    """ms a call with recording off and on, in turns (off, on, on, off, ...)."""
    from efficientdet_tpu_torch.utils import profiling

    got = {"off": [], "on": []}
    order = [m for r in range(rounds) for m in (("off", "on") if r % 2 == 0 else ("on", "off"))]
    for mode in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.record_spans() if mode == "on" else contextlib.nullcontext():
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        got[mode].append((time.perf_counter() - t0) / calls * 1e3)
        profiling.clear()
    return {f"{m}_ms": v for m, v in got.items()} | {
        f"{m}_median_ms": statistics.median(v) for m, v in got.items()}


def train_part(rounds: int, calls: int) -> dict:
    import efficientdet_tpu_torch as et
    from efficientdet_tpu_torch.experiments.drawn_weights import drawn_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = drawn_model(DEVICE, seed=0, image_size=SIZE).train()
    tc = et.TrainConfig(batch_size=TRAIN_BATCH)
    box = {"state": et.create_train_state(model, tc, device=DEVICE)}
    step = et.make_train_step(model, tc, device=DEVICE)
    gen = torch.Generator(DEVICE).manual_seed(0)
    ring = [_train_batch(torch.Generator(DEVICE).manual_seed(i)) for i in range(2)]

    def call(i):
        box["state"], _ = step(box["state"], ring[i % 2], gen)

    for i in range(3):
        call(i)
    return {"on_off": on_off(call, rounds, calls), "recorded": spans_of(call, calls, False),
            "profiled": spans_of(call, calls, True)}


def _train_batch(gen, gt=12, max_gt=100):
    """Noise images with ``gt`` boxes of 16-64 px each, the other slots padding."""
    batch, size = TRAIN_BATCH, SIZE
    u = torch.rand((4, batch, gt), generator=gen, device=DEVICE)
    x1, y1 = u[0] * (size - 64), u[1] * (size - 64)
    w, h = 16 + 48 * u[2], 16 + 48 * u[3]
    boxes = torch.zeros((batch, max_gt, 4), device=DEVICE)
    boxes[:, :gt] = torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)
    labels = torch.full((batch, max_gt), -1, dtype=torch.int32, device=DEVICE)
    labels[:, :gt] = torch.randint(0, 90, (batch, gt), generator=gen, device=DEVICE,
                                   dtype=torch.int32)
    images = torch.randint(0, 256, (batch, size, size, 3), generator=gen, device=DEVICE,
                           dtype=torch.uint8)
    return {"images": images, "gt_boxes": boxes, "gt_labels": labels}


def infer_part(rounds: int, calls: int) -> dict:
    import efficientdet_tpu_torch as et
    from efficientdet_tpu_torch.experiments.drawn_weights import drawn_model

    f32 = drawn_model(DEVICE, seed=0, image_size=SIZE, calibrate=True)
    model = et.EfficientDet(f32.config, torch.bfloat16).to(DEVICE)
    model.load_state_dict(f32.state_dict())
    predict = et.make_predict_fn(et.fuse_for_inference(model.eval()))
    del f32
    gen = torch.Generator(DEVICE).manual_seed(1)
    ring = [torch.randint(0, 256, (INFER_BATCH, SIZE, SIZE, 3), generator=gen, device=DEVICE,
                          dtype=torch.uint8).cpu() for _ in range(2)]
    if DEVICE != "cpu":
        ring = [t.pin_memory() for t in ring]

    def call(i):
        dets = predict(ring[i % 2].to(DEVICE, non_blocking=True))
        return tuple(t.cpu() for t in dets)

    for i in range(3):
        call(i)
    return {"on_off": on_off(call, rounds, calls), "recorded": spans_of(call, calls, False),
            "profiled": spans_of(call, calls, True)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--calls", type=int, default=6)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_cost needs an NVIDIA GPU")
    torch.cuda.init()
    result = {"card": card(), "torch": torch.__version__}
    for name, part in (("span", lambda: span_us()),
                       ("train", lambda: train_part(args.rounds, args.calls)),
                       ("infer", lambda: infer_part(args.rounds, args.calls))):
        result[name] = part()
        print(json.dumps({"part": name, **result[name]}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
