"""Batched inference: a job that sends full batches of uint8 images at model
resolution and takes each batch's detections back to the host.

The port's ``make_predict_fn(fuse_for_inference(model), front_end=...)``
with the default ``EvalConfig``. Each call uploads one batch from a ring of
distinct pinned host batches drawn from the seed, runs the pipeline and
copies the detections to the host; calls follow each other for the window.
``infer_img_s`` is every image whose detections reached the host over the
whole window. Set-up draws the weights and the ring and makes
``warmup_calls`` calls, which build the kernels and fill the anchor cache.

``correct``: ``check_images`` images drawn from the seed among those the
window served, their detections against the reference's on the same
canvas (``lib/compare.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib import detect, flops, peaks, roofline
from portbench.lib.models import DTYPES, port_model, reference_config
from portbench.lib.trace import Tracer
from portbench.lib.weights import drawn_state_dict
from portbench.reference.config import Eval



def run(bench) -> None:
    p, dev = bench.params, bench.device
    cfg = reference_config(bench.config)
    size, batch = cfg.image_size, p["batch"]
    bench.stamp("torch and the card")
    sd = drawn_state_dict(cfg, bench.seed_for("weights"), dev)
    bench.stamp("weights drawn and calibrated")
    from efficientdet_tpu_torch import EvalConfig, make_predict_fn

    model = port_model(bench.config, sd, DTYPES[p["precision"]], dev, fuse=True)
    predict = make_predict_fn(model, EvalConfig(), front_end=p["front_end"])
    gen = torch.Generator(dev).manual_seed(bench.seed_for("images"))
    ring = [bench.host(torch.randint(0, 256, (batch, size, size, 3), generator=gen, device=dev,
                          dtype=torch.uint8)) for _ in range(p["ring"])]

    bench.stamp("port model and ring")

    def call(i):
        dets = predict(ring[i % len(ring)].to(dev, non_blocking=True))
        return tuple(t.cpu() for t in dets)

    for i in range(p["warmup_calls"]):
        call(i)
        bench.stamp(f"warm-up call {i}")
    bench.extra["flops_per_call"] = flops.inference_flops(cfg, batch)
    bench.extra["precision"] = p["precision"]
    bench.extra["head_bound"] = peaks.bound_s(*roofline.head_kernel(cfg, batch), p["precision"])
    tracer = Tracer(bench) if bench.trace_on else None
    first, last = p["trace_start_call"], p["trace_start_call"] + p["trace_calls"]
    bench.sync()
    bench.reset_peak()
    bench.mark_setup_done()
    outs = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < bench.seconds or (tracer and len(outs) < last):
        if tracer and len(outs) == first:
            tracer.start()
        outs.append(call(len(outs)))
        if tracer and len(outs) == last:
            bench.trace = tracer.stop(p["trace_calls"])
    elapsed = time.perf_counter() - t0
    bench.memory_peak_bytes = bench.peak_bytes()
    n = len(outs) * batch
    bench.attempted = n
    bench.end_to_end = {"infer_img_s": n / elapsed, "peak_gb": bench.memory_peak_bytes / 1e9}
    bench.log(f"window: {len(outs)} calls of {batch} images in {elapsed:.4f} s")

    del model, predict
    bench.free()
    rng = np.random.default_rng(bench.seed_for("check"))
    picks = sorted(rng.choice(n, size=min(p["check_images"], n), replace=False).tolist())
    canvases = torch.stack([ring[(k // batch) % len(ring)][k % batch] for k in picks]).to(dev)
    port = [detect.valid(outs[k // batch], k % batch) for k in picks]
    ref = detect.reference_model(cfg, sd, dev)
    gaps, pairs = detect.gaps(ref, canvases, port, Eval(), p["check_block"])
    bench.extra["check"] = {"cfg": cfg, "sd": sd, "canvases": canvases, "ev": Eval(),
                            "block": p["check_block"], "port": port}
    bench.numbers = gaps.numbers()
    bench.faults = gaps.bad
    k = Eval().pre_nms_top_k
    bench.extra["nms_bound"] = peaks.bound_s(*roofline.nms_kernel(batch, k, pairs * batch), "f32")
