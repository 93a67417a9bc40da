"""Batched inference of a detector whose pyramid is not P3..P7 (EfficientDet-D7x:
P3..P8): ``traffic/batched.py`` step for step, with the reference, its
weights and the FLOP count made from ``reference/levels.py``.

A job sends full batches of uint8 images at model resolution and takes each
batch's detections back to the host: the port's
``make_predict_fn(fuse_for_inference(model), front_end=...)`` with the
default ``EvalConfig``. Each call uploads one batch from a ring of distinct
pinned host batches drawn from the seed, runs the pipeline and copies the
detections to the host; calls follow each other for the window.
``infer_img_s`` is every image whose detections reached the host over the
whole window. Set-up first asks the port for the configuration (a port that
cannot build it fails here, before any weight is drawn), then draws the
weights and the ring and makes ``warmup_calls`` calls, which build the
kernels and fill the anchor cache.

``correct``: ``check_images`` images drawn from the seed among those the
window served, their detections against the reference's on the same canvas
(``lib/compare.py``), the reference run ``check_block`` images at a time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib import detect, peaks, roofline
from portbench.lib.models import DTYPES, port_config, port_model, reference_config
from portbench.lib.trace import Tracer
from portbench.lib.weights import calibrate, draw
from portbench.reference.config import Eval
from portbench.reference.levels import Detector
from portbench.reference.model import Conv2d


def reference_model(config, state_dict, device, quant=None) -> Detector:
    model = Detector(config, quant).to(device)
    model.load_state_dict(state_dict)
    return model.eval()


def drawn_state_dict(config, seed: int, device):
    """``lib/weights.drawn_state_dict`` through the level-generic reference:
    the weights drawn from ``seed``, the BN statistics calibrated."""
    ref = Detector(config).to(device)
    ref.load_state_dict(draw(ref, seed))
    calibrate(ref, seed)
    return {k: v.detach().clone() for k, v in ref.state_dict().items()}


def inference_flops(config, batch: int) -> float:
    """``lib/flops.inference_flops`` counted on the level-generic reference:
    2 B Cout H' W' (Cin / groups) k^2 a convolution call of one forward pass
    on the ``meta`` device."""
    model = Detector(config).to("meta").eval()
    total = [0]

    def hook(mod, inputs, out):
        total[0] += 2 * out.numel() * mod.weight.shape[1] * mod.k * mod.k

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv2d)]
    size = config.image_size
    with torch.no_grad():
        model(torch.zeros((batch, size, size, 3), device="meta"))
    for h in handles:
        h.remove()
    return float(total[0])


def run(bench) -> None:
    p, dev = bench.params, bench.device
    port_config(bench.config)
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
    bench.extra["flops_per_call"] = inference_flops(cfg, batch)
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
    ref = reference_model(cfg, sd, dev)
    gaps, pairs = detect.gaps(ref, canvases, port, Eval(), p["check_block"])
    bench.extra["check"] = {"cfg": cfg, "sd": sd, "canvases": canvases, "ev": Eval(),
                            "block": p["check_block"], "port": port}
    bench.numbers = gaps.numbers()
    bench.faults = gaps.bad
    k = Eval().pre_nms_top_k
    bench.extra["nms_bound"] = peaks.bound_s(*roofline.nms_kernel(batch, k, pairs * batch), "f32")
