"""Training: the port's ``make_train_step`` over one ``create_train_state``,
step after step on a ring of distinct device batches.

float32 with TF32 off (the configuration's training precision),
``TrainConfig`` defaults (Adam at 1e-3, the per-level loss). Each batch is
uint8 noise with ``gt`` boxes an image of 16-64 pixels and random classes,
``max_gt`` slots, drawn from the seed on the device. Stochastic depth draws
from a device generator seeded from the run's seed.

Set-up builds the one state the window trains and drives it through its
first ``check_steps`` steps, by the window's own call on the ring's first
batches: those steps are the ones the check reads (each loss; the first
gradient, from Adam's first moment after one step; the parameters' change
after the last), then ``warmup_steps`` more. ``train_img_s`` is every
step's images over all the time of the window, fenced at its end.

``correct``: once the window has closed and the port's state is freed, the
reference takes the same steps from the same weights, batches and draws
(``lib/compare.py``: ``loss_rel``, ``grad_leaf``, ``change_leaf``).
"""

from __future__ import annotations

import time

import torch

from portbench.lib import flops
from portbench.lib.compare import leaf_norms, training_numbers
from portbench.lib.models import port_model, reference_config
from portbench.lib.trace import Tracer
from portbench.lib.weights import drawn_state_dict
from portbench.reference.boxes import anchors_for
from portbench.reference.config import Train
from portbench.reference.model import Detector
from portbench.reference.train import ADAM_B1, run_steps


def make_batch(gen, batch: int, size: int, gt: int, max_gt: int, device):
    """uint8 noise images, ``gt`` boxes an image of 16-64 px, classes 0-89,
    the other ``max_gt - gt`` slots padding (label -1)."""
    u = torch.rand((4, batch, gt), generator=gen, device=device)
    x1, y1 = u[0] * (size - 64), u[1] * (size - 64)
    w, h = 16 + 48 * u[2], 16 + 48 * u[3]
    boxes = torch.zeros((batch, max_gt, 4), device=device)
    boxes[:, :gt] = torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)
    labels = torch.full((batch, max_gt), -1, dtype=torch.int32, device=device)
    labels[:, :gt] = torch.randint(0, 90, (batch, gt), generator=gen, device=device, dtype=torch.int32)
    images = torch.randint(0, 256, (batch, size, size, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    return {"images": images, "gt_boxes": boxes, "gt_labels": labels}


def reference_steps(bench, cfg, sd, ring, steps: int, quant=None, half_batch: bool = False):
    """The reference's ``steps`` steps from ``sd`` on the ring's first
    batches, with the port's stochastic-depth draws: (losses, the first
    gradient's leaf norms, the change's leaf norms)."""
    model = Detector(cfg, quant).to(bench.device)
    model.load_state_dict(sd)
    gen = torch.Generator(bench.device).manual_seed(bench.seed_for("depth"))
    anchors = torch.from_numpy(anchors_for(cfg, cfg.image_size)).to(bench.device)
    batches = [(b["images"], b["gt_boxes"], b["gt_labels"]) for b in ring[:steps]]
    out = run_steps(model, batches, anchors, Train(), gen, steps, half_batch)
    start = {k: sd[k] for k in out["params"]}
    return {"losses": out["losses"], "grad_norm": leaf_norms(out["grad"]),
            "change_norm": leaf_norms(out["params"], minus=start)}


def run(bench) -> None:
    p, dev = bench.params, bench.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reference_config(bench.config)
    bench.stamp("torch and the card")
    sd = drawn_state_dict(cfg, bench.seed_for("weights"), dev)
    bench.stamp("weights drawn and calibrated")
    from efficientdet_tpu_torch import TrainConfig, create_train_state, make_train_step

    model = port_model(bench.config, sd, torch.float32, dev, fuse=False)
    tc = TrainConfig()
    state = create_train_state(model, tc, device=dev)
    step = make_train_step(model, tc, device=dev)
    gen = torch.Generator(dev).manual_seed(bench.seed_for("depth"))
    data = torch.Generator(dev).manual_seed(bench.seed_for("batches"))
    ring = [make_batch(data, p["batch"], cfg.image_size, p["gt"], p["max_gt"], dev)
            for _ in range(p["ring"])]
    start = {k: v.detach().clone() for k, v in state.params.items()}
    losses, grad_norm = [], None
    for i in range(p["check_steps"]):
        state, metrics = step(state, ring[i], gen)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad_norm = leaf_norms(state.opt_state["mu"], scale=1.0 / (1.0 - ADAM_B1))
    port = {"losses": losses, "grad_norm": grad_norm,
            "change_norm": leaf_norms(state.params, minus=start)}
    del start
    bench.stamp("the checked steps")
    calls = p["check_steps"]
    for _ in range(p["warmup_steps"]):
        state, _ = step(state, ring[calls % len(ring)], gen)
        calls += 1
    bench.extra["flops_per_call"] = flops.training_flops(cfg, p["batch"])
    bench.extra["precision"] = "f32"
    tracer = Tracer(bench) if bench.trace_on else None
    first, last = p["trace_start_step"], p["trace_start_step"] + p["trace_steps"]
    bench.sync()
    bench.reset_peak()
    bench.mark_setup_done()
    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < bench.seconds or (tracer and steps < last):
        if tracer and steps == first:
            tracer.start()
        state, _ = step(state, ring[(calls + steps) % len(ring)], gen)
        steps += 1
        if tracer and steps == last:
            bench.trace = tracer.stop(p["trace_steps"])
    bench.sync()
    elapsed = time.perf_counter() - t0
    bench.memory_peak_bytes = bench.peak_bytes()
    bench.attempted = steps * p["batch"]
    bench.end_to_end = {"train_img_s": steps * p["batch"] / elapsed,
                        "peak_gb": bench.memory_peak_bytes / 1e9}
    bench.log(f"window: {steps} steps of {p['batch']} images in {elapsed:.4f} s; "
              f"set-up losses {losses}")

    del model, state, step, metrics
    bench.free()
    ref = reference_steps(bench, cfg, sd, ring, p["check_steps"])
    bench.numbers = training_numbers(port, ref)
    bench.extra["check"] = {"cfg": cfg, "sd": sd, "ring": ring, "ref": ref}
