"""Rank program of tests/test_torch_stages.py: one traced sharded training step.

Runs in a fresh process started by ``efficientdet_tpu_torch.parallel.launch.spawn``
as ``fn(mesh, **kwargs)``; imports the port only (no JAX).
"""

import dataclasses
import os

import numpy as np
import torch

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.parallel import make_sharded_train_step
from efficientdet_tpu_torch.tools.analyze_trace import _Host, analyze, load_events
from efficientdet_tpu_torch.utils import profiling

SIZE = 128
NUM_CLASSES = 6
# tests/conftest.py's slim_d0: B0, BiFPN and heads at width 16, depth 2
SLIM = dict(bifpn_width=16, bifpn_depth=2, head_depth=2, survival_prob=1.0)
# the two-rank step's smaller model (the parallel tests' tiny backbone)
TINY = dict(backbone="efficientnet-tiny", bifpn_depth=1, head_depth=1)


def slim_model(seed=0, **overrides):
    """The slim D0 (``overrides``: other ModelConfig fields) with
    numpy-drawn weights, in training mode, on the CPU."""
    from efficientdet_tpu_torch.experiments.drawn_weights import drawn_state_dict

    cfg = dataclasses.replace(et.ModelConfig.for_phi(0, num_classes=NUM_CLASSES, image_size=SIZE),
                              **{**SLIM, **overrides})
    model = et.EfficientDet(cfg)
    model.load_state_dict(drawn_state_dict(model, seed))
    return model.train()


def slim_batch(n, seed=0):
    """``n`` uint8 noise images with two boxes each."""
    rng = np.random.RandomState(seed)
    boxes = np.full((n, 4, 4), -1.0, np.float32)
    labels = np.full((n, 4), -1, np.int32)
    x1 = rng.uniform(0, SIZE - 48, (n, 2))
    y1 = rng.uniform(0, SIZE - 48, (n, 2))
    boxes[:, :2] = np.stack([x1, y1, x1 + 40, y1 + 40], -1)
    labels[:, :2] = rng.randint(0, NUM_CLASSES, (n, 2))
    images = rng.randint(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)
    return {"images": images, "gt_boxes": boxes, "gt_labels": labels}


def step_summary(path):
    """What the test compares of a traced step: the analyser's rows (their
    CPU ops), and each row's convolutions and collectives by op name."""
    result = analyze(path)
    host = _Host(load_events(path))
    marked = {}
    for e in host.ordered:
        if e["cat"] == "cpu_op" and (e["name"].startswith("c10d::") or e["name"] in (
                "aten::convolution", "aten::convolution_backward")):
            st, bwd = host.stage(e)
            row = marked.setdefault((st or "other") + (" backward" if bwd else ""), {})
            row[e["name"]] = row.get(e["name"], 0) + 1
    return {"rows": {k: v["launches"] for k, v in result["stages"].items()},
            "mode": result["mode"], "assigned": result["assigned"], "events": result["events"],
            "marked": marked}


def traced_step(mesh, batch, trace_dir, train_config):
    """One traced sharded step on this rank's rows of ``batch``; the
    analysed trace's summary."""
    model = slim_model(**TINY)
    tc = et.TrainConfig(**train_config)
    step = make_sharded_train_step(model, tc, mesh)
    lo, hi = mesh.rows(batch["images"].shape[0])
    local = {k: v[lo:hi] for k, v in batch.items()}
    state = et.create_train_state(model, tc, "cpu")
    gen = torch.Generator().manual_seed(0)
    name = f"rank{mesh.rank}.json"
    with profiling.trace(trace_dir, name=name) as prof:
        state, _ = step(state, local, gen)
        prof.step()
    return step_summary(os.path.join(trace_dir, name))
