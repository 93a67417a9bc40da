"""The frozen reference held against the port on the CPU at small sizes: the
detections of both configurations' code paths (D0 and D4, through the
port's anchor-major pipeline and the kernels' plain versions) and one
training step's loss and gradients. The test imports
both; the reference imports nothing of the port."""

from __future__ import annotations

import pytest
import torch

from portbench.lib import detect
from portbench.lib.compare import leaf_norms, training_numbers
from portbench.lib.models import port_model, reference_config
from portbench.lib.weights import drawn_state_dict
from portbench.reference.config import Eval
from portbench.traffic.train_step import make_batch, reference_steps


def _config(name, size):
    import json
    import os

    from conftest import ROOT

    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs", name + ".json")))
    cfg["image_size"] = size
    return cfg


@pytest.mark.parametrize("name,size", [("effdet-d0", 128), ("effdet-d4", 256)])
def test_detections_match_the_port_in_float32(name, size):
    torch.manual_seed(0)
    cfg = _config(name, size)
    rc = reference_config(cfg)
    sd = drawn_state_dict(rc, 11, "cpu")
    from efficientdet_tpu_torch import EvalConfig, make_predict_fn

    predict = make_predict_fn(port_model(cfg, sd, torch.float32, "cpu", fuse=True), EvalConfig(),
                              front_end="anchor_major")
    images = torch.randint(0, 256, (2, size, size, 3), dtype=torch.uint8)
    dets = predict(images)
    port = [detect.valid(dets, i) for i in range(2)]
    assert all(len(p[1]) == 100 for p in port)
    gaps, pairs = detect.gaps(detect.reference_model(rc, sd, "cpu"), images, port, Eval(), 2)
    n = gaps.numbers()
    assert not gaps.bad and pairs > 0
    assert n["box_rel"] < 1e-5 and n["logit_gap"] < 1e-4, n


def test_training_steps_match_the_port_in_float32():
    torch.manual_seed(0)
    cfg = _config("effdet-d0", 128)
    rc = reference_config(cfg)
    sd = drawn_state_dict(rc, 5, "cpu")
    from efficientdet_tpu_torch import TrainConfig, create_train_state, make_train_step

    model = port_model(cfg, sd, torch.float32, "cpu", fuse=False)
    state = create_train_state(model, TrainConfig(), device="cpu")
    step = make_train_step(model, TrainConfig(), device="cpu")
    data = torch.Generator().manual_seed(9)
    ring = [make_batch(data, 2, 128, 12, 100, "cpu") for _ in range(2)]

    class Seeds:  # the seed reference_steps draws stochastic depth from
        device = "cpu"

        def seed_for(self, tag):
            return 123

    gen = torch.Generator().manual_seed(123)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    losses = []
    for i in range(2):
        state, m = step(state, ring[i], gen)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = leaf_norms(state.opt_state["mu"], scale=10.0)
    port = {"losses": losses, "grad_norm": grad,
            "change_norm": leaf_norms(state.params, minus=start)}
    ref = reference_steps(Seeds(), rc, sd, ring, 2)
    n = training_numbers(port, ref)
    assert n["loss_rel_step1"] < 1e-5 and n["grad_leaf"] < 1e-4, n
    assert n["loss_rel"] < 1e-3 and n["change_leaf"] < 0.05, n
