"""The check that decides ``correct``, shown to fail: a run on the CPU at a
tiny size with the timed path broken underneath reads ``correct`` false,
once for each fault the cell can have, and the control (the reference one
precision below the cell's, in the port's place) fails the cell's limits.

Faults: an answer altered where it is produced (inference: the detections'
logits raised by one; training: the loss scaled by 1.01), half of the batch
left out (inference: the second half's detections dropped; training: the
loss taken over the first half alone), for inference a wrong selection (the
finest level left out of the candidates, the suppression walked from the
lowest score up: ``faults.py``) and, for training, a step that returns its
state unchanged. The cells run on one chip, so there is no
exchange between chips to leave out.
"""

from __future__ import annotations

import pytest
import torch

from portbench import faults, readings, run


def _raise_logits(dets):
    boxes, scores, classes, n = dets
    raised = torch.where(scores > 0, torch.sigmoid(torch.logit(scores.double()) + 1.0).to(scores.dtype),
                         scores)
    return boxes, raised, classes, n


def _drop_second_half(dets):
    boxes, scores, classes, n = dets
    half = n.shape[0] // 2
    n = n.clone()
    n[half:] = 0
    return boxes, scores, classes, n


def _wrap(module, name, fault, monkeypatch):
    original = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: fault(original(*a, **k)))


@pytest.mark.parametrize("fault", [_raise_logits, _drop_second_half])
@pytest.mark.parametrize("name", ["d0-b128", "d4-b64"])
def test_a_broken_pipeline_is_not_correct(tiny, monkeypatch, name, fault):
    import efficientdet_tpu_torch.models.detector as det

    _wrap(det, "batched_filter_from_anchor_major_levels", fault, monkeypatch)
    cell, args = tiny(name, check_images=10 ** 6)  # every image the window served
    res = run.measure(cell, args, device="cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", ["d0-b128", "d4-b64"])
def test_a_wrong_selection_is_not_correct(tiny, name, fault):
    """Each detection of a wrong selection matches the reference at its own
    anchor; ``missed`` alone reads the fault."""
    cell, args = tiny(name)
    undo = faults.plant(fault)
    try:
        res = run.measure(cell, args, device="cpu")
    finally:
        undo()
    checks = res["checks"]
    assert res["correct"] is False and checks["missed"]["value"] > checks["missed"]["limit"], checks


def _unchanged(monkeypatch):
    from efficientdet_tpu_torch import train_lib

    def update(self, grads, state, params, grad_norm=None):
        return {k: torch.zeros_like(v) for k, v in grads.items()}, state

    monkeypatch.setattr(train_lib.Optimizer, "update", update)


def _half_batch(monkeypatch):
    from efficientdet_tpu_torch import train_lib

    loss = train_lib._loss

    def half(model, config, images, boxes, labels, generator, normalize=None):
        h = images.shape[0] // 2
        return loss(model, config, images[:h], boxes[:h], labels[:h], generator, normalize)

    monkeypatch.setattr(train_lib, "_loss", half)


def _altered_loss(monkeypatch):
    from efficientdet_tpu_torch import train_lib

    loss = train_lib.detection_loss_from_levels

    def scaled(*a, **k):
        total, aux = loss(*a, **k)
        return total * 1.01, aux

    monkeypatch.setattr(train_lib, "detection_loss_from_levels", scaled)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_loss])
def test_a_broken_training_step_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    cell, args = tiny("d0-train", batch=4)
    res = run.measure(cell, args, device="cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", ["d0-b128", "d4-b64", "d0-train"])
def test_the_control_fails_the_limits(tiny, name):
    cell, args = tiny(name, **({"batch": 4} if name == "d0-train" else {}))
    from portbench.lib.bench import Bench

    bench = Bench(cell, args.seed, args.seconds, False, 0.0, "cpu")
    cell.traffic().run(bench)
    prec = "f32" if name == "d0-train" else "bf16"  # the cell's precision, not the tiny run's
    numbers = readings.control_numbers(bench, prec)["control"]
    limits = cell.workload["limits"]
    assert any(numbers[k] > v for k, v in limits.items()), (numbers, limits)
