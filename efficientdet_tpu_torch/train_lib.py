"""The training step: anchor targets, forward, losses, backward, Adam.

Counterpart of the JAX package's ``train_lib.py``, with the same entry points
and semantics::

    model, cfg = build_efficientdet(0, num_classes=90)   # on the GPU
    config = TrainConfig(batch_size=64)
    state = create_train_state(model, config)
    step = make_train_step(model, config)
    gen = torch.Generator(device="cuda").manual_seed(0)  # stochastic depth
    for batch in batches:  # images (B, S, S, 3) uint8, gt_boxes (B, G, 4),
        state, metrics = step(state, batch, gen)  # gt_labels (B, G), -1 = pad

PyTorch's idiom in place of flax's: the model holds its weights, and a
:class:`TrainState` holds the model's own parameter and buffer tensors, which
the step updates in place (the state passed in is the state returned, its
``step`` advanced), as a torch optimizer does. ``model.train()`` replaces
``train=True`` and an explicit ``torch.Generator`` the ``dropout`` rng.

The optimizer is optax's chain written out: clip by global norm (``g * c /
|g|`` only when ``|g| >= c``), decayed weights (L2 added to the gradient, not
AdamW), Adam (b1 0.9, b2 0.999, eps 1e-8) at the schedule's rate for the
count before its increment, and ``grad_accum_steps`` as optax's
``MultiSteps`` (a running mean of the gradients, zero updates on the
mini-steps). Counts and the schedule are host numbers computed in float32 as
JAX computes them; nothing in a step waits for the device, and its metrics
are device tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .anchors import anchor_targets_batch_compact
from .configs import TrainConfig
from .losses import detection_loss, detection_loss_from_levels
from .models.detector import EfficientDet, resolve_device
from .ops.augment import augment_batch_device
from .ops.preprocess import preprocess_batch_fixed
from .parallel.context import parallel_context
from .utils.profiling import span, stage

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """step; ``params`` and ``batch_stats``: the model's own parameters and
    BN buffers by state-dict name; ``opt_state``: :class:`Optimizer`'s;
    ``ema_params``: copies moved by ``ema_decay`` (None when it is 0);
    ``lr_scale``: a multiplier of every update (a plateau's learning-rate
    drop; for Adam the same as scaling its rate)."""

    step: int
    params: Tensors
    batch_stats: Tensors
    opt_state: Dict[str, Any]
    ema_params: Optional[Tensors] = None
    lr_scale: float = 1.0

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def make_learning_rate_fn(config: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate: constant, constant after a linear warm-up, or
    warm-up then cosine decay to 0 at ``epochs * steps_per_epoch`` (optax's
    schedules, in float32)."""
    base = np.float32(config.learning_rate)
    if config.lr_schedule == "constant":
        if config.warmup_steps > 0:
            return lambda count: float(_linear(count, base, config.warmup_steps))
        return lambda count: float(base)
    if config.lr_schedule == "cosine":
        warmup = max(config.warmup_steps, 1)
        decay = max(config.epochs * config.steps_per_epoch, 2) - warmup

        def cosine(count):
            if count < warmup:
                return float(_linear(count, base, warmup))
            t = np.float32(min(count - warmup, decay))
            c = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * t / np.float32(decay)))
            return float(base * c)

        return cosine
    raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")


def _linear(count: int, end: np.float32, steps: int) -> np.float32:
    """optax.linear_schedule(0, end, steps) at ``count``, float32."""
    frac = np.float32(1.0) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
    return np.float32(-end) * frac + end


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """optax's chain for :class:`TrainConfig`, on dicts of tensors by name.

    ``init(params)`` -> state; ``update(grads, state, params)`` -> (updates,
    state), as an optax ``GradientTransformation``; the state's moments and
    accumulators are updated in place. The decay and Adam run as torch's
    multi-tensor (foreach) operations over the whole list, whatever
    ``fused_optimizer`` says: the field is kept so that the configuration
    equals the JAX package's, where it picks optax's layout, not the math.
    """

    def __init__(self, config: TrainConfig):
        self.lr = make_learning_rate_fn(config)
        self.clip = config.grad_clip_norm
        self.weight_decay = config.weight_decay
        self.k = config.grad_accum_steps

    def init(self, params: Tensors) -> Dict[str, Any]:
        state = {"count": 0,
                 "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                 "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
        if self.k > 1:
            state["mini_step"] = 0
            state["acc_grads"] = {k: torch.zeros_like(v) for k, v in params.items()}
        return state

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict[str, Any], params: Tensors,
               grad_norm: Optional[torch.Tensor] = None) -> Tuple[Tensors, Dict[str, Any]]:
        """``grad_norm``: the gradients' global norm if the caller has it.
        Runs without autograd: the parameters take part in the decay."""
        names = list(grads)
        g = [grads[k] for k in names]
        if self.k > 1:
            n = state["mini_step"]
            acc = [state["acc_grads"][k] for k in names]
            for a, gi in zip(acc, g):
                a.add_((gi - a) / (n + 1))
            if n < self.k - 1:
                state["mini_step"] = n + 1
                return {k: torch.zeros_like(v) for k, v in grads.items()}, state
            g, grad_norm = [a.clone() for a in acc], None
            for a in acc:
                a.zero_()
            state["mini_step"] = 0
        p = [params[k] for k in names]
        updates = self._inner(g, state, names, p, grad_norm)
        return dict(zip(names, updates)), state

    def _inner(self, g, state, names, p, grad_norm):
        if self.clip > 0:
            norm = global_norm(g) if grad_norm is None else grad_norm
            keep = norm < self.clip
            g = [torch.where(keep, x, x / norm * self.clip) for x in g]
        if self.weight_decay > 0:
            wd = self.weight_decay
            g = torch._foreach_add(g, torch._foreach_mul(p, wd))
        count = state["count"]
        lr = self.lr(count)
        bc1 = _bias_correction(ADAM_B1, count + 1)
        bc2 = _bias_correction(ADAM_B2, count + 1)
        state["count"] = count + 1
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - ADAM_B1))
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - ADAM_B2))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), ADAM_EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        return torch._foreach_mul(upd, -lr)


def make_optimizer(config: TrainConfig) -> Optimizer:
    """Adam at the schedule's rate, with the optional clip, decay and
    gradient accumulation of ``config``."""
    return Optimizer(config)


def _model_device(model: EfficientDet, device) -> torch.device:
    """Resolve ``device`` (None = the GPU, raising without one) and check
    that the model lives there."""
    device = resolve_device(device)
    own = next(model.parameters()).device
    if own.type != device.type:
        raise ValueError(f"the model is on {own}, not on {device}: build it with device={device.type!r}")
    return own


def create_train_state(model: EfficientDet, config: TrainConfig, device=None) -> TrainState:
    """A TrainState over ``model``'s own weights (the model holds its initial
    weights, so no rng and no image size are taken)."""
    _model_device(model, device)
    params = dict(model.named_parameters())
    ema = ({k: v.detach().clone() for k, v in params.items()}
           if config.ema_decay > 0 else None)
    return TrainState(step=0, params=params, batch_stats=dict(model.named_buffers()),
                      opt_state=make_optimizer(config).init(params), ema_params=ema,
                      lr_scale=1.0)


def _check_state(model: EfficientDet, state: TrainState, own: Tensors) -> None:
    if state.params.keys() != own.keys() or any(state.params[k] is not v for k, v in own.items()):
        raise ValueError("the state's params are not this model's parameters "
                         "(make it with create_train_state(model, ...))")


def _batch(batch: Dict[str, Any], device: torch.device):
    images = torch.as_tensor(batch["images"], device=device)
    boxes = torch.as_tensor(batch["gt_boxes"], device=device)
    labels = torch.as_tensor(batch["gt_labels"], device=device)
    return images, boxes, labels


def _loss(model: EfficientDet, config: TrainConfig, images, boxes, labels, generator,
          normalize: Optional[Callable] = None):
    """(total, aux, anchor_state) of a batch of normalised float32 images.
    ``normalize(anchor_state)``: the losses' divisor (the batch's positive
    count when None)."""
    cfg = model.config
    anchors = model.anchors(images.shape[1], images.device)
    with stage("loss"):
        cls_t, box_t, state_t = anchor_targets_batch_compact(
            anchors, boxes, labels, config.positive_iou, config.negative_iou)
    kw = dict(alpha=config.focal_alpha, gamma=config.focal_gamma, sigma=config.huber_sigma,
              normalizer=None if normalize is None else normalize(state_t))
    if config.per_level_loss:
        cls_levels, box_levels = model(images, raw_levels=True, generator=generator)
        with stage("loss"):
            total, aux = detection_loss_from_levels(
                cls_levels, box_levels, cls_t, box_t, state_t,
                num_anchors=cfg.num_anchors_per_cell, **kw)
    else:
        cls_logits, box_preds = model(images, generator=generator)
        with stage("loss"):
            total, aux = detection_loss(cls_logits, box_preds, cls_t, box_t, state_t, **kw)
    return total, aux, state_t


def make_eval_loss_fn(model: EfficientDet, config: TrainConfig, device=None):
    """``eval_loss(state, batch) -> {"val_loss", "val_cls_loss",
    "val_box_loss"}``: the same losses from the eval-mode forward (running
    BN statistics, no stochastic depth), no update. The model goes back to
    the mode it was in. The anchors follow the batch's image size."""
    dev = _model_device(model, device)
    own = dict(model.named_parameters())

    def eval_loss(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        _check_state(model, state, own)
        images, boxes, labels = _batch(batch, dev)
        if images.dtype == torch.uint8:
            images = preprocess_batch_fixed(images, dtype=torch.float32)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                total, aux, _ = _loss(model, config, images, boxes, labels, None)
        finally:
            model.train(was_training)
        return {"val_loss": total, **{f"val_{k}": v for k, v in aux.items()}}

    return eval_loss


def make_train_step(model: EfficientDet, config: TrainConfig, device=None, parallel=None):
    """``train_step(state, batch, generator=None) -> (state, metrics)``.

    batch: ``images`` (B, S, S, 3), uint8 (normalised inside the step) or
    normalised float32, ``gt_boxes`` (B, G, 4), ``gt_labels`` (B, G), -1 for
    padding; numpy or tensors. With ``config.device_augment`` the step first
    augments the batch on the device (ops/augment.py; ``extents`` (B, 2), the
    visible (scaled_h, scaled_w) of each canvas, clips the boxes when the
    batch has them), then normalises the augmenter's float32 [0, 255] images
    as it does uint8 ones. ``generator``: the augmentation's draws first
    (matrices, then colour factors), then stochastic depth's (the device's
    default generator when None). metrics: ``loss``, ``cls_loss``,
    ``box_loss``, ``grad_norm`` (after the backbone's gradients are zeroed by
    ``freeze_backbone``, before the clip) and ``num_positives`` (mean per
    image), as device tensors. EMA moves on every call. The anchors follow
    the batch's image size.

    ``parallel``: what a data-parallel or spatial step changes
    (parallel/sharding.py makes it): the context the forward and backward
    run in, the loss (the global normaliser, a band's anchors), the SUM of
    the gradients over the ranks (between ``torch.autograd.grad`` and
    ``global_norm``) and of the loss metrics. None: this process's step.
    """
    dev = _model_device(model, device)
    own = dict(model.named_parameters())
    names = list(own)
    frozen = {k for k in names if k.startswith("backbone.")} if config.freeze_backbone else set()
    tx = make_optimizer(config)
    ema_decay = config.ema_decay

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
        with span("step"):
            return _step(state, batch, generator)

    def _step(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator]):
        _check_state(model, state, own)
        if not model.training:
            model.train()
        images, boxes, labels = _batch(batch, dev)
        params = [state.params[k] for k in names]
        ctx = None if parallel is None else parallel.context_for(images)
        with parallel_context(ctx):
            with stage("preprocess"):
                if config.device_augment:
                    extents = batch.get("extents")
                    images, boxes, labels = augment_batch_device(
                        generator, images, boxes, labels,
                        extents=None if extents is None else torch.as_tensor(extents, device=dev),
                        color=config.device_augment_color,
                        draw_rows=None if ctx is None else ctx.draw_rows(images.shape[0]))
                # the augmenter returns float32 in [0, 255]: normalised here too
                if images.dtype != torch.float32 or config.device_augment:
                    images = preprocess_batch_fixed(images, dtype=torch.float32)
            if parallel is None:
                total, aux, anchor_state = _loss(model, config, images, boxes, labels, generator)
                aux["num_positives"] = (anchor_state == 1.0).sum(dim=1).float().mean()
            else:
                total, aux = parallel.loss(model, config, images, boxes, labels, generator)
            with span("backward"):
                grad_list = torch.autograd.grad(total, params)
        if parallel is not None:
            grad_list = parallel.reduce_grads(grad_list)
            total, aux = parallel.reduce_metrics(total, aux)
        grads = dict(zip(names, grad_list))
        for k in frozen:
            grads[k] = torch.zeros_like(grads[k])
        with stage("optimizer"), torch.no_grad():
            grad_norm = global_norm(list(grads.values()))
            updates, opt_state = tx.update(grads, state.opt_state, state.params, grad_norm)
            upd = [updates[k] for k in names]
            if state.lr_scale != 1.0:
                upd = torch._foreach_mul(upd, state.lr_scale)
            torch._foreach_add_(params, upd)
            if state.ema_params is not None:
                ema = [state.ema_params[k] for k in names]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - ema_decay))
        metrics = {"loss": total.detach(), "grad_norm": grad_norm,
                   **{k: v.detach() for k, v in aux.items()}}
        return state.replace(step=state.step + 1, opt_state=opt_state), metrics

    return train_step
