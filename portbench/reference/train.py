"""The training step in plain PyTorch (a copy of the port's ``train_lib.py``
and ``losses.py`` with autograd in place of the hand-written focal
backward): anchor targets, the model in training mode, focal loss and
smooth-L1 per level over the batch's positive count, gradients, Adam
(b1 0.9, b2 0.999, eps 1e-8, bias-corrected, no decay and no clip)."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .boxes import targets
from .model import normalize

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def focal(x: torch.Tensor, t: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    p = torch.sigmoid(x)
    pos = t == 1.0
    weight = torch.where(pos, alpha, 1.0 - alpha) * torch.where(pos, 1.0 - p, p) ** gamma
    return weight * (x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs())))


def huber(d: torch.Tensor, sigma: float) -> torch.Tensor:
    s2 = sigma ** 2
    d = d.abs()
    return torch.where(d < 1.0 / s2, 0.5 * s2 * d ** 2, d - 0.5 / s2)


def loss(model, images, gt_boxes, gt_labels, anchors, tc, generator=None, rows=None):
    """(total, cls, box) of one batch of uint8 images. ``rows``: the images
    the loss is averaged over (all by default)."""
    labels, box_t, state = targets(anchors, gt_boxes, gt_labels, tc.positive_iou, tc.negative_iou)
    cls_levels, box_levels = model(normalize(images), levels=True, generator=generator)
    if rows is not None:
        labels, box_t, state = labels[rows], box_t[rows], state[rows]
        cls_levels = [x[rows] for x in cls_levels]
        box_levels = [x[rows] for x in box_levels]
    a = model.config.num_anchors
    norm = (state == 1.0).float().sum().clamp_min(1.0)
    cls_sum = box_sum = 0.0
    off = 0
    for cl, bl in zip(cls_levels, box_levels):
        b, h, w, ac = cl.shape
        n = h * w * a
        c = ac // a
        lab = labels[:, off:off + n].reshape(b, h, w, a)
        st = state[:, off:off + n].reshape(b, h, w, a)
        onehot = F.one_hot(lab.clamp_min(0), c).float() * (lab >= 0)[..., None].float()
        fl = focal(cl.reshape(b, h, w, a, c), onehot, tc.focal_alpha, tc.focal_gamma)
        cls_sum = cls_sum + (fl.sum(-1) * (st != -1.0).float()).sum()
        bt = box_t[:, off:off + n].reshape(b, h, w, a, 4)
        hb = huber(bl.reshape(b, h, w, a, 4) - bt, tc.huber_sigma)
        box_sum = box_sum + (hb.sum(-1) * (st == 1.0).float()).sum()
        off += n
    return (cls_sum + box_sum) / norm, cls_sum / norm, box_sum / norm


class Adam:
    """optax's Adam at a constant rate, on a list of parameters."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr, self.count = params, lr, 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.count += 1
        bc1 = 1.0 - ADAM_B1 ** self.count
        bc2 = 1.0 - ADAM_B2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(ADAM_B1).add_(g * (1.0 - ADAM_B1))
            v.mul_(ADAM_B2).add_(g * g * (1.0 - ADAM_B2))
            p.add_(-self.lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))


def run_steps(model, batches, anchors, tc, generator, steps: int, half_batch: bool = False
              ) -> Dict[str, object]:
    """``steps`` training steps of ``model`` (in training mode) on
    ``batches[i]``: the losses, the first step's gradient by parameter name
    and the parameters after the last step. ``half_batch``: each loss over
    the first half of the batch alone (a fault the comparison must catch)."""
    model.train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = Adam(params, tc.learning_rate)
    losses, first = [], None
    for i in range(steps):
        images, boxes, labels = batches[i]
        rows = slice(0, images.shape[0] // 2) if half_batch else None
        total, _, _ = loss(model, images, boxes, labels, anchors, tc, generator, rows)
        grads = torch.autograd.grad(total, params)
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        losses.append(float(total.detach()))
        opt.step(grads)
    return {"losses": losses, "grad": first,
            "params": {n: p.detach().clone() for n, p in zip(names, params)}}
