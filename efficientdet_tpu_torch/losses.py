"""Detection losses: sigmoid focal classification and smooth-L1 regression.

Counterpart of the JAX package's ``losses.py``: focal loss (alpha 0.25,
gamma 2) on sigmoid logits and smooth-L1 (sigma 3) over the positive anchors,
both divided by the BATCH-GLOBAL positive count ``max(sum positives, 1)``.
The anchor state is its own tensor in {-1 ignore, 0 negative, 1 positive}.
A data-parallel or spatial step passes ``normalizer``: the whole batch's
count, all-reduced, where this process holds a part of the batch or of its
anchors.

The focal term over compact integer labels is :class:`_FocalSum`, a
``torch.autograd.Function`` whose backward is the hand-written derivative
:func:`_focal_grad_elementwise`: autograd of the one-hot formula would keep
several (B, A, C) float32 temporaries for the backward pass, this keeps only
the logits. The per-level and the concatenated loss share it, so their
gradients agree.

While spans are recorded (``utils/profiling.py``) the focal term opens a
``loss.focal`` span, forward and in ``_FocalSum.backward`` (the one-hot
form's backward is autograd's own and records none), and the Huber
term a ``loss.huber`` span, forward and over its backward (two gradient
hooks); they observe only, and change no operation, order or dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .utils.profiling import backward_span, span


def _math(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the losses' arithmetic dtype: float32, or float64 for float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(...,) integer labels -> (..., C) bool, all False for a label of -1."""
    classes = torch.arange(num_classes, device=labels.device, dtype=torch.int64)
    return labels.long().unsqueeze(-1) == classes


def _focal_elementwise(
    cls_logits: torch.Tensor,
    cls_targets: torch.Tensor,
    alpha: float,
    gamma: float,
) -> torch.Tensor:
    """Per-element focal loss (B, ..., C) in float32 (float64 for float64
    logits); targets may be compact labels (B, ...) or float one-hot
    (B, ..., C)."""
    x = _math(cls_logits)
    p = torch.sigmoid(x)
    if cls_targets.dim() == x.dim() - 1:
        t = _onehot(cls_targets, x.shape[-1]).to(x.dtype)
    else:
        t = cls_targets.to(x.dtype)
    pos = t == 1.0
    alpha_factor = torch.where(pos, alpha, 1.0 - alpha)
    focal_weight = torch.where(pos, 1.0 - p, p) ** gamma
    bce = x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return alpha_factor * focal_weight * bce


def _focal_grad_elementwise(x: torch.Tensor, onehot: torch.Tensor, alpha: float,
                            gamma: float) -> torch.Tensor:
    """d(focal)/d(logit), elementwise, float32.

    With p_t = sigmoid(s*x), s = +1 for the target class else -1, and
    L = -log(p_t) = softplus(-s*x):

        d focal / dx = -s * alpha_t * (1-p_t)^gamma * [(1-p_t) + gamma*p_t*L]

    (gamma = 0 gives the BCE gradient alpha_t * (p - t)).
    """
    p = torch.sigmoid(x)
    sp_neg = F.softplus(-x)  # -log(p)
    sp_pos = F.softplus(x)  # -log(1-p)
    one_m = 1.0 - p
    grad_pos = -alpha * one_m ** gamma * (one_m + gamma * p * sp_neg)
    grad_neg = (1.0 - alpha) * p ** gamma * (p + gamma * one_m * sp_pos)
    return torch.where(onehot, grad_pos, grad_neg)


class _FocalSum(torch.autograd.Function):
    """sum over (..., C) of focal(cl, onehot(labels)) * include -> (B,).

    cl: (B, ..., C) logits in any float dtype (math in float32, or float64); labels:
    (B, ...) integers (-1 = none); include: (B, ...) float32 in {0, 1}
    (anchor_state != -1). Rank-generic: (B, A, C) concatenated logits and
    (B, H, W, A, C) views of a level's conv output alike. The backward
    returns the gradient in the logits' dtype and nothing for the rest.
    """

    @staticmethod
    def forward(ctx, cl, labels, include, alpha, gamma):
        focal = _focal_elementwise(cl, labels, alpha, gamma)
        ctx.save_for_backward(cl, labels, include)
        ctx.alpha, ctx.gamma = alpha, gamma
        return (focal.sum(dim=-1) * include).sum(dim=tuple(range(1, include.dim())))

    @staticmethod
    def backward(ctx, g):
        cl, labels, include = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        with span("loss.focal"):
            d = _focal_grad_elementwise(_math(cl), _onehot(labels, cl.shape[-1]),
                                        ctx.alpha, ctx.gamma)
            gx = g.reshape(g.shape + (1,) * (include.dim() - 1))
            d = d * (include * gx).unsqueeze(-1)
            return d.to(cl.dtype), None, None, None, None


def _focal_sum(cl, labels, include, alpha, gamma):
    return _FocalSum.apply(cl, labels, include, alpha, gamma)


def _normalizer(anchor_state: torch.Tensor) -> torch.Tensor:
    """max(number of positive anchors in the batch, 1), float32."""
    return (anchor_state == 1.0).float().sum().clamp_min(1.0)


def focal_loss(
    cls_logits: torch.Tensor,
    cls_targets: torch.Tensor,
    anchor_state: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
    normalizer: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sigmoid focal loss over the non-ignored anchors, divided by the batch's
    positive count (``normalizer`` when given).

    cls_logits (B, A, C); cls_targets (B, A, C) float one-hot, or (B, A)
    integer labels (-1 = no class), the compact form of
    ``anchors.anchor_targets_compact``; anchor_state (B, A). Scalar.
    """
    with span("loss.focal"):
        if normalizer is None:
            normalizer = _normalizer(anchor_state)
        include = (anchor_state != -1.0).float()
        if cls_targets.dim() == cls_logits.dim() - 1:
            return _focal_sum(cls_logits, cls_targets, include, alpha, gamma).sum() / normalizer
        loss = _focal_elementwise(cls_logits, cls_targets, alpha, gamma)
        return (loss * include.unsqueeze(-1)).sum() / normalizer


def _huber_elementwise(box_preds: torch.Tensor, box_targets: torch.Tensor,
                       sigma: float) -> torch.Tensor:
    sigma_sq = sigma ** 2
    diff = (_math(box_preds) - box_targets.float()).abs()
    return torch.where(diff < 1.0 / sigma_sq, 0.5 * sigma_sq * diff ** 2, diff - 0.5 / sigma_sq)


def smooth_l1_loss(
    box_preds: torch.Tensor,
    box_targets: torch.Tensor,
    anchor_state: torch.Tensor,
    sigma: float = 3.0,
    normalizer: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Smooth-L1 over the positive anchors, divided by the batch's positive
    count (``normalizer`` when given). box_preds, box_targets (B, A, 4);
    anchor_state (B, A). Scalar."""
    with span("loss.huber"):
        loss = _huber_elementwise(box_preds, box_targets, sigma)
        positive = (anchor_state == 1.0).float()
        if normalizer is None:
            normalizer = _normalizer(anchor_state)
        out = (loss * positive.unsqueeze(-1)).sum() / normalizer
        backward_span("loss.huber", out, box_preds)
        return out


def detection_loss_from_levels(
    cls_levels: Sequence[torch.Tensor],
    box_levels: Sequence[torch.Tensor],
    cls_targets: torch.Tensor,
    box_targets: torch.Tensor,
    anchor_state: torch.Tensor,
    num_anchors: int,
    alpha: float = 0.25,
    gamma: float = 2.0,
    sigma: float = 3.0,
    normalizer: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`detection_loss` on the heads' per-level outputs.

    cls_levels: per level (B, H, W, A*C) logits, level-major in the order of
    ``anchors_for_shape`` (the heads' ``raw_levels`` output: a permuted view
    of the NCHW conv output, which the loss reads in place); box_levels: per
    level (B, H, W, A*4); cls_targets (B, A_total) integer labels;
    box_targets (B, A_total, 4); anchor_state (B, A_total). The same sums as
    concatenating the levels, without the concatenated tensors.
    """
    bsz = anchor_state.shape[0]
    if normalizer is None:
        normalizer = _normalizer(anchor_state)
    cls_total = torch.zeros((bsz,), dtype=torch.float32, device=anchor_state.device)
    box_total = torch.zeros_like(cls_total)
    off = 0
    for cl, bl in zip(cls_levels, box_levels):
        b, h, w, ac = cl.shape
        a = num_anchors
        c = ac // a
        n = h * w * a
        labels = cls_targets[:, off:off + n].reshape(b, h, w, a)
        state = anchor_state[:, off:off + n].reshape(b, h, w, a)
        include = (state != -1.0).float()
        positive = (state == 1.0).float()
        with span("loss.focal"):
            cls_total = cls_total + _focal_sum(cl.reshape(b, h, w, a, c), labels, include,
                                               alpha, gamma)
        bt = box_targets[:, off:off + n].reshape(b, h, w, a, 4)
        with span("loss.huber"):
            huber = _huber_elementwise(bl.reshape(b, h, w, a, 4), bt, sigma)
            level = (huber.sum(dim=4) * positive).sum(dim=(1, 2, 3))
            backward_span("loss.huber", level, bl)
        box_total = box_total + level
        off += n
    cls_loss = cls_total.sum() / normalizer
    box_loss = box_total.sum() / normalizer
    return cls_loss + box_loss, {"cls_loss": cls_loss, "box_loss": box_loss}


def detection_loss(
    cls_logits: torch.Tensor,
    box_preds: torch.Tensor,
    cls_targets: torch.Tensor,
    box_targets: torch.Tensor,
    anchor_state: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
    sigma: float = 3.0,
    normalizer: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Focal + smooth-L1 with unit weights on the concatenated (B, A, .)
    tensors: (total, {"cls_loss", "box_loss"})."""
    cls_loss = focal_loss(cls_logits, cls_targets, anchor_state, alpha, gamma, normalizer)
    box_loss = smooth_l1_loss(box_preds, box_targets, anchor_state, sigma, normalizer)
    return cls_loss + box_loss, {"cls_loss": cls_loss, "box_loss": box_loss}
