"""The port's detection losses against the JAX package's, on the CPU.

Focal loss (compact labels and dense one-hot), smooth-L1,
``detection_loss`` and ``detection_loss_from_levels`` agree within 1e-6
relative. The focal term's hand-written backward (``_FocalSum``, a
``torch.autograd.Function``) agrees with ``jax.grad`` of the JAX loss, and
with torch autograd of the elementwise focal formula, within 1e-6 of the
largest gradient, at logits up to +-30. Also: positives spread unevenly over
the batch, a batch without positives, and equal gradients on the per-level
and the concatenated paths. Inputs are drawn with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import efficientdet_tpu.losses as jl
import efficientdet_tpu_torch.losses as tl

REL = 1e-6
GRAD_TOL = 1e-6
A = 3  # anchors per cell
C = 5  # classes
LEVELS = [(4, 4), (2, 2), (1, 1)]
N = sum(h * w for h, w in LEVELS) * A


def _data(seed, batch=2, positives=(5, 1), scale=4.0):
    """Per-level NHWC logits/deltas and compact targets; ``positives[i]``
    positive anchors in image i, some ignored, the rest negative; logits
    include +-30."""
    rng = np.random.RandomState(seed)
    cls_levels = [np.clip(rng.normal(0, scale, (batch, h, w, A * C)), -30, 30).astype(np.float32)
                  for h, w in LEVELS]
    cls_levels[0][0, 0, 0, :4] = [30.0, -30.0, 25.0, -25.0]
    box_levels = [rng.normal(0, 0.5, (batch, h, w, A * 4)).astype(np.float32) for h, w in LEVELS]
    state = np.zeros((batch, N), np.float32)
    labels = np.full((batch, N), -1, np.int32)
    for i, npos in enumerate(positives):
        idx = rng.permutation(N)
        state[i, idx[:npos]] = 1.0
        labels[i, idx[:npos]] = rng.randint(0, C, npos)
        state[i, idx[npos:npos + 4]] = -1.0
    box_t = rng.normal(0, 0.5, (batch, N, 4)).astype(np.float32)
    box_t[state != 1.0] = 0.0
    return cls_levels, box_levels, labels, box_t, state


def _concat(levels, out):
    return np.concatenate([x.reshape(x.shape[0], -1, out) for x in levels], axis=1)


def _onehot(labels):
    return np.eye(C + 1, dtype=np.float32)[np.where(labels < 0, C, labels)][..., :C]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _f(x):
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def _rel(got, want):
    got, want = _f(got), _f(want)
    assert abs(got - want) <= REL * max(abs(want), 1e-12), (got, want)


@pytest.mark.parametrize("positives", [(5, 1), (12, 0), (0, 0)], ids=["uneven", "one-empty", "none"])
def test_focal_and_smooth_l1_match_jax(positives):
    cls_levels, box_levels, labels, box_t, state = _data(0, positives=positives)
    logits = _concat(cls_levels, C)
    boxes = _concat(box_levels, 4)
    _rel(tl.focal_loss(_t(logits), _t(labels), _t(state)),
         jl.focal_loss(logits, labels, state))
    _rel(tl.focal_loss(_t(logits), _t(_onehot(labels)), _t(state)),
         jl.focal_loss(logits, _onehot(labels), state))
    _rel(tl.smooth_l1_loss(_t(boxes), _t(box_t), _t(state)),
         jl.smooth_l1_loss(boxes, box_t, state))
    # the normaliser is the batch's positive count, at least 1
    assert float(tl._normalizer(_t(state))) == max(sum(positives), 1)


@pytest.mark.parametrize("positives", [(5, 1), (0, 0)], ids=["uneven", "none"])
def test_detection_losses_match_jax(positives):
    cls_levels, box_levels, labels, box_t, state = _data(1, positives=positives)
    logits = _concat(cls_levels, C)
    boxes = _concat(box_levels, 4)
    want, want_aux = jl.detection_loss(logits, boxes, labels, box_t, state)
    got, got_aux = tl.detection_loss(_t(logits), _t(boxes), _t(labels), _t(box_t), _t(state))
    _rel(got, want)
    for k in ("cls_loss", "box_loss"):
        _rel(got_aux[k], want_aux[k])
    want, want_aux = jl.detection_loss_from_levels(cls_levels, box_levels, labels, box_t, state,
                                                   num_anchors=A)
    got, got_aux = tl.detection_loss_from_levels([_t(x) for x in cls_levels],
                                                 [_t(x) for x in box_levels],
                                                 _t(labels), _t(box_t), _t(state), num_anchors=A)
    _rel(got, want)
    for k in ("cls_loss", "box_loss"):
        _rel(got_aux[k], want_aux[k])


def test_focal_gradient_matches_jax_and_autograd():
    cls_levels, _, labels, _, state = _data(2, positives=(7, 3), scale=10.0)
    logits = _concat(cls_levels, C)
    assert np.abs(logits).max() == 30.0
    want = np.asarray(jax.grad(lambda x: jl.focal_loss(x, labels, state))(jnp.asarray(logits)))
    x = _t(logits).requires_grad_()
    tl.focal_loss(x, _t(labels), _t(state)).backward()
    scale = np.abs(want).max()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0, atol=GRAD_TOL * scale)
    # the hand-written backward against torch autograd of the dense formula
    y = _t(logits).requires_grad_()
    dense = tl._focal_elementwise(y, _t(_onehot(labels)), 0.25, 2.0)
    ((dense * (_t(state) != -1).float().unsqueeze(-1)).sum() / tl._normalizer(_t(state))).backward()
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=0, atol=GRAD_TOL * scale)
    # ignored anchors get no gradient
    assert (x.grad.numpy()[state == -1] == 0).all()


def test_focal_backward_keeps_the_logits_dtype():
    cls_levels, _, labels, _, state = _data(3)
    x = _t(_concat(cls_levels, C)).to(torch.bfloat16).requires_grad_()
    loss = tl.focal_loss(x, _t(labels), _t(state))
    assert loss.dtype == torch.float32
    loss.backward()
    assert x.grad.dtype == torch.bfloat16
    ref = _t(_concat(cls_levels, C)).to(torch.bfloat16).float().requires_grad_()
    tl.focal_loss(ref, _t(labels), _t(state)).backward()
    # the float32 gradient of the bf16 logits, rounded once to bf16
    assert torch.equal(x.grad, ref.grad.to(torch.bfloat16))


def _conv_layout(levels):
    """NHWC levels as the heads return them: permuted views of NCHW tensors."""
    return [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_()
            for x in levels]


def test_per_level_and_concat_gradients_agree():
    """The JAX test's twin: the per-level loss on the heads' conv-layout
    views and the concatenated loss give the same loss and gradients."""
    cls_levels, box_levels, labels, box_t, state = _data(4, positives=(6, 2))
    cls_nchw, box_nchw = _conv_layout(cls_levels), _conv_layout(box_levels)
    total, _ = tl.detection_loss_from_levels(
        [x.permute(0, 2, 3, 1) for x in cls_nchw], [x.permute(0, 2, 3, 1) for x in box_nchw],
        _t(labels), _t(box_t), _t(state), num_anchors=A)
    total.backward()
    cls_cat, box_cat = _conv_layout(cls_levels), _conv_layout(box_levels)
    logits = torch.cat([x.permute(0, 2, 3, 1).reshape(2, -1, C) for x in cls_cat], 1)
    boxes = torch.cat([x.permute(0, 2, 3, 1).reshape(2, -1, 4) for x in box_cat], 1)
    total_cat, _ = tl.detection_loss(logits, boxes, _t(labels), _t(box_t), _t(state))
    total_cat.backward()
    _rel(total, total_cat)
    for a, b in zip(cls_nchw + box_nchw, cls_cat + box_cat):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-9)
