"""The tolerances a parallel training step is held to against the one-process step.

The CPU tests (tests/torch_parallel_ref.py) and ``chip_smoke.py``'s phase
``parallel`` both hold a sharded or spatial step to these rules, the
training step's own (tests/test_torch_train.py):

* the loss, its parts and ``num_positives`` within ``LOSS_REL`` relative;
  ``grad_norm`` within ``GRAD_TOL`` relative;
* the gradient, read from Adam's first moment after one step
  (mu = (1 - b1) g), within ``GRAD_TOL`` of each leaf's largest |mu| plus
  ``NOISE`` of the model's largest;
* BN running statistics within ``STAT_TOL`` (relative, and of the leaf's
  largest);
* new parameters within ``PARAM_TOL`` where |mu| is above ``SMALL_GRAD`` of
  its leaf's largest and above the noise, else within 2 lr: Adam's first
  update is lr sign(g), and a gradient at the level of summation noise,
  such as that of a bias feeding a training-mode BN, may change sign.

``scale`` multiplies every tolerance but the 2 lr clause: 1 for float32,
``FLOAT64_SCALE`` for a step run in float64, where two ways of grouping the
same sums agree to about 1e-12 and any larger difference is a defect.

At D4 and D7 depth float32 rounding alone moves the gradients past these
rules, in both packages: :func:`deep_step_errors` holds what float32
resolves there against the port's float64 step.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

LOSS_REL = 1e-5
GRAD_TOL = 1e-4
STAT_TOL = 1e-5
PARAM_TOL = 1e-5
SMALL_GRAD = 1e-3
NOISE = 1e-6
FLOAT64_SCALE = 1e-6
LOSS_KEYS = ("loss", "cls_loss", "box_loss", "num_positives")

# (metrics, Adam's first moments, BN statistics, parameters), by the port's names
StepResult = Tuple[Mapping[str, float], Mapping[str, torch.Tensor], Mapping[str, torch.Tensor],
                   Mapping[str, torch.Tensor]]


def _f64(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu().double()


def _rel(got: float, want: float, tol: float) -> float:
    """|got - want| over ``tol`` |want| (a zero ``want`` holds only itself)."""
    diff = abs(float(got) - float(want))
    return diff / (tol * abs(float(want))) if want else (0.0 if diff == 0 else float("inf"))


def _noise(want_mu: Mapping[str, torch.Tensor]) -> float:
    return NOISE * max(float(_f64(v).abs().max()) for v in want_mu.values())


def grad_tolerances(want_mu: Mapping[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    """Each leaf's gradient tolerance on |mu - want|: ``GRAD_TOL`` of its
    largest |want| plus ``NOISE`` of the model's largest, times ``scale``."""
    noise = _noise(want_mu)
    return {k: scale * (GRAD_TOL * float(_f64(v).abs().max()) + noise) for k, v in want_mu.items()}


def grad_errors(got_mu: Mapping[str, torch.Tensor],
                want_mu: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's largest |got - want|."""
    return {k: float((_f64(got_mu[k]) - _f64(v)).abs().max()) for k, v in want_mu.items()}


def step_errors(got: StepResult, want: StepResult, lr: float, loss_rel: float = LOSS_REL,
                scale: float = 1.0) -> Dict[str, object]:
    """Each error of ``got`` against ``want`` over its tolerance (<= 1
    holds): ``loss``, ``grad_norm``, ``grad`` (with ``grad_worst_leaf``),
    ``bn_stats`` and ``params``; ``small_share``: the share of parameter
    elements held within 2 lr. Every leaf of ``want`` is compared."""
    (mg, mug, sg, pg), (mw, muw, sw, pw) = got, want
    loss = max(_rel(mg[k], mw[k], scale * loss_rel) for k in LOSS_KEYS)
    norm = _rel(mg["grad_norm"], mw["grad_norm"], scale * GRAD_TOL)
    tol = grad_tolerances(muw, scale)
    err = grad_errors(mug, muw)
    grad, leaf = max((err[k] / tol[k], k) for k in muw)
    stats = 0.0
    for k, v in sw.items():
        v = _f64(v)
        d = (_f64(sg[k]) - v).abs()
        bound = scale * STAT_TOL * (v.abs() + v.abs().max())
        ratio = torch.where(bound > 0, d / bound, torch.where(d > 0, float("inf"), 0.0))
        stats = max(stats, float(ratio.max()))
    noise = _noise(muw)
    params, small, total = 0.0, 0, 0
    for k, v in pw.items():
        v = _f64(v)
        g = _f64(muw[k]).abs()
        big = (g > SMALL_GRAD * g.max()) & (g > noise)
        d = (_f64(pg[k]) - v).abs()
        if big.any():
            params = max(params, float(d[big].max()) / (scale * PARAM_TOL))
        if (~big).any():
            params = max(params, float(d[~big].max()) / (2 * lr))
        small += int((~big).sum())
        total += v.numel()
    return {"loss": loss, "grad_norm": norm, "grad": grad, "grad_worst_leaf": leaf,
            "bn_stats": stats, "params": params, "small_share": small / max(total, 1)}


def grad_against_exact(got_mu: Mapping[str, torch.Tensor], ref_mu: Mapping[str, torch.Tensor],
                       exact_mu: Mapping[str, torch.Tensor]) -> Tuple[float, str]:
    """A float32 parallel step's gradient held against the float64 step's
    (``exact_mu``, the exact gradient to float32's precision), in units of
    the ``GRAD_TOL`` tolerance: its largest distance from it over 1 plus
    twice the largest distance of ``ref_mu`` (the one-process float32
    step's) from it; the ratio (<= 1 holds) and the leaf where ``got_mu``
    is furthest. So the parallel step is no further from the exact gradient
    than the usual tolerance plus twice the float32 precision that one
    process attains on the same model. For a model whose float32 gradients
    move by more than ``GRAD_TOL`` when their sums are regrouped (a weight
    feeding a training-mode BN over many pixels is a small difference of
    large sums), where :func:`step_errors`' ``grad`` cannot tell rounding
    from a defect. Model-wide, not per leaf: a leaf of two or three
    elements gives no estimate of its own rounding."""
    tol = grad_tolerances(exact_mu)
    got, ref = grad_errors(got_mu, exact_mu), grad_errors(ref_mu, exact_mu)
    worst, leaf = max((got[k] / tol[k], k) for k in exact_mu)
    return worst / (1.0 + 2.0 * max(ref[k] / tol[k] for k in exact_mu)), leaf


# deep_step_errors' limit on the gradient norm, relative
DEEP_GRAD_NORM_REL = 1e-2


def deep_step_errors(got: StepResult, exact: StepResult, lr: float) -> Dict[str, object]:
    """A float32 step ``got`` against the port's float64 step ``exact`` on
    the same weights and batch, where float32 rounding alone moves a deep
    model's gradients past :func:`step_errors`' rules. At D4 and D7 (B4/B6
    backbones, 7-8 BiFPN layers, every BN in training mode) a max-pool
    window that holds a near-tie routes its gradient to the other pixel
    under another rounding, and the float32 gradients of the backbone and
    the BiFPN lie 5e-4 to 1e-1 (L2, relative) from float64, by how the sums
    happened to round (tests/torch_entry_train.py's readings). Held: the
    loss, its parts and the BN statistics by :func:`step_errors`' rules,
    and the gradient norm within ``DEEP_GRAD_NORM_REL`` relative (the
    readings lie at 3e-5 to 1.3e-3 of it; a 1% fault in the fusion nodes'
    backward pass moves it 9-11%). Reported: ``grad_rel_l2``, the
    gradient's L2 distance from ``exact``'s over its norm, and
    :func:`step_errors`' per-leaf ``grad``. Each held error over its
    tolerance (<= 1 holds)."""
    (mg, mug, _, _), (me, mue, _, _) = got, exact
    plain = step_errors(got, exact, lr)
    diff = sum(float((_f64(mug[k]) - _f64(v)).norm()) ** 2 for k, v in mue.items()) ** 0.5
    norm = sum(float(_f64(v).norm()) ** 2 for v in mue.values()) ** 0.5
    return {"loss": plain["loss"], "bn_stats": plain["bn_stats"],
            "grad_norm": _rel(mg["grad_norm"], me["grad_norm"], DEEP_GRAD_NORM_REL),
            "grad_rel_l2": diff / norm, "grad": plain["grad"], "grad_worst_leaf": plain["grad_worst_leaf"]}


DEEP_HELD = ("loss", "grad_norm", "bn_stats")


HELD = ("loss", "grad_norm", "grad", "bn_stats", "params")


def step_holds(errors: Mapping[str, object], keys=HELD) -> bool:
    """Whether every error in ``keys`` is within its tolerance."""
    return all(float(errors[k]) <= 1.0 for k in keys)
