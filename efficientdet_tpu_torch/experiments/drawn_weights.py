"""Random weights that keep a detector well conditioned.

``build_efficientdet``'s ``init_weights`` leaves every BN at mean 0, var 1,
so each residual block adds to its input's scale and the deeper phis grow
(D1's C5 to about 2e4): float32 rounding is amplified there, and two
devices or two packages cannot be compared on such weights. The CPU tests
draw every weight and BN statistic with numpy instead
(:func:`drawn_state_dict`, conv variance 1.5 / fan-in), which keeps D0-D5
well conditioned; the B6 backbone of D6/D7 is on the edge there (one draw's
float32 outputs lie 16 times the gpu_vs_cpu rule from float64), and a
variance-preserving draw (``gain=1``) keeps every phi well conditioned.

The tests' float64 witness (``tests/torch_float64_witness.py``) measures
how far float32 lies from float64 on these weights and on the init's.

Drawn BN statistics do not normalise, so D7's unweighted BiFPN (a plain
sum of two or three inputs at each of 8 layers) still grows its outputs to
about 3e2 at ``gain=1`` (1e11 at 1.5): its class logits then put every
kept score at 1.0 and its box deltas past ``exp``'s range. Running
statistics set to a batch's alone are no cure: a channel nearly constant
on noise is then divided by its tiny spread, and another image's logits
reach 4e2. :func:`calibrate_bn` sets each BN's running statistics halfway
between the drawn ones and its statistics on a batch: at ``gain=1`` D4's and
D7's class logits then stay below -3 with a spread of 0.4, box deltas below
1, on noise and on a letterboxed image alike (at 384 px).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.detector import build_efficientdet
from ..models.normalization import TpuBatchNorm
from ..ops.preprocess import preprocess_batch_fixed


def drawn_state_dict(model: torch.nn.Module, seed: int, gain: float = 1.5):
    """Every entry of ``model``'s state dict drawn with numpy from ``seed``
    (the CPU tests' draw: fan-in normal convs of variance gain / fan-in, BN
    statistics away from the identity, the class head's final bias near the
    prior)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("running_var") or (k.endswith("weight") and "bn" in k.split(".")[-2]):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("fusion_weights"):
            a = rng.uniform(0.2, 1.5, shape)
        elif k.endswith("weight") and len(shape) == 4:
            a = rng.normal(0, (gain / int(np.prod(shape[1:]))) ** 0.5, shape)
        elif k == "class_net.net.final.pointwise.bias":
            a = rng.normal(-4.6, 0.3, shape)
        else:
            a = rng.normal(0, 0.2, shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


# the share of its drawn statistics each BN keeps in calibrate_bn
CALIBRATION_KEEP = 0.5


@torch.no_grad()
def calibrate_bn(model: torch.nn.Module, images: torch.Tensor) -> torch.nn.Module:
    """Move every BN's running mean and variance to CALIBRATION_KEEP times
    its own plus the rest times its statistics on ``images`` ((B, S, S, 3)
    uint8, on the model's device): one forward pass with the BNs alone in
    training mode at momentum CALIBRATION_KEEP (so no stochastic depth is
    drawn). ``model`` is left in eval mode."""
    bns = [m for m in model.modules() if isinstance(m, TpuBatchNorm)]
    model.eval()
    momenta = [bn.momentum for bn in bns]
    try:
        for bn in bns:
            bn.train()
            bn.momentum = CALIBRATION_KEEP
        model(preprocess_batch_fixed(images, dtype=model.dtype))
    finally:
        for bn, m in zip(bns, momenta):
            bn.momentum = m
        model.eval()
    return model


# the images calibrate_bn sees in drawn_model
CALIBRATION_BATCH = 4


def calibration_images(size: int, seed: int) -> torch.Tensor:
    """(CALIBRATION_BATCH, size, size, 3) uint8 noise from numpy's ``seed``:
    the batch :func:`drawn_model` calibrates on."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 256, (CALIBRATION_BATCH, size, size, 3)).astype(np.uint8))


def drawn_model(device, seed: int = 0, dtype=None, phi: int = 0, image_size=None,
                gain: float = 1.5, calibrate: bool = False):
    """D``phi`` (D0@512 by default), 90 classes, in eval mode, every weight and
    BN statistic from :func:`drawn_state_dict`. ``dtype`` float64: computed
    and held in float64, the same drawn values. ``calibrate``: then the BN
    statistics from :func:`calibrate_bn` on :func:`calibration_images` of
    ``seed`` at the model's size."""
    dtype = dtype or torch.float32
    model, cfg = build_efficientdet(phi, num_classes=90, seed=seed, device=device, dtype=dtype,
                                    image_size=image_size)
    model.to(dtype).load_state_dict(drawn_state_dict(model, seed, gain))
    if calibrate:
        calibrate_bn(model, calibration_images(cfg.image_size, seed).to(device))
    return model
