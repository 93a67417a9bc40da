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
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.detector import build_efficientdet


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


def drawn_model(device, seed: int = 0, dtype=None, phi: int = 0, image_size=None,
                gain: float = 1.5):
    """D``phi`` (D0@512 by default), 90 classes, in eval mode, every weight and
    BN statistic from :func:`drawn_state_dict`. ``dtype`` float64: computed
    and held in float64, the same drawn values."""
    dtype = dtype or torch.float32
    model, _ = build_efficientdet(phi, num_classes=90, seed=seed, device=device, dtype=dtype,
                                  image_size=image_size)
    model.to(dtype).load_state_dict(drawn_state_dict(model, seed, gain))
    return model
