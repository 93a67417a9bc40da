"""The cell's weights, made on the device from the seed.

A copy of the port's ``experiments/drawn_weights.py`` recipe, drawn with a
``torch.Generator`` on the card in three calls rather than leaf by leaf with
numpy: convolution kernels normal with variance ``gain`` / fan-in, BN scales
and variances uniform in [0.5, 1.5], fusion weights uniform in [0.2, 1.5],
the class head's final bias normal around the prior logit -4.6 (sd 0.3),
every other bias and mean normal (sd 0.2). Then each BN's running
statistics are moved halfway to its statistics on a calibration batch of
noise (``calibrate_bn``), run through the benchmark's own reference, so
that a deep detector's activations stay bounded. The result is an unfused
float32 state dict with the port's names: the port loads it with
``load_state_dict`` and the reference with the same call.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..reference.model import BatchNorm, Detector, normalize

GAIN = 1.0  # the family's variance-preserving draw (chip_smoke.FAMILY_GAIN)
CALIBRATION_KEEP = 0.5
CALIBRATION_BATCH = 4


def _kind(name: str, shape) -> str:
    if name.endswith("running_var") or (name.endswith("weight") and "bn" in name.split(".")[-2]):
        return "bn_uniform"
    if name.endswith("fusion_weights"):
        return "fusion_uniform"
    if name.endswith("weight") and len(shape) == 4:
        return "conv"
    if name == "class_net.net.final.pointwise.bias":
        return "prior"
    return "small"


@torch.no_grad()
def draw(model: Detector, seed: int, gain: float = GAIN) -> Dict[str, torch.Tensor]:
    """Every entry of ``model``'s state dict drawn on its device from ``seed``."""
    device = next(model.parameters()).device
    gen = torch.Generator(device).manual_seed(seed)
    sd = model.state_dict()
    kinds = {k: _kind(k, v.shape) for k, v in sd.items()}
    uniform = [k for k in sd if kinds[k].endswith("uniform")]
    normal = [k for k in sd if not kinds[k].endswith("uniform")]
    u = torch.rand(sum(sd[k].numel() for k in uniform), generator=gen, device=device)
    n = torch.randn(sum(sd[k].numel() for k in normal), generator=gen, device=device)
    out, off = {}, 0
    for k in uniform:
        v = u[off:off + sd[k].numel()].view(sd[k].shape)
        off += sd[k].numel()
        out[k] = 0.5 + v if kinds[k] == "bn_uniform" else 0.2 + 1.3 * v
    off = 0
    for k in normal:
        v = n[off:off + sd[k].numel()].view(sd[k].shape)
        off += sd[k].numel()
        if kinds[k] == "conv":
            out[k] = v * (gain / sd[k][0].numel()) ** 0.5
        elif kinds[k] == "prior":
            out[k] = -4.6 + 0.3 * v
        else:
            out[k] = 0.2 * v
    return {k: out[k].contiguous() for k in sd}


@torch.no_grad()
def calibrate(model: Detector, seed: int) -> None:
    """Move every BN's running statistics to CALIBRATION_KEEP times their
    own plus the rest times their statistics on CALIBRATION_BATCH noise
    images of the model's size, drawn from ``seed``; one forward pass with
    the BNs alone in training mode (no stochastic depth is drawn)."""
    device = next(model.parameters()).device
    size = model.config.image_size
    gen = torch.Generator(device).manual_seed(seed + 1)
    images = torch.randint(0, 256, (CALIBRATION_BATCH, size, size, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    model.eval()
    for bn in bns:
        bn.train()
        bn.momentum = CALIBRATION_KEEP
    model(normalize(images))
    for bn in bns:
        bn.momentum = model.config.bn_momentum
    model.eval()


def drawn_state_dict(config, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's unfused float32 weights and BN statistics, on ``device``."""
    ref = Detector(config).to(device)
    ref.load_state_dict(draw(ref, seed))
    calibrate(ref, seed)
    return {k: v.detach().clone() for k, v in ref.state_dict().items()}
