"""The model's FLOPs at a cell's shapes, counted on the benchmark's reference.

Convolutions only (the detector has no other matrix product; the NMS and
the elementwise passes are not counted), 2 a multiply-add: a convolution
producing (B, Cout, H', W') from Cin / groups input channels with a k x k
kernel is 2 B Cout H' W' (Cin / groups) k^2, whatever implements it. The
shapes come from one forward pass of the reference on the ``meta`` device,
so nothing is computed and the port is not consulted. Training adds the
backward: the weight gradient costs what the forward did, and the input
gradient too, except for the stem, whose input is the image.
"""

from __future__ import annotations

import torch

from ..reference.model import Conv2d, Detector


def conv_flops(config, batch: int) -> list:
    """(FLOPs, is_stem) of every convolution call of one forward pass."""
    model = Detector(config).to("meta").eval()
    calls = []

    def hook(mod, inputs, out):
        cin_g = mod.weight.shape[1]
        calls.append((2 * out.numel() * cin_g * mod.k * mod.k, mod is model.backbone.stem_conv))

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv2d)]
    size = config.image_size
    with torch.no_grad():
        model(torch.zeros((batch, size, size, 3), device="meta"))
    for h in handles:
        h.remove()
    return calls


def inference_flops(config, batch: int) -> float:
    return float(sum(f for f, _ in conv_flops(config, batch)))


def training_flops(config, batch: int) -> float:
    return float(sum(f * (2 if stem else 3) for f, stem in conv_flops(config, batch)))
