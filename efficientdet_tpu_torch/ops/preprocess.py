"""Image preprocessing on the device: resize, pad to square, normalise.

Counterpart of the JAX package's ``ops/preprocess.py``. Images are RGB, NHWC,
uint8 (or float in [0, 255]), as in the JAX package. Normalisation divides
by 255 first, then applies ImageNet mean/std, in float32, and casts to the
model's dtype last. Every function here is capturable in a CUDA graph: the
constants are made on the device by fills (utils/cuda_graph.py).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.cuda_graph import capturable_constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _normalize(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    x = x.float() / 255.0
    mean = capturable_constant(IMAGENET_MEAN, x.device)
    std = capturable_constant(IMAGENET_STD, x.device)
    return ((x - mean) / std).to(dtype)


def preprocess_image(
    image: torch.Tensor, target_size: int, dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resize the long side to ``target_size``, pad to square, normalise.

    image: (H, W, 3) RGB uint8 or float, on any device. Returns the
    (target_size, target_size, 3) normalised image in ``dtype`` and the
    scale applied (a float32 scalar on the image's device; divide boxes by
    it to return to source pixels). The resized extent is
    (round(H * scale), round(W * scale)); the bottom and right are zero
    padded after normalisation.

    ``jax.image.resize(..., "bilinear")`` is antialiased where it shrinks
    and plain bilinear where it enlarges, so the antialiased kernel runs
    only for a scale below 1. (The short side never grows when the long side
    shrinks: round(w * scale) <= w for scale < 1.)
    """
    h, w = image.shape[0], image.shape[1]
    scale = target_size / max(h, w)
    new_h, new_w = round(h * scale), round(w * scale)
    x = image.float().permute(2, 0, 1)[None]
    resized = F.interpolate(
        x, size=(new_h, new_w), mode="bilinear", align_corners=False, antialias=scale < 1
    )[0].permute(1, 2, 0)
    out = _normalize(resized, dtype)
    out = F.pad(out, (0, 0, 0, target_size - new_w, 0, target_size - new_h))
    # a fill, not a copy from the host: the Predictor captures this
    return out, torch.full((), scale, dtype=torch.float32, device=image.device)


def preprocess_batch_fixed(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Normalise a batch already at model resolution: (B, S, S, 3) -> same."""
    return _normalize(images, dtype)
