"""Image normalisation for batched inference.

Images are RGB, NHWC, uint8 (or float in [0, 255]), as in the JAX package.
Normalisation divides by 255 first, then applies ImageNet mean/std, in
float32, and casts to the model's dtype last.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _normalize(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    x = x.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def preprocess_batch_fixed(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Normalise a batch already at model resolution: (B, S, S, 3) -> same."""
    return _normalize(images, dtype)
