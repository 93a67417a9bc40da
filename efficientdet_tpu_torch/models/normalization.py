"""BatchNorm in its inference form, with the JAX package's arithmetic.

``a = rsqrt(var + eps) * scale`` and ``b = bias - mean * a`` are computed in
float32 on (C,) vectors, then ``y = x * a + b`` in float32 and cast back to
the input dtype. Parameter names follow torch (``weight``, ``bias``,
``running_mean``, ``running_var``); utils/convert.py maps flax's ``scale``,
``bias``, ``mean`` and ``var`` onto them. Only the unfused model runs this
module: fuse_for_inference folds every BN into its conv. Training-mode batch
statistics arrive with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


class TpuBatchNorm(nn.Module):
    """Per-channel affine from running statistics, over dim 1 (NCHW)."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.rsqrt(self.running_var + self.eps) * self.weight
        b = self.bias - self.running_mean * a
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x.float() * a.view(shape) + b.view(shape)).to(x.dtype)
