"""BatchNorm with the JAX package's arithmetic, in training and inference.

``a = rsqrt(var + eps) * scale`` and ``b = bias - mean * a`` are computed in
float32 on (C,) vectors, then ``y = x * a + b`` in float32 and cast back to
the input dtype (float64 throughout for a float64 input). Parameter names
follow torch (``weight``, ``bias``, ``running_mean``, ``running_var``);
utils/convert.py maps flax's ``scale``, ``bias``, ``mean`` and ``var`` onto
them. fuse_for_inference folds every BN of an inference model into its
conv.

In training mode (``module.train()``) mean and variance are the batch's, in
float32: the biased variance ``max(E[x^2] - E[x]^2, 0)``, with gradients
through both. The running statistics move as ``m * running + (1 - m) * batch``
with m = ``momentum`` (0.99), on detached statistics. torch's
``BatchNorm2d`` updates with the unbiased variance and the other meaning of
momentum, hence this module. ``update_stats = False`` (models/remat.py sets
it while the backward pass recomputes a block) computes the same output and
leaves the running statistics alone.

Under a data-parallel or spatial ``parallel_context`` (parallel/context.py)
the training statistics are the whole batch's: the per-channel sums of x
and x^2 and the count go through an autograd all-reduce over the ranks
before the mean and variance are formed, and the running update uses them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.context import active_context


class TpuBatchNorm(nn.Module):
    """Per-channel affine over dim 1 (NCHW): running statistics in eval mode,
    the batch's in training mode."""

    def __init__(self, num_features: int, eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            ctx = active_context()
            if ctx is not None and ctx.syncs_bn(x):
                mean, var = ctx.batch_moments(xf, dims)
            else:
                mean = xf.mean(dim=dims)
                var = ((xf * xf).mean(dim=dims) - mean * mean).clamp_min(0.0)
            if self.update_stats:
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        a = torch.rsqrt(var + self.eps) * self.weight
        b = self.bias - mean * a
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (xf * a.view(shape) + b.view(shape)).to(x.dtype)
