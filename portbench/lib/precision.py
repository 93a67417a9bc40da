"""Rounding hooks that run the reference one precision below a cell's.

The control of each cell is the reference put in the port's place and
computed in the nearest precision below the one the configuration states:
fp8 (e4m3, saturating at +-448) for bf16, TF32 for float32 with TF32 off.
The hook rounds every convolution's input and weight, and the heads'
outputs, and the reference computes on in float32, as tensor cores of that
precision would with float32 accumulation; in a backward pass the gradient
that flows through a rounding is rounded the same way, as the backward
convolutions of that precision would. TF32 keeps 10 of float32's 23
mantissa bits, rounded to nearest.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32).to(x.dtype)


def _rounding(fn):
    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return fn(x)

        @staticmethod
        def backward(ctx, g):
            return fn(g)

    return Round.apply


fp8 = _rounding(_fp8)
tf32 = _rounding(_tf32)
BELOW = {"bf16": fp8, "f32": tf32}
