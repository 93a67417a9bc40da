"""The heads' final pointwise conv, anchor-major: CUDA kernel and plain twin.

Counterpart of the JAX package's ``ops/head_pallas.py``. For pixel rows
``x (M, Cin)``, a kernel ``(Cin, A*out)`` and a float32 bias:

  z    (A, Mp, out)  plane ``a`` holds anchor ``a``'s outputs for every row,
                     in the input dtype;
  amax (A, Mp)       the max over ``out`` of each row's float32 sums, in the
                     input dtype.

``Mp`` is M padded up to a multiple of ROW_TILE (512); the padded rows hold
the bias only and must never be selected. Row ``m = b*H*W + p`` is pixel
``p`` of image ``b`` (per level, levels concatenated).

:func:`head_pointwise_anchor_major` launches ``csrc/head_pointwise.cu`` for a
CUDA tensor and takes :func:`head_pointwise_reference` only for a CPU one.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

ROW_TILE = 512
_MAX_OUT = 128  # the kernel keeps at most 8 columns of 16 threads


def head_pointwise_reference(
    x2d: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, num_anchors: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Plain-torch twin of the kernel (float32 sums, one matmul)."""
    m, cin = x2d.shape
    ac = kernel.shape[-1]
    out_per = ac // num_anchors
    mp = m + (-m) % ROW_TILE
    k = kernel.to(x2d.dtype).float()
    acc = x2d.float() @ k + bias.float()
    if mp > m:
        pad = bias.float().expand(mp - m, ac)
        acc = torch.cat([acc, pad], dim=0)
    z = acc.reshape(mp, num_anchors, out_per).permute(1, 0, 2).to(x2d.dtype)
    amax = z.amax(dim=-1)
    return z.contiguous(), amax, m


def head_pointwise_anchor_major(
    x2d: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, num_anchors: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(M, Cin) @ (Cin, A*out) + bias -> (z (A, Mp, out), amax (A, Mp), M)."""
    if x2d.device.type == "cpu":
        return head_pointwise_reference(x2d, kernel, bias, num_anchors)
    if x2d.device.type != "cuda":
        raise ValueError(f"head_pointwise_anchor_major: unsupported device {x2d.device}")
    from . import cuda_build

    m, cin = x2d.shape
    ac = kernel.shape[-1]
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x2d must be float32 or bfloat16, got {x2d.dtype}")
    if kernel.shape != (cin, ac) or bias.shape != (ac,) or ac % num_anchors:
        raise ValueError(
            f"shapes x {tuple(x2d.shape)}, kernel {tuple(kernel.shape)}, "
            f"bias {tuple(bias.shape)} do not fit {num_anchors} anchors"
        )
    out_per = ac // num_anchors
    if out_per > _MAX_OUT:
        raise ValueError(f"at most {_MAX_OUT} outputs per anchor, got {out_per}")
    if not x2d.is_contiguous():
        raise ValueError("x2d must be contiguous")
    if x2d.dtype == torch.bfloat16 and (cin % 8 or x2d.data_ptr() % 16):
        raise ValueError("bf16 x2d needs Cin % 8 == 0 and a 16-byte aligned start")
    if kernel.device != x2d.device or bias.device != x2d.device:
        raise ValueError("x2d, kernel and bias must be on one device")
    # (A*out, Cin), k contiguous; no copy when ``kernel`` is the transposed
    # view of a conv weight already in the compute dtype, as in the heads
    kt = kernel.to(x2d.dtype).t().contiguous()
    b = bias.float().contiguous()
    mp = m + (-m) % ROW_TILE
    z = torch.empty((num_anchors, mp, out_per), dtype=x2d.dtype, device=x2d.device)
    amax = torch.empty((num_anchors, mp), dtype=x2d.dtype, device=x2d.device)

    lib = cuda_build.load("head_pointwise")
    fn = lib.head_pointwise_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = fn(
            x2d.data_ptr(), kt.data_ptr(), b.data_ptr(), z.data_ptr(), amax.data_ptr(),
            m, mp, cin, num_anchors, out_per,
            0 if x2d.dtype == torch.float32 else 1, stream,
        )
    cuda_build.check(lib, "head_pointwise", err)
    head_pointwise_anchor_major.launches += 1
    return z, amax, m


head_pointwise_anchor_major.launches = 0
