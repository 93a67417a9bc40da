"""The tap-floor microbenchmark's kernel and its plain twin.

Counterpart of the JAX package's ``experiments/vpu_tap_floor.py``
(``_floor_kernel``). For every element x, ``chains`` accumulators start at 0
and each of ``repeats`` passes runs

  fma:    accs[t % chains] = accs[t % chains] * w_t + x for t < taps,
          w_t = 1 + 1e-3 (t + 1) in x's dtype;
  swish:  accs[c] = x * sigmoid(accs[c]) for every chain (float32 only);

and the output is the chains' sum, in order. :func:`tap_floor` launches
``csrc/tap_floor.cu`` for a CUDA tensor and takes :func:`tap_floor_reference`
only for a CPU one.
"""

from __future__ import annotations

import ctypes

import torch

OPS = ("fma", "swish")


def tap_floor_reference(x: torch.Tensor, op: str = "fma", taps: int = 9, repeats: int = 1,
                        chains: int = 1) -> torch.Tensor:
    """Plain twin. In bf16 each FMA rounds once, as the kernel's ``__hfma2``
    (its float32 sum of the exact product rounds before that, so a tie may
    rarely land one bf16 ulp off); in float32 it multiplies, then adds."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    accs = [torch.zeros_like(x) for _ in range(chains)]
    for _ in range(repeats):
        if op == "fma":
            for t in range(taps):
                c = t % chains
                w = torch.tensor(1.0 + 1e-3 * (t + 1), dtype=x.dtype)
                if x.dtype == torch.bfloat16:
                    accs[c] = (accs[c].float() * w.float() + x.float()).to(x.dtype)
                else:
                    accs[c] = accs[c] * w + x
        else:
            accs = [x * torch.sigmoid(a) for a in accs]
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc


def tap_floor(x: torch.Tensor, op: str = "fma", taps: int = 9, repeats: int = 1,
              chains: int = 1) -> torch.Tensor:
    """The floor body over every element of ``x``; a tensor of x's shape."""
    if x.device.type == "cpu":
        return tap_floor_reference(x, op, taps, repeats, chains)
    if x.device.type != "cuda":
        raise ValueError(f"tap_floor: unsupported device {x.device}")
    from . import cuda_build

    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if x.dtype not in (torch.float32, torch.bfloat16) or (op == "swish" and x.dtype != torch.float32):
        raise TypeError(f"tap_floor: {op} does not take {x.dtype}")
    if op == "fma" and taps not in (3, 9):
        raise ValueError(f"the kernel is built for 3 or 9 taps, not {taps}")
    if chains not in (1, 4) or repeats < 0:
        raise ValueError(f"chains must be 1 or 4 and repeats >= 0, got {chains}, {repeats}")
    if not x.is_contiguous() or (x.dtype == torch.bfloat16 and (x.numel() % 2 or x.data_ptr() % 4)):
        raise ValueError("x must be contiguous (bf16: an even count, 4-byte aligned)")
    out = torch.empty_like(x)
    lib = cuda_build.load("tap_floor")
    fn = lib.tap_floor_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), OPS.index(op), taps, chains, repeats,
                 int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(lib, "tap_floor", err)
    tap_floor.launches += 1
    return out


tap_floor.launches = 0
