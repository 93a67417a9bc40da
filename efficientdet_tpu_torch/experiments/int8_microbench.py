"""Does int8 buy anything on the card for EfficientDet-shaped ops?

Counterpart of the JAX package's ``experiments/int8_microbench.py``, which
asked the question of XLA on a TPU. Three pairs, int8 against bf16:

  1. a 4096^3 matrix product: int8 x int8 -> int32 (``torch._int_mm``, a
     cuBLASLt call, its second operand column-major) against bf16 x bf16 (``torch.matmul``: float32 sums on
     the tensor cores, written in bf16, where XLA writes float32);
  2. a 3x3 convolution at a BiFPN-like shape (B 8, C 224, 128 x 128);
  3. a depthwise 3x3 at the same shape.

The convolutions have no int8 x int8 -> int32 form in PyTorch on CUDA; where
an int8 op does not run, the result records ``*_int8_error``, as the JAX
script does. No kernel is written here: both sides are library calls, as
XLA's lowerings are on the JAX side.

Each iteration consumes the last one's output, as the JAX ``fori_loop``
carry does: the output's sum is folded back into the input (``% 3`` for
integers, ``* 1e-30`` for floats). A chain of N iterations is captured once
as a CUDA graph and timed by CUDA events; the time an iteration is the
two-point slope ``(t(N2) - t(N1)) / (N2 - N1)``, which cancels the launch
and the carry's shared cost. On the CPU (the tests) the chain runs eagerly
under the host clock, and its times say nothing of a device.

    python -m efficientdet_tpu_torch.experiments.int8_microbench   # on the GPU
"""

from __future__ import annotations

import json
import time

import torch
import torch.nn.functional as F

# the JAX script's shapes
MATMUL_SIZE = 4096
CONV_SHAPE = (8, 224, 128, 128)  # B, C, H, W
N_LO, N_HI, REPS = 16, 64, 3


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 sums, exact."""
    return torch._int_mm(a, b)


def conv3x3(x: torch.Tensor, k: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """SAME 3x3 convolution, NCHW; int8 inputs must give int32 sums (the
    JAX script's ``preferred_element_type``)."""
    out = F.conv2d(x, k, padding=1, groups=groups)
    if x.dtype == torch.int8 and out.dtype != torch.int32:
        raise TypeError(f"conv2d on int8 gives {out.dtype}, not int32 sums")
    return out


def _carry_step(op, carry, consts):
    out = op(carry, *consts)
    bump = out.sum()
    if carry.is_floating_point():
        bump = (bump * 1e-30).to(carry.dtype)
    else:
        bump = (bump % 3).to(carry.dtype)
    return carry + bump


def loop_bench(op, x0: torch.Tensor, *consts, n_lo: int = N_LO, n_hi: int = N_HI,
               reps: int = REPS) -> float:
    """Seconds an iteration of ``op(x, *consts)`` chained ``n`` times, by the
    two-point slope over chains of ``n_lo`` and ``n_hi`` iterations (best of
    ``reps`` each). An op that fails raises before anything is captured."""
    _carry_step(op, x0, consts)  # fails here, eagerly, where the op does not run
    if x0.is_cuda:
        return _graph_slope(op, x0, consts, n_lo, n_hi, reps)

    def chain(n):
        carry = x0
        t0 = time.perf_counter()
        for _ in range(n):
            carry = _carry_step(op, carry, consts)
        return time.perf_counter() - t0

    def best(n):
        return min(chain(n) for _ in range(reps))

    return (best(n_hi) - best(n_lo)) / (n_hi - n_lo)


def _graph_slope(op, x0, consts, n_lo, n_hi, reps):
    def captured(n):
        static = x0.clone()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # warm-up on a side stream, as capture wants
            carry = static
            for _ in range(2):
                carry = _carry_step(op, carry, consts)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            carry = static
            for _ in range(n):
                carry = _carry_step(op, carry, consts)
        return graph

    def best(graph):
        graph.replay()  # warm
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        return min(times)

    lo, hi = captured(n_lo), captured(n_hi)
    return (best(hi) - best(lo)) / (n_hi - n_lo)


def _ints(gen, shape, device):
    return torch.randint(-127, 127, shape, generator=gen, dtype=torch.int8).to(device)


def _normals(gen, shape, device):
    return torch.randn(shape, generator=gen).to(torch.bfloat16).to(device)


def run(device="cuda", matmul_size: int = MATMUL_SIZE, conv_shape=CONV_SHAPE,
        n_lo: int = N_LO, n_hi: int = N_HI, reps: int = REPS) -> dict:
    """The JAX script's result dict, key for key: each section's bf16 ms, and
    its int8 ms and speedup or its ``*_int8_error``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    gen = torch.Generator().manual_seed(0)
    kw = dict(n_lo=n_lo, n_hi=n_hi, reps=reps)
    results = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}

    n = matmul_size
    # b column-major (a (K, N) view of an (N, K) matrix): the layout
    # cuBLASLt's int8 tensor-core products read; bf16 gets the same
    a8, b8 = _ints(gen, (n, n), device), _ints(gen, (n, n), device).t()
    abf, bbf = _normals(gen, (n, n), device), _normals(gen, (n, n), device).t()
    flops = 2 * n ** 3
    t_bf = loop_bench(torch.matmul, abf, bbf, **kw)
    results["matmul_4096_bf16_ms"] = t_bf * 1e3
    results["matmul_4096_bf16_tflops"] = flops / t_bf / 1e12
    try:
        t_i8 = loop_bench(int8_matmul, a8, b8, **kw)
        results["matmul_4096_int8_ms"] = t_i8 * 1e3
        results["matmul_4096_int8_tops"] = flops / t_i8 / 1e12
        results["matmul_int8_speedup"] = t_bf / t_i8
    except Exception as e:  # noqa: BLE001 - the JAX script records what failed
        results["matmul_int8_error"] = repr(e)[:200]

    b, c, h, w = conv_shape
    x8, xbf = _ints(gen, (b, c, h, w), device), _normals(gen, (b, c, h, w), device)
    for name, ms_key, groups in (("conv3x3", "conv3x3_c224", 1), ("dwconv3x3", "dwconv3x3", c)):
        k8 = _ints(gen, (c, c // groups, 3, 3), device)
        kbf = _normals(gen, (c, c // groups, 3, 3), device)
        t_bf = loop_bench(lambda x, k: conv3x3(x, k, groups), xbf, kbf, **kw)
        results[f"{ms_key}_bf16_ms"] = t_bf * 1e3
        try:
            t_i8 = loop_bench(lambda x, k: conv3x3(x, k, groups), x8, k8, **kw)
            results[f"{ms_key}_int8_ms"] = t_i8 * 1e3
            results[f"{name}_int8_speedup"] = t_bf / t_i8
        except Exception as e:  # noqa: BLE001
            results[f"{name}_int8_error"] = repr(e)[:200]
    return results


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
