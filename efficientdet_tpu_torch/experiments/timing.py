"""Device time of a callable (CUDA events, or the profiler by kernel), and
the card's rates that every bound takes."""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

# NVIDIA H100 SXM data sheet: device memory rate and dense peaks
HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12            # tensor cores
PEAK_F32_CUDA_CORES = 67e12


def bound(bytes_moved: float, ops: float, peak_ops: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of ``bytes_moved`` at the
    memory rate and ``ops`` at ``peak_ops`` per second."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls, after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, calls: int = 3) -> Dict[str, float]:
    """Device ms per call of each kernel ``fn()`` launches, by name, from
    ``torch.profiler`` over ``calls`` calls (after one warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        m = re.search(r"\w+_kernel(<[^()]*?>)?", ev.key)  # the kernel without its arguments
        name = m.group() if m else ev.key[:80]
        out[name] = out.get(name, 0.0) + dev / 1e3 / calls
    return out
