"""The folded backbone's depthwise kernel on the card, call by call.

:func:`recording` keeps each depthwise call a model makes through
``ops/depthwise_conv.py`` (input shape, k, stride, pads); asked to, it holds
each call's kernel output and SE sums against the twin on the call's own
inputs (:func:`check`). :func:`forward_calls` does so over one forward of a
folded backbone with grad off. :func:`time_calls` times, at each recorded
shape on seeded random inputs, the kernel's launch, cuDNN's depthwise conv
with the conv epilogue after it (what the folded model ran before;
``library_ms``), the SE's full mean that the sums replace (``mean_ms``) and
the least time the bytes allow.

    python -m efficientdet_tpu_torch.experiments.depthwise_conv [--phi 0] [--batch 128]

prints one JSON line: the calls, the check and the times summed over a
forward.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import conv_epilogue as ce
from ..ops import depthwise_conv as dc
from .conv_epilogue import bf16_ulps, folded_backbone, nhwc_images
from .timing import PEAK_F32_CUDA_CORES, bound, cuda_ms

# float32's unit roundoff, and the bound on the relative error of the
# kernel's fast bf16 SiLU (silu.cuh: a few float32 ulps)
U32 = 2.0 ** -24
SILU_REL = 2.0 ** -21
SILU_SLOPE = 1.1  # |silu'| <= 1.1


class Call(NamedTuple):
    shape: Tuple[int, int, int, int]  # the input (B, C, H, W), holding any explicit pad
    k: int
    stride: int
    pads: Tuple[int, int, int, int]
    channels_last: bool


@contextlib.contextmanager
def _wrapped(hook) -> Iterator[None]:
    """Route the model's depthwise calls through ``hook(fn, *args)``."""
    from ..models import efficientnet

    fn = efficientnet.depthwise_conv
    efficientnet.depthwise_conv = lambda *args: hook(fn, *args)
    try:
        yield
    finally:
        efficientnet.depthwise_conv = fn


def _bf16_half_ulp(t: torch.Tensor) -> torch.Tensor:
    """Half a bf16 ulp at each |value| of float32 ``t`` (2^-9 of its binade)."""
    e = torch.frexp(t.abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(t), e - 9)


def check(y: torch.Tensor, sums: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor, stride: int, pads: Sequence[int],
          chunk: int = 8) -> Dict[str, float]:
    """The kernel's ``y`` and ``sums`` against the twin on the same inputs,
    ``chunk`` images at a time, every number a ratio that passes at 1 or
    under:

    - ``excess``: ``|y - twin|`` over its allowance, with the twin run in
      float32 from the same (rounded) inputs (cuDNN, TF32 off) and left
      unrounded. Two float32 sums of the k^2 taps and the bias in different
      orders lie within ``k^2 2^-23 (sum |w x| + |bias|)`` of each other;
      SiLU's slope is at most 1.1; the kernel's fast bf16 SiLU adds 2^-21 of
      the value; a bf16 output adds half an ulp, its one rounding.
    - ``sums_excess``: each band's scaled sum against the float32 sum of the
      kernel's own rounded outputs in ATen's order times 1 / (Ho Wo), over
      ``(2 n u sum |y| + 2 u |sum y|) / (Ho Wo)`` (two orders of ``n`` terms,
      and the scaling's rounding).
    - ``ulps``: beside, bf16 only, the largest distance from the twin rounded
      once (where the taps cancel the allowance may exceed one ulp).
    """
    k = weight.shape[-1]
    c = x.shape[1]
    p = list(pads)
    th = dc.plan(c, y.shape[2], y.shape[3], k, stride, x.element_size()).th
    worst: Dict[str, float] = {"excess": 0.0, "sums_excess": 0.0}
    for i in range(0, x.shape[0], chunk):
        xs = x[i:i + chunk].float()
        xs = F.pad(xs, (p[2], p[3], p[0], p[1]))
        pre = F.conv2d(xs, weight.float(), None, stride, 0, 1, c) + bias.float().view(1, -1, 1, 1)
        mag = (F.conv2d(xs.abs(), weight.float().abs(), None, stride, 0, 1, c)
               + bias.float().abs().view(1, -1, 1, 1))
        del xs
        want = F.silu(pre)
        del pre
        got = y[i:i + chunk].float()
        allow = SILU_SLOPE * k * k * 2 * U32 * mag + SILU_REL * want.abs()
        del mag
        if y.dtype == torch.bfloat16:
            allow += _bf16_half_ulp(torch.maximum(got.abs(), want.abs()))
            worst["ulps"] = max(worst.get("ulps", 0),
                                bf16_ulps(y[i:i + chunk], want.to(torch.bfloat16)))
        worst["excess"] = max(worst["excess"], float(((got - want).abs() / allow).max()))
        del want, allow
        ho = got.shape[2]
        n = dc.bands(ho, th)
        rows = F.pad(got.sum(dim=3), (0, n * th - ho)).view(got.shape[0], c, n, th).sum(dim=3)
        absrows = F.pad(got.abs().sum(dim=3), (0, n * th - ho)).view(got.shape[0], c, n, th)
        terms = th * got.shape[3]
        inv = dc.inv_area(ho, got.shape[3])
        s_allow = (2 * terms * U32 * absrows.sum(dim=3) + 2 * U32 * rows.abs()) * inv + 1e-30
        s_got = sums[i:i + chunk].transpose(1, 2)
        worst["sums_excess"] = max(worst["sums_excess"],
                                   float(((s_got - rows * inv).abs() / s_allow).max()))
    return worst


@contextlib.contextmanager
def recording(check_calls: bool = False) -> Iterator[Tuple[List[Call], Dict[str, float]]]:
    """Inside the block, keep each depthwise call the model makes (on any
    device, the CPU twin's too), and with ``check_calls`` hold each against
    the twin on its own inputs (:func:`check`, the worst of each number)."""
    calls: List[Call] = []
    worst: Dict[str, float] = {}

    def hook(fn, x, weight, bias, stride, pads):
        calls.append(Call(tuple(x.shape), weight.shape[-1], stride, tuple(pads),
                          ce.channels_last(x)))
        y, sums = fn(x, weight, bias, stride, pads)
        if check_calls:
            for key, v in check(y, sums, x, weight, bias, stride, pads).items():
                worst[key] = max(worst.get(key, 0), v)
        return y, sums

    with _wrapped(hook):
        yield calls, worst


def forward_calls(backbone, images: torch.Tensor,
                  check_calls: bool = False) -> Tuple[List[Call], Dict[str, float]]:
    """One forward of the folded ``backbone`` with grad off: its depthwise
    calls, and with ``check_calls`` the worst of each check."""
    with recording(check_calls) as (calls, worst), torch.inference_mode():
        backbone(images)
    return calls, worst


def traffic(call: Call, dtype: torch.dtype) -> Tuple[int, int]:
    """(bytes, operations) one call must move and do: the input read once,
    the output written once, the filter and bias read once, the SE sums
    written once; 2 k^2 operations an output for the taps, 1 for the bias
    and 4 for SiLU."""
    b, c, h, w = call.shape
    ho, wo = dc.out_size(h, w, call.k, call.stride, call.pads)
    item = torch.empty((), dtype=dtype).element_size()
    th = dc.plan(c, ho, wo, call.k, call.stride, item).th
    n_out = b * c * ho * wo
    nbytes = item * (b * c * h * w + n_out + c * (call.k * call.k + 1)) + 4 * b * c * dc.bands(ho, th)
    return nbytes, n_out * (2 * call.k * call.k + 5)


def _inputs(call: Call, dtype, gen):
    fmt = torch.channels_last if call.channels_last else torch.contiguous_format
    x = torch.randn(call.shape, generator=gen, device="cuda").to(dtype).contiguous(memory_format=fmt)
    c = call.shape[1]
    weight = (torch.randn((c, 1, call.k, call.k), generator=gen, device="cuda") / call.k).to(dtype)
    bias = torch.randn(c, generator=gen, device="cuda").to(dtype)
    return x, weight, bias


def time_calls(calls: List[Call], dtype: torch.dtype, steps: int = 20,
               seed: int = 0) -> Dict[str, object]:
    """At each call's shape, on seeded random inputs: the launch's ms (CUDA
    events), the kernel's device ms (torch.profiler, one session over every
    shape), cuDNN's conv and the conv epilogue in place (``library_ms``),
    the SE's ``torch.mean`` over the output (``mean_ms``), and the bound;
    each summed over the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tot = {"ms": 0.0, "library_ms": 0.0, "mean_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
           "per_call": []}
    reps = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in calls:
            x, weight, bias = _inputs(c, dtype, gen)
            y, sums = dc._empty_outputs(x, weight, c.stride, c.pads)

            def launch():
                dc.launch_into(x, weight, bias, c.stride, c.pads, y, sums)

            for _ in range(reps):
                launch()
            nbytes, ops = traffic(c, dtype)
            bound_ms, bound_by = bound(nbytes, ops, PEAK_F32_CUDA_CORES)
            ms = cuda_ms(launch, steps)
            pads = list(c.pads)

            def library():
                if len(set(pads)) == 1:
                    out = F.conv2d(x, weight, None, c.stride, pads[0], 1, x.shape[1])
                else:
                    out = F.conv2d(F.pad(x, (pads[2], pads[3], pads[0], pads[1])), weight, None,
                                   c.stride, 0, 1, x.shape[1])
                return ce.conv_epilogue(out, bias, None, True)

            lib_ms = cuda_ms(library, max(steps // 4, 1), warmup=1)
            out = library()
            mean_ms = cuda_ms(lambda: torch.mean(out, dim=(2, 3), keepdim=True,
                                                 dtype=torch.float32), max(steps // 4, 1))
            del out
            tot["per_call"].append([ms, bound_ms, bound_by, lib_ms, mean_ms])
            tot["ms"] += ms
            tot["library_ms"] += lib_ms
            tot["mean_ms"] += mean_ms
            tot["bound_ms"] += bound_ms
            tot["bytes"] += nbytes
            del x, y, sums
        torch.cuda.synchronize()
    # the profiled launches: ``reps`` a call, then cuda_ms's warm-up and steps
    per_call = reps + 3 + steps
    tot["device_ms"] = sum(
        getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA
        and "depthwise_conv_kernel" in e.key) / 1e3 / per_call
    tot["roofline"] = tot["bound_ms"] / tot["device_ms"]
    return tot


def run(phi=0, batch: int = 128, dtype: torch.dtype = torch.bfloat16, steps: int = 20,
        check_batch: Optional[int] = None) -> Dict[str, object]:
    """D``phi`` folded at its size (drawn weights, ``folded_backbone``): its
    calls and the check on one forward at ``check_batch`` (``batch`` when
    None; channels-last images, as the detector's), the counters of that
    forward, and the times at ``batch``; ``per_call`` holds each call's ms,
    bound ms, what bounds it, library ms and mean ms."""
    backbone, cfg = folded_backbone(phi, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = nhwc_images(check_batch or batch, cfg.image_size, dtype, gen)
    launches0, epilogues0 = dc.depthwise_conv.launches, ce.conv_epilogue.launches
    calls, worst = forward_calls(backbone, images, check_calls=True)
    launches = dc.depthwise_conv.launches - launches0
    epilogues = ce.conv_epilogue.launches - epilogues0
    del images, backbone
    torch.cuda.empty_cache()
    full = [c._replace(shape=(batch,) + c.shape[1:]) for c in calls]
    times = time_calls(full, dtype, steps)
    return {"phi": str(phi), "batch": batch, "check_batch": check_batch or batch,
            "dtype": str(dtype).split(".")[-1], "launches": launches,
            "epilogue_launches": epilogues, "calls": [c._asdict() for c in full],
            "check": worst, **times, "device": torch.cuda.get_device_name(0)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phi", default="0", help="0-7 or 7x")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--check-batch", type=int, default=None)
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    p.add_argument("--steps", type=int, default=20)
    a = p.parse_args()
    dtype = torch.bfloat16 if a.dtype == "bf16" else torch.float32
    torch.backends.cudnn.allow_tf32 = False
    phi = a.phi if a.phi == "7x" else int(a.phi)
    print(json.dumps(run(phi, a.batch, dtype, a.steps, a.check_batch)), flush=True)


if __name__ == "__main__":
    main()
