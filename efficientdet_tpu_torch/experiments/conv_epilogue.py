"""The folded backbone's conv epilogue on the card, call by call.

:func:`recording` keeps each epilogue call a model makes
(``ops/conv_epilogue.py``): shape, SiLU or not, residual or not, the SAME
pad it writes and the layout; asked to, it holds the kernel against its twin
on each call's own inputs. :func:`forward_calls` does so over one forward of
a folded backbone with grad off.
:func:`time_calls` times, at each recorded shape on seeded random inputs,
the kernel's launch, the twin (ATen's add, silu, add and pad: what the
folded model ran before) and the least time the bytes allow.

    python -m efficientdet_tpu_torch.experiments.conv_epilogue [--phi 0] [--batch 128]

prints one JSON line: the calls, the check and the times summed over a
forward.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops import conv_epilogue as ce
from .timing import HBM_BYTES_S, cuda_ms


class Call(NamedTuple):
    shape: Tuple[int, int, int, int]  # the conv output (B, C, H, W)
    silu: bool
    residual: bool
    pads: Optional[Tuple[int, int, int, int]]
    channels_last: bool


def nhwc_images(batch: int, size: int, dtype, generator, device="cuda") -> torch.Tensor:
    """(B, 3, S, S) images laid out channels-last, as the detector hands its
    NHWC batch to the backbone."""
    return torch.randn((batch, size, size, 3), generator=generator,
                       device=device).to(dtype).permute(0, 3, 1, 2)


def folded_backbone(phi: int, dtype: torch.dtype, seed: int = 0, device="cuda"):
    """(backbone, config) of D``phi`` on ``device``, BN folded, from drawn
    weights with calibrated BN statistics (``drawn_weights.py``), so that
    every conv's folded bias is far from zero (an initialised model's BNs
    fold to zero biases, which no rounding of ``x + bias`` would show)."""
    from ..models.detector import build_efficientdet, fuse_for_inference
    from .drawn_weights import drawn_model

    state = drawn_model(device, seed, phi=phi, gain=1.0, calibrate=True).state_dict()
    model, cfg = build_efficientdet(phi, dtype=dtype, device=device)
    model.load_state_dict(state)
    return fuse_for_inference(model).backbone, cfg


@contextlib.contextmanager
def _wrapped(hook) -> Iterator[None]:
    """Route the model's epilogue calls through ``hook(fn, *args)``."""
    from ..models import efficientnet

    fn = efficientnet.conv_epilogue
    efficientnet.conv_epilogue = lambda *args: hook(fn, *args)
    try:
        yield
    finally:
        efficientnet.conv_epilogue = fn


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance of two bf16 tensors in units of the last place
    (the bit patterns in sign-magnitude order; +0 and -0 are one value)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i + 32768), i)

    return int((ordered(got) - ordered(want)).abs().max().item()) if got.numel() else 0


def compare(got: torch.Tensor, x: torch.Tensor, bias: torch.Tensor,
            residual: Optional[torch.Tensor], silu: bool, pads,
            chunk: int = 8) -> Dict[str, float]:
    """The kernel's output ``got`` against its twin on the same inputs,
    ``chunk`` images at a time (the twin's float32 copies of a D4 batch
    would not fit beside the model). In float32 the kernel must equal the
    twin bit for bit (``max_abs_err`` 0); in bf16 it rounds once where the
    twin rounds after each op, so it is held within one ulp of the twin run
    in float32 and rounded once (``ulps``), and its distance from the bf16
    twin is reported beside (``ulps_vs_bf16_ops``: rounding ``x + bias``
    before SiLU moves SiLU's small values in its negative tail by many of
    their ulps)."""
    p = pads or (0, 0, 0, 0)
    worst: Dict[str, float] = {}
    for i in range(0, x.shape[0], chunk):
        g, xs = got[i:i + chunk], x[i:i + chunk]
        rs = None if residual is None else residual[i:i + chunk]
        if got.dtype == torch.float32:
            want = ce.conv_epilogue_reference(xs, bias, rs, silu, p)
            r = {"max_abs_err": float((g - want).abs().max().item())}
        else:
            f32 = ce.conv_epilogue_reference(xs.float(), bias.float(),
                                             None if rs is None else rs.float(), silu, p)
            ops = ce.conv_epilogue_reference(xs, bias, rs, silu, p)
            r = {"ulps": bf16_ulps(g, f32.to(g.dtype)), "ulps_vs_bf16_ops": bf16_ulps(g, ops)}
        for k, v in r.items():
            worst[k] = max(worst.get(k, 0), v)
    return worst


@contextlib.contextmanager
def recording(check: bool = False) -> Iterator[Tuple[List[Call], Dict[str, float]]]:
    """Inside the block, keep each epilogue call the model makes (on any
    device, the CPU twin's too), and with ``check`` hold each against its
    twin on its own inputs (:func:`compare`, the worst of each number over
    the calls)."""
    calls: List[Call] = []
    worst: Dict[str, float] = {}

    def hook(fn, x, bias, residual, silu, pads):
        calls.append(Call(tuple(x.shape), silu, residual is not None,
                          None if pads is None else tuple(pads), ce.channels_last(x)))
        x0 = x.clone() if check else None
        out = fn(x, bias, residual, silu, pads)
        if check:
            for k, v in compare(out, x0, bias, residual, silu, pads).items():
                worst[k] = max(worst.get(k, 0), v)
        return out

    with _wrapped(hook):
        yield calls, worst


def forward_calls(backbone, images: torch.Tensor,
                  check: bool = False) -> Tuple[List[Call], Dict[str, float]]:
    """One forward of the folded ``backbone`` with grad off: its epilogue
    calls, and with ``check`` the worst of each check (:func:`recording`)."""
    with recording(check) as (calls, worst), torch.inference_mode():
        backbone(images)
    return calls, worst


def traffic_bytes(shape: Sequence[int], dtype: torch.dtype, residual: bool,
                  pads: Sequence[int] = (0, 0, 0, 0)) -> int:
    """Bytes one call must move: ``x`` (and the residual) read once, the
    (padded) output written once, the bias read once."""
    b, c, h, w = shape
    item = torch.empty((), dtype=dtype).element_size()
    n_in = b * c * h * w
    n_out = b * c * (h + pads[0] + pads[1]) * (w + pads[2] + pads[3])
    return item * (n_in * (2 if residual else 1) + n_out + c)


def time_calls(calls: List[Call], dtype: torch.dtype, steps: int = 20,
               seed: int = 0) -> Dict[str, object]:
    """At each call's shape, on seeded random inputs: the launch's ms (CUDA
    events), the kernel's device ms (torch.profiler, one session over every
    shape), the twin's ms, and the least time of its bytes at HBM_BYTES_S;
    each summed over the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0, "per_call": []}
    reps = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in calls:
            fmt = torch.channels_last if c.channels_last else torch.contiguous_format

            def draw(shape):
                return torch.randn(shape, generator=gen, device="cuda").to(
                    dtype).contiguous(memory_format=fmt)

            x, bias = draw(c.shape), torch.randn(c.shape[1], generator=gen, device="cuda").to(dtype)
            res = draw(c.shape) if c.residual else None
            pads = c.pads or (0, 0, 0, 0)
            out = x if c.pads is None else ce.empty_padded(x, pads)

            def launch():
                ce.launch_into(x, bias, res, out, c.silu, pads)

            for _ in range(reps):
                launch()
            nbytes = traffic_bytes(c.shape, dtype, c.residual, pads)
            ms = cuda_ms(launch, steps)
            tot["per_call"].append([ms, nbytes / HBM_BYTES_S * 1e3])
            tot["ms"] += ms
            tot["plain_ms"] += cuda_ms(
                lambda: ce.conv_epilogue_reference(x, bias, res, c.silu, pads), max(steps // 4, 1))
            tot["bound_ms"] += nbytes / HBM_BYTES_S * 1e3
            tot["bytes"] += nbytes
        torch.cuda.synchronize()
    # the profiled launches: ``reps`` a call, then cuda_ms's warm-up and steps
    per_call = reps + 3 + steps
    tot["device_ms"] = sum(
        getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA
        and "conv_epilogue_kernel" in e.key) / 1e3 / per_call
    tot["bound_by"] = "bytes"
    tot["roofline"] = tot["bound_ms"] / tot["device_ms"]
    return tot


def run(phi: int = 0, batch: int = 128, dtype: torch.dtype = torch.bfloat16,
        steps: int = 20) -> Dict[str, object]:
    """D``phi`` folded at its size (:func:`folded_backbone`): its calls, the
    check on one forward at ``batch`` (channels-last images, as the
    detector's) and the times at the same shapes and layouts; ``per_call``
    holds each call's ms and bound ms."""
    backbone, cfg = folded_backbone(phi, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = nhwc_images(batch, cfg.image_size, dtype, gen)
    launches0, padded0 = ce.conv_epilogue.launches, ce.conv_epilogue.padded
    calls, check = forward_calls(backbone, images, check=True)
    launches = ce.conv_epilogue.launches - launches0
    padded = ce.conv_epilogue.padded - padded0
    del images
    times = time_calls(calls, dtype, steps)
    return {"phi": phi, "batch": batch, "dtype": str(dtype).split(".")[-1],
            "launches": launches, "padded": padded, "calls": [c._asdict() for c in calls],
            "check": check, **times, "device": torch.cuda.get_device_name(0)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phi", type=int, default=0)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    p.add_argument("--steps", type=int, default=20)
    a = p.parse_args()
    dtype = torch.bfloat16 if a.dtype == "bf16" else torch.float32
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run(a.phi, a.batch, dtype, a.steps)), flush=True)


if __name__ == "__main__":
    main()
