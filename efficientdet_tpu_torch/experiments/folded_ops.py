"""The folded model's custom ops on the card, call by call.

With grad off a BN-folded model finishes its backbone's convs in two custom
ops, functions of ``models/efficientnet.py``, and runs each BiFPN node in a
third, a function of ``models/bifpn.py``; :data:`OPS` names them:
``conv_epilogue`` (``ops/conv_epilogue.py``: the stem, expand and project
convs' bias, SiLU, residual and stride-2 SAME pad; its twin is ATen's add,
silu, add and pad), ``depthwise_conv`` (``ops/depthwise_conv.py``: the
depthwise conv, bias, SiLU and the SE's channel sums; its baselines are
cuDNN's conv with the epilogue after it and the SE's mean) and
``bifpn_node`` (``ops/bifpn_node.py``: a node's moved input resampled, the
plain or weighted sum and SiLU; its baseline is ATen's resample and fusion).
An op's entry (:class:`FoldedOp`) holds what is its own: the model module
that calls it, its call's fields, its check, its traffic and its baselines.
:func:`recording` keeps every op's calls and checks those asked for;
:func:`forward_calls` does so over one forward of the backbone and the
BiFPN; :func:`time_calls` times one op at the recorded shapes beside its
bound and its baselines; :func:`run` does all of it for one phi and batch.

    python -m efficientdet_tpu_torch.experiments.folded_ops [--phi 0] [--batch 128]

prints one JSON line: every op's calls, checks and times summed over a forward.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import bifpn_node as bn
from ..ops import conv_epilogue as ce
from ..ops import depthwise_conv as dc
from .timing import PEAK_F32_CUDA_CORES, bound, cuda_ms

# float32's unit roundoff, and the bound on the relative error of the
# depthwise kernel's fast bf16 SiLU (silu.cuh: a few float32 ulps)
U32 = 2.0 ** -24
SILU_REL = 2.0 ** -21
SILU_SLOPE = 1.1  # |silu'| <= 1.1


def nhwc_images(batch: int, size: int, dtype, generator, device="cuda") -> torch.Tensor:
    """(B, 3, S, S) images laid out channels-last, as the detector hands its
    NHWC batch to the backbone."""
    return torch.randn((batch, size, size, 3), generator=generator,
                       device=device).to(dtype).permute(0, 3, 1, 2)


def folded_model(phi, dtype: torch.dtype, seed: int = 0, device="cuda"):
    """(model, config) of D``phi`` on ``device``, BN folded, from drawn
    weights with calibrated BN statistics (``drawn_weights.py``), so that
    every conv's folded bias is far from zero (an initialised model's BNs
    fold to zero biases, which no rounding of ``x + bias`` would show)."""
    from ..models.detector import build_efficientdet, fuse_for_inference
    from .drawn_weights import drawn_model

    state = drawn_model(device, seed, phi=phi, gain=1.0, calibrate=True).state_dict()
    model, cfg = build_efficientdet(phi, dtype=dtype, device=device)
    model.load_state_dict(state)
    return fuse_for_inference(model), cfg


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance of two bf16 tensors in units of the last place
    (the bit patterns in sign-magnitude order; +0 and -0 are one value)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i + 32768), i)

    return int((ordered(got) - ordered(want)).abs().max().item()) if got.numel() else 0


def _worse(worst: Dict[str, float], new: Dict[str, float]) -> None:
    for k, v in new.items():
        worst[k] = max(worst.get(k, 0), v)


# ------------------------------------------------------------ conv_epilogue


class EpilogueCall(NamedTuple):
    shape: Tuple[int, int, int, int]  # the conv output (B, C, H, W)
    silu: bool
    residual: bool
    pads: Optional[Tuple[int, int, int, int]]
    channels_last: bool


def compare(got: torch.Tensor, x: torch.Tensor, bias: torch.Tensor,
            residual: Optional[torch.Tensor], silu: bool, pads,
            chunk: int = 8) -> Dict[str, float]:
    """The epilogue kernel's output ``got`` against its twin on the same
    inputs, ``chunk`` images at a time (the twin's float32 copies of a D4
    batch would not fit beside the model). In float32 the kernel must equal
    the twin bit for bit (``max_abs_err`` 0); in bf16 it rounds once where
    the twin rounds after each op, so it is held within one ulp of the twin
    run in float32 and rounded once (``ulps``), and its distance from the
    bf16 twin is reported beside (``ulps_vs_bf16_ops``: rounding ``x + bias``
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
        _worse(worst, r)
    return worst


def _epilogue_call(x, bias, residual, silu, pads) -> EpilogueCall:
    return EpilogueCall(tuple(x.shape), silu, residual is not None,
                        None if pads is None else tuple(pads), ce.channels_last(x))


def _epilogue_checked(fn, x, bias, residual, silu, pads):
    x0 = x.clone()  # the call writes x in place
    out = fn(x, bias, residual, silu, pads)
    return out, compare(out, x0, bias, residual, silu, pads)


def _epilogue_traffic(call: EpilogueCall, dtype: torch.dtype) -> Tuple[int, int]:
    """(bytes, operations) one call must move and do: ``x`` (and the
    residual) read once, the (padded) output written once, the bias read
    once; its few operations an element bound no call."""
    b, c, h, w = call.shape
    p = call.pads or (0, 0, 0, 0)
    item = torch.empty((), dtype=dtype).element_size()
    n_in = b * c * h * w
    n_out = b * c * (h + p[0] + p[1]) * (w + p[2] + p[3])
    return item * (n_in * (2 if call.residual else 1) + n_out + c), 0


def _epilogue_setup(call: EpilogueCall, dtype: torch.dtype, gen):
    fmt = torch.channels_last if call.channels_last else torch.contiguous_format

    def draw(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
            memory_format=fmt)

    x, bias = draw(call.shape), torch.randn(call.shape[1], generator=gen, device="cuda").to(dtype)
    res = draw(call.shape) if call.residual else None
    pads = call.pads or (0, 0, 0, 0)
    out = x if call.pads is None else ce.empty_padded(x, pads)

    def launch():
        ce.launch_into(x, bias, res, out, call.silu, pads)

    def plain():
        return ce.conv_epilogue_reference(x, bias, res, call.silu, pads)

    return launch, {"plain_ms": plain}


# ----------------------------------------------------------- depthwise_conv


class DepthwiseCall(NamedTuple):
    shape: Tuple[int, int, int, int]  # the input (B, C, H, W), holding any explicit pad
    k: int
    stride: int
    pads: Tuple[int, int, int, int]
    channels_last: bool


def _bf16_half_ulp(t: torch.Tensor) -> torch.Tensor:
    """Half a bf16 ulp at each |value| of float32 ``t`` (2^-9 of its binade)."""
    e = torch.frexp(t.abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(t), e - 9)


def check(y: torch.Tensor, sums: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor, stride: int, pads: Sequence[int],
          chunk: int = 8) -> Dict[str, float]:
    """The depthwise kernel's ``y`` and ``sums`` against the twin on the same
    inputs, ``chunk`` images at a time, every number a ratio that passes at
    1 or under:

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


def _depthwise_call(x, weight, bias, stride, pads) -> DepthwiseCall:
    return DepthwiseCall(tuple(x.shape), weight.shape[-1], stride, tuple(pads),
                         ce.channels_last(x))


def _depthwise_checked(fn, x, weight, bias, stride, pads):
    y, sums = fn(x, weight, bias, stride, pads)
    return (y, sums), check(y, sums, x, weight, bias, stride, pads)


def _depthwise_traffic(call: DepthwiseCall, dtype: torch.dtype) -> Tuple[int, int]:
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


def depthwise_inputs(call: DepthwiseCall, dtype, gen):
    """(x, weight, bias) drawn at ``call``'s shape on the card."""
    fmt = torch.channels_last if call.channels_last else torch.contiguous_format
    x = torch.randn(call.shape, generator=gen, device="cuda").to(dtype).contiguous(memory_format=fmt)
    c = call.shape[1]
    weight = (torch.randn((c, 1, call.k, call.k), generator=gen, device="cuda") / call.k).to(dtype)
    bias = torch.randn(c, generator=gen, device="cuda").to(dtype)
    return x, weight, bias


def _depthwise_setup(call: DepthwiseCall, dtype: torch.dtype, gen):
    x, weight, bias = depthwise_inputs(call, dtype, gen)
    y, sums = dc._empty_outputs(x, weight, call.stride, call.pads)
    pads = list(call.pads)

    def launch():
        dc.launch_into(x, weight, bias, call.stride, call.pads, y, sums)

    def library():
        if len(set(pads)) == 1:
            out = F.conv2d(x, weight, None, call.stride, pads[0], 1, x.shape[1])
        else:
            out = F.conv2d(F.pad(x, (pads[2], pads[3], pads[0], pads[1])), weight, None,
                           call.stride, 0, 1, x.shape[1])
        return ce.conv_epilogue(out, bias, None, True)

    out = library()

    def mean():
        return torch.mean(out, dim=(2, 3), keepdim=True, dtype=torch.float32)

    return launch, {"library_ms": library, "mean_ms": mean}


# --------------------------------------------------------------- bifpn_node


class NodeCall(NamedTuple):
    shape: Tuple[int, int, int, int]  # the node's output (B, C, H, W)
    kept: int                         # inputs at the node's level, 1 or 2
    up: bool                          # top-down (the moved input upsampled) or bottom-up
    weighted: bool
    channels_last: bool


def node_check(out: torch.Tensor, kept: Sequence[torch.Tensor], moved: torch.Tensor, up: bool,
               weights: Optional[torch.Tensor], chunk: int = 8) -> Dict[str, float]:
    """The node kernel's output ``out`` against the twin run in float32 on
    the same (rounded) inputs, ``chunk`` images at a time: the weights formed
    as ``fuse`` forms them and cast to the maps' dtype, the resample exact,
    the products and sums in ``fuse``'s order, left unrounded. ``excess``:
    ``|out - twin|`` over its allowance, which passes at 1 or under: two
    float32 sums of the n products in different orders (or with weights a
    float32 ulp apart) lie within ``n 2^-23 sum |w_i x_i|`` of each other;
    SiLU's slope is at most 1.1; bf16 adds the fast SiLU's 2^-21 of the
    value and half an ulp, its one rounding. ``max_abs_err`` beside (0 where
    float32 equals the twin bit for bit) and, bf16 only, ``ulps``: the
    distance from the twin rounded once."""
    n = len(kept) + 1
    dtype = out.dtype
    if weights is not None:
        w = F.relu(weights.float())
        w = (w / (w.sum() + bn.FUSION_EPS)).to(dtype).float()
    worst: Dict[str, float] = {"excess": 0.0, "max_abs_err": 0.0}
    h, wd = out.shape[-2:]
    for i in range(0, out.shape[0], chunk):
        xs = [t[i:i + chunk].float() for t in kept]
        xs.append(bn.resampled(moved[i:i + chunk].float(), h, wd, up))
        terms = xs if weights is None else [w[j] * x for j, x in enumerate(xs)]
        acc, mag = terms[0], terms[0].abs()
        for t in terms[1:]:
            acc, mag = acc + t, mag + t.abs()
        del xs, terms
        want = F.silu(acc)
        del acc
        got = out[i:i + chunk].float()
        allow = SILU_SLOPE * n * 2 * U32 * mag + 1e-30
        del mag
        if dtype == torch.bfloat16:
            allow += SILU_REL * want.abs() + _bf16_half_ulp(torch.maximum(got.abs(), want.abs()))
            worst["ulps"] = max(worst.get("ulps", 0), bf16_ulps(out[i:i + chunk],
                                                                want.to(torch.bfloat16)))
        err = (got - want).abs()
        worst["max_abs_err"] = max(worst["max_abs_err"], float(err.max()))
        worst["excess"] = max(worst["excess"], float((err / allow).max()))
        del want, got, allow, err
    return worst


def _node_call(kept, moved, up, weights) -> NodeCall:
    return NodeCall(tuple(kept[0].shape), len(kept), up, weights is not None,
                    ce.channels_last(kept[0]))


def _node_checked(fn, kept, moved, up, weights):
    out = fn(kept, moved, up, weights)
    return out, node_check(out, kept, moved, up, weights)


def _moved_shape(call: NodeCall) -> Tuple[int, int, int, int]:
    b, c, h, w = call.shape
    return (b, c, h // 2, w // 2) if call.up else (b, c, 2 * h, 2 * w)


def _node_traffic(call: NodeCall, dtype: torch.dtype) -> Tuple[int, int]:
    """(bytes, operations) one call must move and do: each kept input read
    once, the moved input read once at its own level, the output written
    once, the float32 weights read once; its few operations an element
    bound no call."""
    b, c, h, w = call.shape
    item = torch.empty((), dtype=dtype).element_size()
    n_moved = b * c * (h * w // 4 if call.up else 4 * h * w)
    nbytes = item * ((call.kept + 1) * b * c * h * w + n_moved)
    return nbytes + (4 * (call.kept + 1) if call.weighted else 0), 0


def node_inputs(call: NodeCall, dtype, gen, device="cuda"):
    """(kept, moved, weights) drawn at ``call``'s shapes on ``device``."""
    fmt = torch.channels_last if call.channels_last else torch.contiguous_format

    def draw(shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype).contiguous(
            memory_format=fmt)

    kept = [draw(call.shape) for _ in range(call.kept)]
    weights = (torch.rand(call.kept + 1, generator=gen, device=device) * 2 - 0.5
               if call.weighted else None)
    return kept, draw(_moved_shape(call)), weights


def _node_setup(call: NodeCall, dtype: torch.dtype, gen):
    kept, moved, weights = node_inputs(call._replace(channels_last=True), dtype, gen)
    out = torch.empty_like(kept[0], memory_format=torch.channels_last)

    def launch():
        bn.launch_into(kept, moved, call.up, weights, out)

    def library():
        return bn.bifpn_node_reference(kept, moved, call.up, weights)

    return launch, {"library_ms": library}


# ------------------------------------------------------------------ shared


class FoldedOp(NamedTuple):
    """What is one op's own. Its name in :data:`OPS` is the name of ``fn``,
    which the model's module ``module`` calls, and ``<name>_kernel`` is its
    kernel in a trace."""
    module: str          # the module of ``models/`` that calls ``fn``
    fn: Callable         # ops/<name>.py's function, which holds the launch counters
    counters: Tuple[str, ...]
    call: Callable       # the model's arguments -> the call's fields
    checked: Callable    # (fn, *arguments) -> (fn's output, the check's numbers)
    traffic: Callable    # (call, dtype) -> (bytes, operations)
    setup: Callable      # (call, dtype, generator) -> (launch, {baseline key: fn})


OPS: Dict[str, FoldedOp] = {
    "conv_epilogue": FoldedOp("efficientnet", ce.conv_epilogue, ("launches", "padded"),
                              _epilogue_call, _epilogue_checked, _epilogue_traffic,
                              _epilogue_setup),
    "depthwise_conv": FoldedOp("efficientnet", dc.depthwise_conv, ("launches",),
                               _depthwise_call, _depthwise_checked, _depthwise_traffic,
                               _depthwise_setup),
    "bifpn_node": FoldedOp("bifpn", bn.bifpn_node, ("launches",), _node_call, _node_checked,
                           _node_traffic, _node_setup),
}


def counts() -> Dict[str, int]:
    """Every op's launch counters now, as ``<op>.<counter>``."""
    return {f"{name}.{key}": getattr(op.fn, key) for name, op in OPS.items() for key in op.counters}


@contextlib.contextmanager
def hooked(name: str, hook) -> Iterator[None]:
    """Route the model's calls of op ``name`` through ``hook(fn, *args)``."""
    import importlib

    module = importlib.import_module(f"..models.{OPS[name].module}", __package__)
    fn = getattr(module, name)
    setattr(module, name, lambda *args: hook(fn, *args))
    try:
        yield
    finally:
        setattr(module, name, fn)


Calls = Dict[str, List[NamedTuple]]  # by op name
Worst = Dict[str, Dict[str, float]]  # by op name, the worst of each check's numbers


@contextlib.contextmanager
def recording(check: Iterable[str] = ()) -> Iterator[Tuple[Calls, Worst]]:
    """Inside the block, keep each call the model makes of every op, by op
    name, and hold each call of the ops named in ``check`` against its rule
    on its own inputs (the worst of each number over the calls)."""
    check = set(check)
    calls: Calls = {name: [] for name in OPS}
    worst: Worst = {name: {} for name in check}

    def hook_for(name):
        op = OPS[name]

        def hook(fn, *args):
            calls[name].append(op.call(*args))
            if name not in check:
                return fn(*args)
            out, numbers = op.checked(fn, *args)
            _worse(worst[name], numbers)
            return out

        return hook

    with contextlib.ExitStack() as stack:
        for name in OPS:
            stack.enter_context(hooked(name, hook_for(name)))
        yield calls, worst


def forward_calls(model, images: torch.Tensor,
                  check: Iterable[str] = ()) -> Tuple[Calls, Worst]:
    """One forward of the folded ``model``'s backbone and BiFPN on NCHW
    ``images`` with grad off: every op's calls, and the worst of each check
    of the ops in ``check``."""
    with recording(check) as (calls, worst), torch.inference_mode():
        model.bifpn(list(model.backbone(images)))
    return calls, worst


def time_calls(name: str, calls: Sequence[NamedTuple], dtype: torch.dtype, steps: int = 20,
               seed: int = 0) -> Dict[str, object]:
    """Op ``name`` at each call's shape, on seeded random inputs: the
    launch's ms (CUDA events), the kernel's device ms (torch.profiler, one
    session over every shape), each baseline's ms and the least time of the
    call's bytes and operations (``bound_ms``, and what bounds most of it);
    each summed over the calls. ``per_call`` holds each call's ms, bound ms,
    what bounds it and its baselines' ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    op = OPS[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tot: Dict[str, object] = {"ms": 0.0, "bound_ms": 0.0, "bytes": 0, "per_call": []}
    by_bytes = 0.0
    reps = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in calls:
            launch, baselines = op.setup(c, dtype, gen)
            for _ in range(reps):
                launch()
            nbytes, ops = op.traffic(c, dtype)
            bound_ms, bound_by = bound(nbytes, ops, PEAK_F32_CUDA_CORES)
            ms = cuda_ms(launch, steps)
            row = [ms, bound_ms, bound_by]
            for key, fn in baselines.items():
                row.append(cuda_ms(fn, max(steps // 4, 1), warmup=1))
                tot[key] = tot.get(key, 0.0) + row[-1]
            tot["per_call"].append(row)
            tot["ms"] += ms
            tot["bound_ms"] += bound_ms
            tot["bytes"] += nbytes
            by_bytes += bound_ms if bound_by == "bytes" else 0.0
            del launch, baselines
        torch.cuda.synchronize()
    # the profiled launches: ``reps`` a call, then cuda_ms's warm-up and steps
    per_call = reps + 3 + steps
    tot["device_ms"] = sum(
        getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA
        and f"{name}_kernel" in e.key) / 1e3 / per_call
    tot["bound_by"] = "bytes" if 2 * by_bytes >= tot["bound_ms"] else "operations"
    tot["roofline"] = tot["bound_ms"] / tot["device_ms"]
    return tot


def run(phi=0, batch: int = 128, dtype: torch.dtype = torch.bfloat16, steps: int = 20,
        check_batch: Optional[int] = None, ops: Iterable[str] = tuple(OPS)) -> Dict[str, object]:
    """D``phi`` folded at its size (:func:`folded_model`): one forward at
    ``check_batch`` (``batch`` when None; channels-last images, as the
    detector's), its launch counts (``launches``, by counter) and each of
    ``ops`` checked call by call; then each of ``ops`` timed at its calls'
    shapes at ``batch`` (:func:`time_calls`), under the op's name with its
    calls and its check."""
    ops = tuple(ops)
    model, cfg = folded_model(phi, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = nhwc_images(check_batch or batch, cfg.image_size, dtype, gen)
    before = counts()
    calls, worst = forward_calls(model, images, check=ops)
    launches = {k: v - before[k] for k, v in counts().items()}
    del images, model
    torch.cuda.empty_cache()
    out: Dict[str, object] = {"phi": str(phi), "batch": batch, "check_batch": check_batch or batch,
                              "dtype": str(dtype).split(".")[-1], "launches": launches}
    for name in ops:
        full = [c._replace(shape=(batch,) + c.shape[1:]) for c in calls[name]]
        out[name] = {"calls": [c._asdict() for c in full], "check": worst[name],
                     **time_calls(name, full, dtype, steps)}
        torch.cuda.empty_cache()
    out["device"] = torch.cuda.get_device_name(0)
    return out


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
