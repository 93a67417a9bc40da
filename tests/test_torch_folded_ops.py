"""The folded model's custom ops against their twins, and their contracts.

Each case names its op; :data:`HELD` holds what each op's cases run
(scaffolding in ``tests/torch_folded.py``). On the CPU the ops run their
plain twins, held to the sequence the folded model ran before (the
epilogue: ATen's add, silu, add and pad, bit for bit; the depthwise conv:
``F.conv2d`` and the epilogue's twin bit for bit, ``torch.mean`` within the
stated tolerance; the BiFPN node: ATen's upsample or padded max-pool and
``fuse``'s ops, bit for bit) at every call of a folded forward and at edge
shapes, in float32 and bf16; the depthwise plan's tiles; ``opcheck``, the
fakes and the launchers' refusals. The ``cuda``-marked tests (``python -m
pytest --noconftest -q -m cuda tests/test_torch_folded_ops.py`` on a card)
hold each kernel to its rule (``experiments/folded_ops``) at every call of
D0, D4 and D7x forwards, at D4's largest call of each op and at the edges.
"""

import itertools
from typing import Callable, NamedTuple

import pytest
import torch
import torch.nn.functional as F

from efficientdet_tpu_torch.experiments import folded_ops as xf
from efficientdet_tpu_torch.ops import bifpn_node as bn
from efficientdet_tpu_torch.ops import conv_epilogue as ce
from efficientdet_tpu_torch.ops import depthwise_conv as dc
from torch_folded import (
    CALLS_PER_FORWARD,
    DTYPES,
    LAYOUTS,
    LIB,
    PHIS,
    b0_parents_route_calls,
    cpu_images,
    folded_calls,
    need_cuda,
    random_folded_model,
)

U32 = 2.0 ** -24


# ------------------------------------------------------------ the epilogue


def _epilogue_plain(x, bias, residual, silu, pads):
    """The folded model's ops before the epilogue kernel, written out."""
    y = x + bias.reshape(1, -1, 1, 1)
    if silu:
        y = F.silu(y)
    if residual is not None:
        y = y + residual
    if pads is not None:
        y = F.pad(y, (pads[2], pads[3], pads[0], pads[1]))
    return y


def _epilogue_inputs(shape, dtype, residual, seed, layout="nchw", device="cpu"):
    g = torch.Generator().manual_seed(seed)
    fmt = LAYOUTS[layout]
    x = (torch.randn(shape, generator=g) * 3).to(dtype).contiguous(memory_format=fmt)
    bias = torch.randn(shape[1], generator=g).to(dtype)
    res = (torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=fmt)
           if residual else None)
    return tuple(None if t is None else t.to(device) for t in (x, bias, res))


def _epilogue_calls(first):
    """Four of B0's epilogue calls from the ``first``-th, where its
    depthwise convs end in the epilogue too (as on a spatial band)."""
    calls = b0_parents_route_calls()
    return [(i, calls[i]) for i in range(first, first + 4)]


def _epilogue_twin_at_call(call, dtype, seed):
    """With the call's own flags and with SiLU and the residual flipped,
    unpadded, with its own pad and the k3 and k5 stride-2 pads,
    channels-last (the call's own layout) and contiguous."""
    assert call.channels_last or min(call.shape[1], call.shape[2] * call.shape[3]) == 1
    for silu, residual in {(call.silu, call.residual), (not call.silu, not call.residual)}:
        for layout, fmt in LAYOUTS.items():
            x, bias, res = _epilogue_inputs(call.shape, dtype, residual, seed, layout)
            for pads in {call.pads, None, (0, 1, 0, 1), (1, 2, 1, 2)}:
                want = _epilogue_plain(x, bias, res, silu, pads)
                got = ce.conv_epilogue(x.clone(memory_format=fmt), bias, res, silu, pads)
                assert got.dtype == dtype and torch.equal(got, want), (seed, silu, pads, layout)
                assert got.is_contiguous(memory_format=fmt)


# shapes with a scalar tail (H x W and C odd), and a B4 stage's expand
EPILOGUE_EDGES = {"odd": (2, 3, 5, 7), "odd_c": (1, 5, 9, 9), "one_row": (3, 1, 1, 3),
                  "b4_stage2_expand": (1, 192, 32, 32)}


def _epilogue_twin_at_edge(edge, dtype, layout):
    shape = EPILOGUE_EDGES[edge]
    fmt = LAYOUTS[layout]
    for residual in (False, True):
        x, bias, res = _epilogue_inputs(shape, dtype, residual, sum(shape), layout)
        for silu in (False, True):
            for pads in (None, (0, 1, 0, 1), (1, 2, 1, 2), (1, 1, 1, 1)):
                want = _epilogue_plain(x, bias, res, silu, pads)
                xi = x.clone(memory_format=fmt)
                got = ce.conv_epilogue(xi, bias, res, silu, pads)
                assert torch.equal(got, want) and got.is_contiguous(memory_format=fmt)
                if pads is None:  # in place: the same storage
                    assert got.data_ptr() == xi.data_ptr()
                else:
                    assert got.shape == ce.padded_shape(x, pads)
                    assert torch.equal(xi, x)  # the input is left alone


def _epilogue_opcheck(case):
    x, bias, res = _epilogue_inputs((2, 6, 5, 4), torch.float32, case == "residual", seed=1)
    torch.library.opcheck(LIB.conv_epilogue_.default, (x, bias, res, True))
    torch.library.opcheck(LIB.conv_epilogue_padded.default, (x, bias, res, False, [1, 2, 0, 1]))


def _epilogue_fake_shapes():
    with torch.device("meta"):
        x, b = torch.empty(2, 6, 5, 4), torch.empty(6)
        assert LIB.conv_epilogue_padded(x, b, None, True, [1, 2, 0, 1]).shape == (2, 6, 8, 5)
        assert LIB.conv_epilogue_(x, b, None, True) is None


def _epilogue_refusals():
    x, bias, _ = _epilogue_inputs((1, 16, 8, 8), torch.float32, False, seed=0)
    none = (0, 0, 0, 0)
    with pytest.raises(TypeError):
        ce.launch_into(x.double(), bias.double(), None, x, True, none)
    with pytest.raises(ValueError):
        ce.launch_into(x, bias[:8], None, x, True, none)
    with pytest.raises(ValueError):  # out is not x padded
        ce.launch_into(x, bias, None, x, True, (0, 1, 0, 1))
    with pytest.raises(ValueError):
        ce.launch_into(x, bias, x[..., :7], x, True, none)
    with pytest.raises(TypeError):
        ce.launch_into(x, bias.to(torch.bfloat16), None, x, True, none)
    with pytest.raises(ValueError):  # the residual in another layout
        ce.launch_into(x, bias, x.contiguous(memory_format=torch.channels_last), x, True, none)
    with pytest.raises(ValueError, match="exactly when nothing is padded"):
        ce.launch_into(x, bias, None, torch.empty_like(x), True, none)
    with pytest.raises(ValueError, match="unsupported device"):
        ce.conv_epilogue(x.to("meta"), bias.to("meta"), None, True)


def _epilogue_rule(worst, dtype):
    """Float32 bit for bit; bf16 within one ulp of the twin run in float32
    and rounded once (the kernel rounds once, the twin after each op)."""
    assert worst.get("max_abs_err", 0.0) == 0.0 and worst.get("ulps", 0) <= 1, worst


def _epilogue_largest_on_the_gpu(dtype):
    """D4@1024 batch 64's stage-2 expand output (192 channels at 512 x 512,
    SiLU, channels-last as on the detector's path), written into the k3
    stride-2 pad and in place."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (64, 192, 512, 512)
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype).contiguous(
        memory_format=torch.channels_last)
    bias = torch.randn(shape[1], generator=gen, device="cuda").to(dtype)
    for pads in ((0, 1, 0, 1), None):
        x0 = x.clone(memory_format=torch.channels_last) if pads is None else x
        got = ce.conv_epilogue(x0, bias, None, True, pads)
        _epilogue_rule(xf.compare(got, x, bias, None, True, pads), dtype)
        del x0, got


def _epilogue_edges_on_the_gpu(dtype):
    """Shapes with a scalar tail and C a multiple of 8, every flag, both
    layouts, twice."""
    shapes = [EPILOGUE_EDGES[e] for e in ("odd", "odd_c", "one_row")] + [(2, 16, 9, 11),
                                                                        (2, 24, 8, 8)]
    for shape in shapes:
        for silu, residual, pads, layout in itertools.product(
                (False, True), (False, True), (None, (0, 1, 0, 1), (1, 2, 1, 2)), LAYOUTS):
            x, bias, res = (None if t is None else t.to(dtype) for t in _epilogue_inputs(
                shape, torch.float32, residual, sum(shape), layout, "cuda"))
            fmt = LAYOUTS[layout]
            got = ce.conv_epilogue(x.clone(memory_format=fmt), bias, res, silu, pads)
            again = ce.conv_epilogue(x.clone(memory_format=fmt), bias, res, silu, pads)
            assert torch.equal(got, again) and got.is_contiguous(memory_format=fmt)
            _epilogue_rule(xf.compare(got, x, bias, res, silu, pads), dtype)


# ------------------------------------------------------- the depthwise conv


def _depthwise_plain(x, weight, bias, stride, pads):
    """The folded model's ops before the depthwise kernel: the conv without
    its bias (the pad inside it where symmetric, as ``same_conv``; else
    ``F.pad``), the epilogue's twin, and the SE's float32 mean."""
    c = x.shape[1]
    if len(set(pads)) == 1:
        y = F.conv2d(x, weight, None, stride, pads[0], 1, c)
    else:
        y = F.conv2d(F.pad(x, (pads[2], pads[3], pads[0], pads[1])), weight, None, stride, 0, 1, c)
    y = ce.conv_epilogue_reference(y, bias, None, True)
    return y, torch.mean(y, dim=(2, 3), keepdim=True, dtype=torch.float32)


def _mean_tol(y):
    """The SE mean from the sums against ``torch.mean``: two float32 sums of
    the map's H W terms in different orders lie within ``2 H W u`` times the
    sum of their magnitudes, and the sums' scaling rounds once more."""
    hw = y.shape[2] * y.shape[3]
    return (2 * hw + 2) * U32 * y.float().abs().mean(dim=(2, 3), keepdim=True) + 1e-30


def _depthwise_inputs(shape, k, dtype, seed, layout="nhwc"):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 2).to(dtype).contiguous(memory_format=LAYOUTS[layout])
    w = (torch.randn(shape[1], 1, k, k, generator=g) / k).to(dtype)
    b = torch.randn(shape[1], generator=g).to(dtype)
    return x, w, b


def _assert_depthwise_matches_plain(x, w, b, stride, pads):
    y, sums = dc.depthwise_conv(x, w, b, stride, pads)
    want, mean = _depthwise_plain(x, w, b, stride, pads)
    assert y.dtype == x.dtype and torch.equal(y, want)
    assert y.is_contiguous(memory_format=LAYOUTS["nhwc" if ce.channels_last(x) else "nchw"])
    n = dc.bands(y.shape[2], dc._plan_of(x, w, stride, pads)[0].th)
    assert sums.shape == (x.shape[0], n, x.shape[1]) and sums.dtype == torch.float32
    assert ((dc.se_mean(sums) - mean).abs() <= _mean_tol(want)).all()


def _depthwise_calls(phi):
    """Every depthwise call of a B``phi`` forward (B4 and B7: their calls at
    128 px, the width, k and stride of each block kept)."""
    return list(enumerate(folded_calls(phi)[0]["depthwise_conv"]))


def _depthwise_twin_at_call(call, dtype, seed):
    """On inputs drawn at the call's shape: the twin's output equals ATen's
    sequence bit for bit, its sums give the SE mean within the stated
    tolerance."""
    assert call.channels_last
    x, w, b = _depthwise_inputs(call.shape, call.k, dtype, seed)
    _assert_depthwise_matches_plain(x, w, b, call.stride, call.pads)


# (input shape, k, stride, pads)
DEPTHWISE_EDGES = {
    "k3s1_odd": ((2, 24, 9, 11), 3, 1, (1, 1, 1, 1)),
    "k3s2_pad01": ((2, 24, 10, 12), 3, 2, (0, 1, 0, 1)),
    "k5s1_odd": ((3, 40, 13, 7), 5, 1, (2, 2, 2, 2)),
    "k5s2_pad12": ((2, 40, 12, 12), 5, 2, (1, 2, 1, 2)),
    "c3840_k3": ((1, 3840, 6, 6), 3, 1, (1, 1, 1, 1)),
    "c3840_k5_prepadded": ((2, 3840, 9, 9), 5, 2, (0, 0, 0, 0)),
    "c144_prepadded": ((2, 144, 17, 19), 3, 2, (0, 0, 0, 0)),
    "one_pixel": ((1, 16, 1, 1), 3, 1, (1, 1, 1, 1)),
    "c8_k5": ((2, 8, 5, 3), 5, 1, (2, 2, 2, 2)),
}


def _depthwise_twin_at_edge(edge, dtype, layout):
    shape, k, stride, pads = DEPTHWISE_EDGES[edge]
    x, w, b = _depthwise_inputs(shape, k, dtype, list(DEPTHWISE_EDGES).index(edge), layout)
    _assert_depthwise_matches_plain(x, w, b, stride, pads)


DEPTHWISE_OPCHECKS = {"s1": (1, [1, 1, 1, 1]), "s2_pad01": (2, [0, 1, 0, 1]),
                      "s2_prepadded": (2, [0, 0, 0, 0])}


def _depthwise_opcheck(case):
    stride, pads = DEPTHWISE_OPCHECKS[case]
    x, w, b = _depthwise_inputs((2, 16, 7, 6), 3, torch.float32, stride)
    torch.library.opcheck(LIB.depthwise_conv_silu.default, (x, w, b, stride, pads))


def _depthwise_fake_shapes():
    with torch.device("meta"):
        x = torch.empty(2, 16, 9, 9).contiguous(memory_format=torch.channels_last)
        y, sums = LIB.depthwise_conv_silu(x, torch.empty(16, 1, 5, 5), torch.empty(16), 2,
                                          [1, 2, 1, 2])
    assert y.shape == (2, 16, 4, 4) and y.is_contiguous(memory_format=torch.channels_last)
    assert sums.shape == (2, 1, 16) and sums.dtype == torch.float32


def _depthwise_refusals():
    x, w, b = _depthwise_inputs((1, 16, 8, 8), 3, torch.float32, 0)
    y, sums = dc._empty_outputs(x, w, 1, (1, 1, 1, 1))
    with pytest.raises(TypeError):
        dc.launch_into(x.double(), w, b, 1, (1, 1, 1, 1), y, sums)
    with pytest.raises(ValueError):
        dc.launch_into(x.contiguous(), w, b, 1, (1, 1, 1, 1), y, sums)
    with pytest.raises(ValueError):
        dc.launch_into(x, w, b, 3, (1, 1, 1, 1), y, sums)
    with pytest.raises(ValueError):
        dc.launch_into(x, w, b, 1, (1, 1, 1, 1), y, sums[:, :0])
    with pytest.raises(ValueError, match="unsupported device"):
        dc.depthwise_conv(x.to("meta"), w, b, 1, (1, 1, 1, 1))


def _depthwise_rule(worst, dtype):
    """Within its stated bounds (``folded_ops.check``), and bf16 within one
    ulp of the twin rounded once."""
    assert worst["excess"] <= 1.0 and worst["sums_excess"] <= 1.0, worst
    if dtype == torch.bfloat16:
        assert worst["ulps"] <= 1, worst


def _depthwise_largest_on_the_gpu(dtype):
    """D4@1024 batch 64's stage-2 depthwise conv: 144 channels, k3 stride 2
    over the expand's padded 513 x 513 maps, 2.43e9 input elements."""
    call = xf.DepthwiseCall((64, 144, 513, 513), 3, 2, (0, 0, 0, 0), True)
    assert 64 * 144 * 513 * 513 > 2 ** 31
    x, w, b = xf.depthwise_inputs(call, dtype, torch.Generator(device="cuda").manual_seed(8))
    y, sums = dc.depthwise_conv(x, w, b, 2, call.pads)
    again = dc.depthwise_conv(x, w, b, 2, call.pads)
    assert torch.equal(y, again[0]) and torch.equal(sums, again[1])
    _depthwise_rule(xf.check(y, sums, x, w, b, 2, call.pads, chunk=4), dtype)


def _depthwise_edges_on_the_gpu(dtype):
    """Within the stated bounds (where the taps cancel, the allowance may
    exceed one bf16 ulp), two runs equal bit for bit."""
    for shape, k, stride, pads in DEPTHWISE_EDGES.values():
        x, w, b = (t.cuda() for t in _depthwise_inputs(shape, k, dtype, sum(shape)))
        y, sums = dc.depthwise_conv(x, w, b, stride, pads)
        again = dc.depthwise_conv(x, w, b, stride, pads)
        assert torch.equal(y, again[0]) and torch.equal(sums, again[1])
        worst = xf.check(y, sums, x, w, b, stride, pads)
        assert worst["excess"] <= 1.0 and worst["sums_excess"] <= 1.0, (shape, worst)


# -------------------------------------------------------- the BiFPN node


def _node_plain(kept, moved, up, weights):
    """The folded model's ops before the node kernel, written out: ATen's
    nearest upsample, or the -inf SAME pad and the 3x3 stride-2 max-pool,
    then ``fuse``'s weighted or plain sum and ``silu``."""
    h, w = kept[0].shape[-2:]
    if up:
        moved = F.interpolate(moved, scale_factor=2.0, mode="nearest")
    else:
        moved = F.max_pool2d(F.pad(moved, (0, 1, 0, 1), value=float("-inf")), 3, 2)
    assert moved.shape[-2:] == (h, w)
    inputs = list(kept) + [moved]
    if weights is None:
        x = inputs[0]
        for t in inputs[1:]:
            x = x + t
    else:
        wn = F.relu(weights)
        wn = (wn / (wn.sum() + 1e-4)).to(inputs[0].dtype)
        x = wn[0] * inputs[0]
        for i in range(1, len(inputs)):
            x = x + wn[i] * inputs[i]
    return F.silu(x)


def _node_inputs(call, dtype, seed, layout="nhwc"):
    call = call._replace(channels_last=layout == "nhwc")
    kept, moved, weights = xf.node_inputs(call, dtype, torch.Generator().manual_seed(seed), "cpu")
    return [t * 2 for t in kept], moved * 2, weights


def _assert_node_matches_plain(kept, moved, up, weights):
    got = bn.bifpn_node(kept, moved, up, weights)
    assert got.dtype == kept[0].dtype and torch.equal(got, _node_plain(kept, moved, up, weights))
    assert got.is_contiguous(memory_format=LAYOUTS["nhwc" if ce.channels_last(kept[0])
                                                   else "nchw"])


def _node_calls(phi):
    """Every node call of a D``phi`` forward (D0 and D4 at 128 px, D7x at
    256: its P8 at 1 x 1)."""
    return list(enumerate(folded_calls(phi)[0]["bifpn_node"]))


def _node_twin_at_call(call, dtype, seed):
    """On inputs drawn at the call's shape: the twin equals ATen's resample
    and ``fuse``'s ops bit for bit."""
    assert call.channels_last or call.shape[-2:] == (1, 1)
    kept, moved, weights = _node_inputs(call, dtype, seed)
    _assert_node_matches_plain(kept, moved, call.up, weights)


# (node output shape, kept inputs, up, weighted): both directions, one and
# two kept inputs (nodes of two and three inputs), odd output sizes
# bottom-up (the pool's window stops at the fine map's edge), one pixel,
# and D7x's width
NODE_EDGES = {
    "up_one_kept_weighted": ((2, 16, 4, 6), 1, True, True),
    "up_two_kept_plain": ((1, 24, 8, 2), 2, True, False),
    "down_two_kept_weighted_odd": ((2, 8, 3, 5), 2, False, True),
    "down_one_kept_plain_one_pixel": ((3, 16, 1, 1), 1, False, False),
    "down_c384_plain": ((1, 384, 6, 6), 2, False, False),
    "up_c384_weighted": ((1, 384, 6, 4), 1, True, True),
}


def _node_edge_call(edge, layout="nhwc"):
    shape, kept, up, weighted = NODE_EDGES[edge]
    return xf.NodeCall(shape, kept, up, weighted, layout == "nhwc")


def _node_twin_at_edge(edge, dtype, layout):
    kept, moved, weights = _node_inputs(_node_edge_call(edge, layout), dtype,
                                        list(NODE_EDGES).index(edge), layout)
    _assert_node_matches_plain(kept, moved, NODE_EDGES[edge][2], weights)


NODE_OPCHECKS = {"up_weighted": "up_one_kept_weighted", "up_plain": "up_two_kept_plain",
                 "down_weighted": "down_two_kept_weighted_odd",
                 "down_plain": "down_one_kept_plain_one_pixel"}


def _node_opcheck(case):
    edge = NODE_OPCHECKS[case]
    kept, moved, weights = _node_inputs(_node_edge_call(edge), torch.float32, 1)
    torch.library.opcheck(LIB.bifpn_node.default, (kept, moved, NODE_EDGES[edge][2], weights))


def _node_fake_shapes():
    with torch.device("meta"):
        kept = [torch.empty(2, 16, 6, 4).contiguous(memory_format=torch.channels_last)] * 2
        up = LIB.bifpn_node(kept[:1], torch.empty(2, 16, 3, 2), True, torch.empty(2))
        down = LIB.bifpn_node(kept, torch.empty(2, 16, 12, 8), False, None)
    for y in (up, down):
        assert y.shape == (2, 16, 6, 4) and y.is_contiguous(memory_format=torch.channels_last)


def _node_refusals():
    call = xf.NodeCall((1, 16, 4, 4), 2, False, True, True)
    kept, moved, weights = _node_inputs(call, torch.float32, 0)
    out = torch.empty_like(kept[0])
    with pytest.raises(ValueError, match="one or two"):
        bn.launch_into(kept * 2, moved, False, weights, out)
    with pytest.raises(TypeError):
        bn.launch_into([t.double() for t in kept], moved.double(), False, weights, out.double())
    with pytest.raises(ValueError):  # C not a multiple of 8
        bn.launch_into([t[:, :12] for t in kept], moved[:, :12], False, weights, out[:, :12])
    with pytest.raises(ValueError):  # the moved input at the node's own size
        bn.launch_into(kept, kept[0], False, weights, out)
    with pytest.raises(TypeError):
        bn.launch_into(kept, moved.to(torch.bfloat16), False, weights, out)
    with pytest.raises(ValueError):  # weights of another dtype or count
        bn.launch_into(kept, moved, False, weights.double(), out)
    with pytest.raises(ValueError):
        bn.launch_into(kept, moved, False, weights[:2], out)
    with pytest.raises(ValueError, match="channels-last"):
        bn.launch_into([t.contiguous() for t in kept], moved, False, weights, out)
    with pytest.raises(ValueError, match="unsupported device"):
        bn.bifpn_node([t.to("meta") for t in kept], moved.to("meta"), False, None)


def _node_rule(worst, dtype):
    """Within its stated allowance of the twin run in float32
    (``folded_ops.node_check``), and bf16 within one ulp of it rounded
    once."""
    assert worst["excess"] <= 1.0, worst
    if dtype == torch.bfloat16:
        assert worst["ulps"] <= 1, worst


def _node_largest_on_the_gpu(dtype):
    """D4@1024 batch 64's two largest nodes: P3's output (its moved P4
    upsampled) and P4's bottom-up node (P3 pooled), 2.35e8 elements an
    output."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for call in (xf.NodeCall((64, 224, 128, 128), 1, True, True, True),
                 xf.NodeCall((64, 224, 64, 64), 2, False, True, True)):
        kept, moved, weights = xf.node_inputs(call, dtype, gen)
        out = bn.bifpn_node(kept, moved, call.up, weights)
        assert torch.equal(out, bn.bifpn_node(kept, moved, call.up, weights))
        _node_rule(xf.node_check(out, kept, moved, call.up, weights, chunk=4), dtype)
        del kept, moved, out


def _node_edges_on_the_gpu(dtype):
    """Every edge in both layouts, two runs equal bit for bit."""
    for edge in NODE_EDGES:
        for layout in LAYOUTS:
            call = _node_edge_call(edge, layout)
            kept, moved, weights = xf.node_inputs(
                call, dtype, torch.Generator(device="cuda").manual_seed(sum(call.shape)))
            out = bn.bifpn_node(kept, moved, call.up, weights)
            assert torch.equal(out, bn.bifpn_node(kept, moved, call.up, weights))
            assert out.is_contiguous(memory_format=LAYOUTS[layout]) or call.shape[-2:] == (1, 1)
            _node_rule(xf.node_check(out, kept, moved, call.up, weights), dtype)


# ------------------------------------------------------- each op's entry


class Held(NamedTuple):
    """What one op's cases run."""
    calls: Callable               # where -> [(seed, recorded call)]
    twin_at_call: Callable        # (call, dtype, seed)
    twin_at_edge: Callable        # (edge, dtype, layout)
    opcheck: Callable             # (case)
    fake_shapes: Callable
    refusals: Callable
    rule: Callable                # (the worst of a check's numbers, dtype)
    largest_on_the_gpu: Callable  # (dtype)
    edges_on_the_gpu: Callable    # (dtype)


HELD = {
    "conv_epilogue": Held(_epilogue_calls, _epilogue_twin_at_call, _epilogue_twin_at_edge,
                          _epilogue_opcheck, _epilogue_fake_shapes, _epilogue_refusals,
                          _epilogue_rule, _epilogue_largest_on_the_gpu,
                          _epilogue_edges_on_the_gpu),
    "depthwise_conv": Held(_depthwise_calls, _depthwise_twin_at_call, _depthwise_twin_at_edge,
                           _depthwise_opcheck, _depthwise_fake_shapes, _depthwise_refusals,
                           _depthwise_rule, _depthwise_largest_on_the_gpu,
                           _depthwise_edges_on_the_gpu),
    "bifpn_node": Held(_node_calls, _node_twin_at_call, _node_twin_at_edge, _node_opcheck,
                       _node_fake_shapes, _node_refusals, _node_rule, _node_largest_on_the_gpu,
                       _node_edges_on_the_gpu),
}

# (op, where): the epilogue at four of B0's calls a case, the depthwise
# conv and the node op at every call of a phi's forward
CALL_CASES = ([("conv_epilogue", i) for i in range(0, 48, 4)]
              + [("depthwise_conv", phi) for phi in PHIS]
              + [("bifpn_node", phi) for phi in PHIS])
EDGE_CASES = ([("conv_epilogue", e) for e in EPILOGUE_EDGES]
              + [("depthwise_conv", e) for e in DEPTHWISE_EDGES]
              + [("bifpn_node", e) for e in NODE_EDGES])
OPCHECK_CASES = ([("conv_epilogue", c) for c in ("plain", "residual")]
                 + [("depthwise_conv", c) for c in DEPTHWISE_OPCHECKS]
                 + [("bifpn_node", c) for c in NODE_OPCHECKS])


# -------------------------------------------------------------- the twins


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,where", CALL_CASES)
def test_twin_is_the_plain_sequence_at_each_call(op, where, dtype):
    for seed, call in HELD[op].calls(where):
        HELD[op].twin_at_call(call, DTYPES[dtype], seed)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,edge", EDGE_CASES)
def test_twin_at_edge_shapes(op, edge, dtype, layout):
    HELD[op].twin_at_edge(edge, DTYPES[dtype], layout)


def test_se_mean_from_the_sums():
    """One band and many: the sums' shares add up to ``torch.mean`` within
    the stated tolerance, and a band's rows past the map's edge count
    nothing (a constant map's mean is the constant)."""
    for shape in [(2, 32, 5, 7), (1, 16, 40, 9), (3, 8, 64, 64)]:
        x, w, b = _depthwise_inputs(shape, 3, torch.float32, sum(shape))
        y, sums = dc.depthwise_conv(x, w, b, 1, (1, 1, 1, 1))
        th = dc._plan_of(x, w, 1, (1, 1, 1, 1))[0].th
        assert sums.shape[1] == -(-shape[2] // th)
        mean = torch.mean(y, dim=(2, 3), keepdim=True, dtype=torch.float32)
        assert ((dc.se_mean(sums) - mean).abs() <= _mean_tol(y)).all()
    x = torch.zeros(1, 16, 8, 8).contiguous(memory_format=torch.channels_last)
    y, sums = dc.depthwise_conv(x, torch.zeros(16, 1, 3, 3), torch.full((16,), 2.0), 1,
                                (1, 1, 1, 1))
    torch.testing.assert_close(dc.se_mean(sums).flatten(), F.silu(torch.tensor(2.0)).expand(16),
                               rtol=4 * 64 * U32, atol=0)


# ------------------------------------------------- the depthwise conv's plan


@pytest.mark.parametrize("dtype", DTYPES)
def test_plans_at_every_call(dtype):
    """Every call's plan: a slice of whole 16-byte pieces dividing C, lanes
    within a warp, the kernel's rows a lane, bands of at most 64 rows,
    shared memory within an SM's."""
    esize = torch.empty((), dtype=DTYPES[dtype]).element_size()
    for phi in PHIS:
        for _, call in _depthwise_calls(phi):
            c = call.shape[1]
            ho, wo = dc.out_size(*call.shape[2:], call.k, call.stride, call.pads)
            p = dc.plan(c, ho, wo, call.k, call.stride, esize)
            assert c % p.cs == 0 and p.cs * esize % 16 == 0 and p.cs == p.cg * dc.NC
            assert 1 <= p.cg <= 32 and p.th <= 64 and p.rpl == dc.rows_a_lane(call.k, call.stride)
            assert dc.smem_bytes(call.k, call.stride, p.cs, p.cg, esize) <= dc.SMEM_MAX


def test_the_plan_at_d4s_largest_conv():
    """D4's stage-2 depthwise conv (144 channels, k3 stride 2 at 512 x 512)
    reads its input in 144-byte rows, two output rows at a time."""
    assert dc.plan(144, 256, 256, 3, 2, 2) == dc.Plan(72, 18, 2)
    assert dc.plan(288, 384, 384, 3, 1, 2) == dc.Plan(32, 8, 2)
    assert dc.plan(480, 192, 192, 5, 1, 2) == dc.Plan(16, 4, 2)


# --------------------------------------------------------- the contracts


@pytest.mark.parametrize("op,case", OPCHECK_CASES)
def test_opcheck(op, case):
    HELD[op].opcheck(case)


@pytest.mark.parametrize("op", xf.OPS)
def test_fake_shapes(op):
    HELD[op].fake_shapes()


@pytest.mark.parametrize("op", xf.OPS)
def test_the_launcher_refuses_what_the_kernel_does_not_take(op):
    HELD[op].refusals()


# ------------------------------------------------------------ the harness


@pytest.mark.parametrize("op", xf.OPS)
def test_the_harness_holds_the_float32_twin_to_the_kernels_rule(op):
    """``folded_ops.forward_calls`` with its check on, over a folded D0
    forward on the CPU, where each op runs its twin: in float32 the check's
    reference computes what the twin does, so every call meets the rule the
    card's kernel is held to."""
    calls, worst = xf.forward_calls(random_folded_model(0), cpu_images(1, 3), check=(op,))
    assert len(calls[op]) == CALLS_PER_FORWARD[op][0]
    HELD[op].rule(worst[op], torch.float32)


# (call, bytes, operations) in bf16, counted by hand: each input byte read
# once, each output byte written once
TRAFFIC = {
    # x and the residual (2 x 480 elements), the 2 x 8 x 6 x 7 padded output, 8 biases
    "conv_epilogue": (xf.EpilogueCall((2, 8, 5, 6), True, True, (0, 1, 0, 1), True),
                      2 * (2 * 480 + 672 + 8), 0),
    # x (2,592), the 2 x 16 x 4 x 4 output, 16 filters and biases; one band of
    # float32 SE sums; 2 k^2 + 5 operations an output
    "depthwise_conv": (xf.DepthwiseCall((2, 16, 9, 9), 3, 2, (0, 1, 0, 1), True),
                       2 * (2592 + 512 + 16 * 10) + 4 * 2 * 16, 512 * 23),
    # two kept inputs and the output (3 x 768 elements), the moved 2 x 16 x
    # 8 x 12 read once at its own level, 3 float32 weights
    "bifpn_node": (xf.NodeCall((2, 16, 4, 6), 2, False, True, True),
                   2 * (3 * 768 + 3072) + 4 * 3, 0),
}


@pytest.mark.parametrize("op", xf.OPS)
def test_traffic_counts_each_byte_once(op):
    call, nbytes, ops = TRAFFIC[op]
    assert xf.OPS[op].traffic(call, torch.bfloat16) == (nbytes, ops)


# --------------------------------------------------------------- on a card


# (op, phi, batch): the epilogue at D0@512's benchmark batch, the depthwise
# conv and the node op at every inference cell's phi
GPU_CALL_CASES = [("conv_epilogue", 0, 128), ("depthwise_conv", 0, 16),
                  ("depthwise_conv", 4, 4), ("depthwise_conv", "7x", 2),
                  ("bifpn_node", 0, 16), ("bifpn_node", 4, 4), ("bifpn_node", "7x", 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,phi,batch", GPU_CALL_CASES)
def test_kernel_against_twin_at_every_call_on_the_gpu(op, phi, batch, dtype):
    """Every call of a folded forward of drawn weights, on the call's own
    inputs (channels-last, as on the detector's path), and its launches:
    one a call."""
    need_cuda()
    model, cfg = xf.folded_model(phi, DTYPES[dtype])
    images = xf.nhwc_images(batch, cfg.image_size, DTYPES[dtype],
                            torch.Generator(device="cuda").manual_seed(7))
    before = xf.counts()
    calls, worst = xf.forward_calls(model, images, check=(op,))
    assert all(c.channels_last for c in calls[op])
    assert xf.counts()[f"{op}.launches"] - before[f"{op}.launches"] == len(calls[op])
    assert len(calls[op]) == CALLS_PER_FORWARD[op][phi]
    if op == "conv_epilogue":
        assert sum(c.pads is not None for c in calls[op]) == 4
    HELD[op].rule(worst[op], DTYPES[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype", [("conv_epilogue", "f32"), ("conv_epilogue", "bf16"),
                                      ("depthwise_conv", "bf16"), ("bifpn_node", "bf16")])
def test_kernel_at_d4s_largest_call_on_the_gpu(op, dtype):
    """Each op's largest call of the ``d4-b64`` cell, past 2^31 elements."""
    need_cuda()
    HELD[op].largest_on_the_gpu(DTYPES[dtype])
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", xf.OPS)
def test_kernel_at_edge_shapes_on_the_gpu(op, dtype):
    need_cuda()
    HELD[op].edges_on_the_gpu(DTYPES[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_epilogue_past_2_to_32_elements_on_the_gpu(layout):
    """More than 2^32 output elements (bf16, 8.6 GB): the epilogue kernel's
    64-bit index walk, unpadded and into a k5 pad, against the twin."""
    need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = (16, 64, 2048, 2049)
    assert shape[0] * shape[1] * shape[2] * shape[3] > 2 ** 32
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16).contiguous(
        memory_format=LAYOUTS[layout])
    bias = torch.randn(shape[1], generator=gen, device="cuda").to(torch.bfloat16)
    for pads in ((1, 2, 1, 2), None):
        x0 = x if pads is not None else x.clone(memory_format=LAYOUTS[layout])
        got = ce.conv_epilogue(x0, bias, None, True, pads)
        r = xf.compare(got, x, bias, None, True, pads, chunk=2)
        assert r["ulps"] <= 1, (pads, r)
        del x0, got


@pytest.mark.cuda
def test_shared_memory_mirror_on_the_gpu():
    """``smem_bytes``, which the depthwise plan sizes its tiles by, against
    the kernel's own count at every call's plan, in both dtypes."""
    need_cuda()
    import ctypes

    from efficientdet_tpu_torch.ops import cuda_build

    fn = cuda_build.load("depthwise_conv").depthwise_conv_smem_bytes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5
    for phi in PHIS:
        for _, call in _depthwise_calls(phi):
            for esize in (2, 4):
                ho, wo = dc.out_size(*call.shape[2:], call.k, call.stride, call.pads)
                p = dc.plan(call.shape[1], ho, wo, call.k, call.stride, esize)
                want = dc.smem_bytes(call.k, call.stride, p.cs, p.cg, esize)
                assert fn(call.k, call.stride, p.cs, p.cg, esize) == want, (call, p)
