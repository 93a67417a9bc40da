"""The folded model's route through its custom ops.

Where the ops share a test, each case names its op
(``tests/torch_folded.py``). On the CPU: each op's calls per folded forward
with grad off at D0, D4 and D7x, none off the folded path (the unfused
model, grad on, a training step), the launch counters left alone by the
twins; the folded taps against the parent's routes, and the BiFPN's levels
against ATen's route; a spatial band's and the node op's other exceptions
(sizes off the 2x ladder); one op node a BiFPN node in an exported program.
The ``cuda``-marked tests (``python -m pytest --noconftest -q -m cuda
tests/test_torch_folded_route.py`` on a card): the counters per forward,
the taps with the epilogue kernel and the levels with the node kernel
against their twins, a CUDA graph and an ``.edz`` round trip.
"""

import copy
import functools
from contextlib import nullcontext

import pytest
import torch

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.experiments import folded_ops as xf
from efficientdet_tpu_torch.models import bifpn as bifpn_mod
from efficientdet_tpu_torch.models import conv as conv_mod
from efficientdet_tpu_torch.models.detector import init_weights
from efficientdet_tpu_torch.ops import bifpn_node as bn
from efficientdet_tpu_torch.ops import conv_epilogue as ce
from torch_folded import (
    CALLS_PER_FORWARD,
    DTYPES,
    PHIS,
    SIZE,
    b0_parents_route_calls,
    folded_calls,
    need_cuda,
    parents_route,
    random_folded_model,
    slim,
)

# each op's calls in a forward of the slim D0 (its BiFPN 2 layers deep)
SLIM_CALLS = {**{op: CALLS_PER_FORWARD[op][0] for op in xf.OPS}, "bifpn_node": 2 * 8}


# ------------------------------------------------------- calls per forward


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("op", xf.OPS)
def test_calls_per_folded_forward(op, phi):
    """A folded forward with grad off makes one depthwise call a block (16
    at D0, 32 at D4, 55 at D7x), leaves the epilogue the stem, the expands
    and the projects (32, 63, 107; 4 of them padded) and makes one node call
    a BiFPN node (24, 56, 80), under ``inference_mode`` and ``no_grad``
    alike (D0, D4); on the CPU they run the twins, which the launch counters
    do not count (they count the card's launches)."""
    for grad_off in ("inference_mode", "no_grad") if phi != "7x" else ("inference_mode",):
        calls, counted, _ = folded_calls(phi, grad_off)
        assert len(calls[op]) == CALLS_PER_FORWARD[op][phi], grad_off
        if op == "conv_epilogue":
            assert sum(c.pads is not None for c in calls[op]) == 4
        assert not any(counted.values()), counted


@pytest.mark.parametrize("phi", PHIS)
def test_every_node_still_counts_in_fuse(phi):
    """``bifpn.fuse.sum`` and ``.weighted`` count each node whichever path
    runs it: 24 weighted a D0 forward, 56 at D4, 80 sum at D7x."""
    want = {0: (0, 24), 4: (0, 56), "7x": (80, 0)}[phi]
    calls, _, nodes = folded_calls(phi, "inference_mode")
    assert (nodes["sum"], nodes["weighted"]) == want
    assert sum(c.weighted for c in calls["bifpn_node"]) == want[1]


def test_b0_calls_and_their_pads():
    """B0's epilogue calls where its depthwise convs end in the epilogue
    too (48), and on the folded route (32, where the depthwise kernel takes
    B0's 16 depthwise convs)."""
    calls = b0_parents_route_calls()
    assert len(calls) == 48
    folded_route = folded_calls(0)[0]["conv_epilogue"]
    assert len(folded_route) == 32 and sum(c.pads is not None for c in folded_route) == 4
    padded = [c for c in calls if c.pads is not None]
    # stages 2, 3, 4 and 6 open with a stride-2 depthwise conv: k3, k5, k3, k5
    assert [c.pads for c in padded] == [(0, 1, 0, 1), (1, 2, 1, 2), (0, 1, 0, 1), (1, 2, 1, 2)]
    assert [c.shape[1] for c in padded] == [96, 144, 240, 672]
    assert sum(c.residual for c in calls) == 9  # B0's residual blocks
    assert calls[0] == xf.EpilogueCall((1, 32, SIZE // 2, SIZE // 2), True, False, None,
                                       True)  # the stem


@pytest.fixture(scope="module")
def off_path():
    """Every op's calls, by step: the unfused model (no conv bias: BN after
    the conv), the folded pipeline (the control), the folded model with
    grad, and the folded backbone on an NCHW map with its taps."""
    unfused = init_weights(et.EfficientDet(slim()), 0).eval()
    folded = et.fuse_for_inference(unfused)
    x = torch.rand(1, SIZE, SIZE, 3)
    steps = {}
    with xf.recording() as (steps["unfused"], _), torch.inference_mode():
        unfused(x)
    with xf.recording() as (steps["pipeline"], _), torch.inference_mode():
        et.predict_pipeline(folded, (x * 255).to(torch.uint8))
    with xf.recording() as (steps["grad"], _), torch.enable_grad():
        folded(x)
    with xf.recording() as (steps["nchw"], _), torch.inference_mode():
        feats = folded.bifpn(list(folded.backbone(x.permute(0, 3, 1, 2).contiguous())))
    return steps, feats


@pytest.mark.parametrize("op", xf.OPS)
def test_no_call_off_the_folded_path(op, off_path):
    """The unfused model and a call with grad make no call of any op; the
    folded pipeline makes every call of a forward, and so do the folded
    backbone and BiFPN on an NCHW map, whose layout every call's output
    keeps (the project conv's residual is in it)."""
    steps, feats = off_path
    assert steps["unfused"][op] == [] and steps["grad"][op] == []
    for step in ("pipeline", "nchw"):
        assert len(steps[step][op]) == SLIM_CALLS[op], step
    if op == "conv_epilogue":
        assert sum(c.pads is not None for c in steps["pipeline"][op]) == 4
    assert not any(c.channels_last for c in steps["nchw"][op])
    assert all(not ce.channels_last(f) and f.is_contiguous() for f in feats)


@pytest.fixture(scope="module")
def training_step():
    """One slim training step on the CPU, every op's calls recorded."""
    model = init_weights(et.EfficientDet(slim()), 0).train()
    tc = et.TrainConfig(batch_size=1, max_gt_boxes=4)
    state = et.create_train_state(model, tc, device="cpu")
    step = et.make_train_step(model, tc, device="cpu")
    batch = {"images": torch.rand(1, SIZE, SIZE, 3),
             "gt_boxes": torch.tensor([[[4.0, 4.0, 30.0, 40.0]] + [[0.0] * 4] * 3]),
             "gt_labels": torch.tensor([[1] + [-1] * 3], dtype=torch.int32)}
    with xf.recording() as (calls, _):
        state, metrics = step(state, batch)
    return state, metrics, calls


@pytest.mark.parametrize("op", xf.OPS)
def test_a_training_step_makes_none(op, training_step):
    state, metrics, calls = training_step
    assert state.step == 1 and torch.isfinite(metrics["loss"] if "loss" in metrics
                                              else next(iter(metrics.values())))
    assert calls[op] == []


# ------------------------------------------------------- the backbone's taps


@functools.lru_cache(maxsize=None)
def _backbone(phi, dtype: str):
    backbone = random_folded_model(phi).backbone
    return backbone if dtype == "f32" else copy.deepcopy(backbone).to(DTYPES[dtype])


@functools.lru_cache(maxsize=None)
def _taps(phi, dtype: str, layout: str, route: str):
    """C3, C4, C5 of the folded backbone (in ``dtype``) on two images
    (channels-last as the detector's, or NCHW), along ``route``: "folded"
    (grad off: through the ops), "grad" (the parent's ops: the bias inside
    the conv, silu, add, ``F.pad``) or "parents" (grad off, the depthwise
    convs on :func:`parents_route`)."""
    backbone = _backbone(phi, dtype)
    g = torch.Generator().manual_seed(3)
    x = (xf.nhwc_images(2, SIZE, DTYPES[dtype], g, "cpu") if layout == "nhwc"
         else torch.randn(2, 3, SIZE, SIZE, generator=g))
    if route == "grad":
        with torch.enable_grad():
            return [t.detach() for t in backbone(x)]
    with torch.inference_mode(), parents_route() if route == "parents" else nullcontext():
        return backbone(x)


@pytest.mark.parametrize("phi,layout", [(0, "nhwc"), (0, "nchw"), (4, "nhwc")])
def test_taps_equal_the_bias_in_conv_path(phi, layout):
    """A folded backbone's C3, C4, C5 on the CPU in f32: through the ops
    (grad off) and through the parent's ops (grad on: the bias inside the
    conv, silu, add, F.pad) agree to float32 rounding."""
    got, want = (_taps(phi, "f32", layout, route) for route in ("folded", "grad"))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * w.abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phi", [0, 4])
def test_taps_equal_the_parents_route(phi, dtype):
    """A folded backbone's C3, C4, C5 through the depthwise op against the
    parent's route (ATen's conv, the epilogue, ``torch.mean``): the outputs
    are the same ATen ops, the SE means differ in their sums' order, so
    float32 taps agree to float32 rounding and bf16 taps to a bf16 ulp of
    the tap's scale."""
    got, want = (_taps(phi, dtype, "nhwc", route) for route in ("folded", "parents"))
    for g, w in zip(got, want):
        scale = w.float().abs().max().item()
        tol = 1e-5 if dtype == "f32" else 2 ** -7
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


# ----------------------------------------------------- the BiFPN's levels


@functools.lru_cache(maxsize=None)
def _levels(phi, dtype: str, route: str, size: int = 0):
    """P3..P``max`` of D``phi``'s folded BiFPN (weights at 1 / fan-in, the
    node weights float32 as the folded model keeps them) on two images'
    drawn C3..C5 taps, channels-last, at ``size`` (the model's own where
    0), grad off: through the node op ("folded") or ATen's resample and
    ``fuse`` ("aten"); and the node calls made."""
    model = random_folded_model(phi)
    fpn = model.bifpn if dtype == "f32" else copy.deepcopy(model.bifpn).to(DTYPES[dtype])
    for name, p in fpn.named_parameters():
        if name.endswith("fusion_weights"):
            p.data = p.data.float()
    size = size or model.config.image_size
    g = torch.Generator().manual_seed(5)
    layer = model.bifpn.layer0
    taps = [torch.randn(2, conv.weight.shape[1], -(-size // 2 ** lvl), -(-size // 2 ** lvl),
                        generator=g).to(DTYPES[dtype]).contiguous(memory_format=torch.channels_last)
            for lvl, conv in zip((3, 4, 5), (layer.p3_in_conv, layer.p4_in_td_conv,
                                             layer.p5_in_td_conv))]
    with xf.recording() as (calls, _), torch.inference_mode():
        if route == "aten":
            fn = bifpn_mod.node_folds
            bifpn_mod.node_folds = lambda *args: False
            try:
                levels = fpn(taps)
            finally:
                bifpn_mod.node_folds = fn
        else:
            levels = fpn(taps)
    return levels, calls["bifpn_node"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phi", [0, "7x"])
def test_levels_equal_atens_route(phi, dtype):
    """The folded BiFPN's levels through the node op's twin equal ATen's
    resample and ``fuse`` bit for bit, weighted (D0) and plain (D7x), in
    float32 and bf16: the twin is those ops."""
    (got, calls), (want, none) = (_levels(phi, dtype, r) for r in ("folded", "aten"))
    assert len(calls) == CALLS_PER_FORWARD["bifpn_node"][phi] and none == []
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_a_size_off_the_2x_ladder_keeps_atens_route():
    """At 96 px P5 is 3 x 3 and P6 2 x 2, so P5's top-down node and P6's
    bottom-up node are no 2x resample and keep ATen's route (nearest-exact,
    and a window past the odd edge); the other six a layer take the op, and
    the levels equal ATen's route bit for bit."""
    (got, calls), (want, _) = (_levels(0, "f32", r, 96) for r in ("folded", "aten"))
    assert len(calls) == 3 * 6
    assert [c.shape[-1] for c in calls[:8]] == [2, 6, 12, 6, 3, 1, 2, 6]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_node_folds_takes_only_what_the_kernel_does(monkeypatch):
    node = bifpn_mod.FusedNode(16, 2, fuse_bn=True)
    fine = torch.zeros(1, 16, 8, 8).contiguous(memory_format=torch.channels_last)
    coarse = torch.zeros(1, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert bifpn_mod.node_folds(node, [fine], coarse, True)
        assert bifpn_mod.node_folds(node, [coarse], fine, False)
        assert bifpn_mod.node_folds(node, [fine], coarse.contiguous(), True)  # any layout
        assert not bifpn_mod.node_folds(bifpn_mod.FusedNode(16, 2), [fine], coarse, True)
        assert not bifpn_mod.node_folds(node, [fine], fine, True)
        assert not bifpn_mod.node_folds(node, [fine[..., :7, :7]], coarse, True)
        assert not bifpn_mod.node_folds(node, [fine[:, :12]], coarse[:, :12], True)
        assert not bifpn_mod.node_folds(node, [fine.double()], coarse.double(), True)
        assert not bifpn_mod.node_folds(node, [fine], coarse.to(torch.bfloat16), True)
        bf16 = copy.deepcopy(node).to(torch.bfloat16)
        assert not bifpn_mod.node_folds(bf16, [fine], coarse, True)
        monkeypatch.setattr(bifpn_mod, "active_context", lambda: _Band())
        assert not bifpn_mod.node_folds(node, [fine], coarse, True)
    assert not bifpn_mod.node_folds(node, [fine], coarse, True)  # grad on


def test_an_exported_program_holds_one_op_node_a_bifpn_node():
    """``torch.export`` of the folded slim D0's pipeline on the CPU keeps
    each BiFPN node as one ``bifpn_node`` node (16), no upsample and only
    the first layer's two pools to P6 and P7; the program's answer equals
    the eager pipeline's."""
    from efficientdet_tpu_torch.export import export_predict

    folded = et.fuse_for_inference(init_weights(et.EfficientDet(slim()), 0).eval())
    exported, weights = export_predict(folded, 1)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert sum("bifpn_node" in t for t in targets) == SLIM_CALLS["bifpn_node"]
    assert not any("upsample" in t for t in targets)
    assert sum("max_pool" in t for t in targets) == 2
    x = torch.randint(0, 256, (1, SIZE, SIZE, 3), dtype=torch.uint8)
    with torch.inference_mode():
        want = et.predict_pipeline(folded, x)
    got = exported.module()(weights, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------- where the route turns off


class _Band:
    def banded(self, t):
        return True


def test_a_band_takes_no_padded_write(monkeypatch):
    """Under a spatial context a banded input is padded by its halo
    exchange, so the expand's epilogue writes in place; whole levels and
    stride-1 convs are unaffected."""
    dw = conv_mod.Conv2d(8, 8, 3, stride=2, groups=8)
    x = torch.zeros(1, 8, 16, 16)
    assert dw.explicit_pads(x) == (0, 1, 0, 1)
    assert conv_mod.Conv2d(8, 8, 5, stride=2, groups=8).explicit_pads(
        torch.zeros(1, 8, 15, 15)) == (2, 2, 2, 2)
    assert conv_mod.Conv2d(8, 8, 3, groups=8).explicit_pads(x) is None
    monkeypatch.setattr(conv_mod, "active_context", lambda: _Band())
    assert dw.explicit_pads(x) is None


def test_a_band_keeps_the_parents_route(monkeypatch):
    """Under a spatial context a banded map's halo comes from its
    neighbours, and its SE mean from an all-reduce: the depthwise op takes
    no band."""
    dw = conv_mod.Conv2d(16, 16, 3, groups=16)
    x = torch.zeros(1, 16, 8, 8).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert conv_mod.depthwise_folds(dw, x)
        monkeypatch.setattr(conv_mod, "active_context", lambda: _Band())
        assert not conv_mod.depthwise_folds(dw, x)


def test_the_route_takes_only_what_the_kernel_does():
    with torch.no_grad():
        x = torch.zeros(1, 16, 8, 8).contiguous(memory_format=torch.channels_last)
        assert conv_mod.depthwise_folds(conv_mod.Conv2d(16, 16, 5, 2, groups=16), x)
        assert not conv_mod.depthwise_folds(conv_mod.Conv2d(16, 16, 3, groups=16, bias=False), x)
        assert not conv_mod.depthwise_folds(conv_mod.Conv2d(16, 16, 7, groups=16), x)
        assert not conv_mod.depthwise_folds(conv_mod.Conv2d(16, 16, 3, groups=8), x)
        x12 = torch.zeros(1, 12, 8, 8).contiguous(memory_format=torch.channels_last)
        assert not conv_mod.depthwise_folds(conv_mod.Conv2d(12, 12, 3, groups=12), x12)
        assert not conv_mod.depthwise_folds(conv_mod.Conv2d(16, 16, 3, groups=16),
                                            x.to(torch.float64))


# --------------------------------------------------------------- on a card


@pytest.mark.cuda
@pytest.mark.parametrize("phi", PHIS)
def test_calls_per_folded_forward_on_the_gpu(phi):
    """The launch counters read one launch a call of each op, 4 of the
    epilogue's padded."""
    need_cuda()
    model, cfg = xf.folded_model(phi, torch.bfloat16)
    images = xf.nhwc_images(1, cfg.image_size, torch.bfloat16,
                            torch.Generator(device="cuda").manual_seed(1))
    before = xf.counts()
    calls, _ = xf.forward_calls(model, images)
    launched = {k: v - before[k] for k, v in xf.counts().items()}
    assert launched == {"conv_epilogue.launches": CALLS_PER_FORWARD["conv_epilogue"][phi],
                        "conv_epilogue.padded": 4,
                        "depthwise_conv.launches": CALLS_PER_FORWARD["depthwise_conv"][phi],
                        "bifpn_node.launches": CALLS_PER_FORWARD["bifpn_node"][phi]}
    assert all(len(calls[op]) == CALLS_PER_FORWARD[op][phi] for op in xf.OPS)


def _epilogue_twin(fn, x, bias, residual, silu, pads):
    """The model's epilogue call answered by the twin instead of the kernel."""
    y = ce.conv_epilogue_reference(x, bias, residual, silu, pads or (0, 0, 0, 0))
    return y if pads is not None else x.copy_(y)


@pytest.mark.cuda
@pytest.mark.parametrize("phi,batch", [(0, 16), (4, 4)])
def test_backbone_taps_against_the_twin_on_the_gpu(phi, batch):
    """The folded backbone's taps with the epilogue kernel and with its twin
    in its place, on the card: float32 equal bit for bit (the kernel equals
    each twin call); bf16 within 2% of each tap's largest magnitude (the
    twin rounds after each op, the kernel once: a one-ulp difference of an
    epilogue's output carries on through the later blocks)."""
    need_cuda()
    for dtype in (torch.float32, torch.bfloat16):
        model, cfg = xf.folded_model(phi, dtype)
        backbone = model.backbone
        x = xf.nhwc_images(batch, cfg.image_size, dtype,
                           torch.Generator(device="cuda").manual_seed(phi))
        with torch.inference_mode():
            got = backbone(x)
            with xf.hooked("conv_epilogue", _epilogue_twin):
                want = backbone(x)
        for g, w in zip(got, want):
            if dtype == torch.float32:
                assert torch.equal(g, w), (phi, (g - w).abs().max().item())
            else:
                err = (g.float() - w.float()).abs().max().item()
                assert err <= 0.02 * w.float().abs().max().item(), (phi, err)


def _node_twin(fn, kept, moved, up, weights):
    """The model's node call answered by the twin instead of the kernel."""
    return bn.bifpn_node_reference(kept, moved, up, weights)


@pytest.mark.cuda
@pytest.mark.parametrize("phi,batch", [(0, 16), (4, 4), ("7x", 2)])
def test_bifpn_levels_against_the_twin_on_the_gpu(phi, batch):
    """The folded BiFPN's levels with the node kernel and with its twin in
    its place, on the same float32 taps on the card: float32 within 1e-5 of
    each level's largest magnitude (the kernel sums as the twin does; the
    weights' sum may round apart). In bf16 (the taps rounded) the kernel
    rounds once where the twin rounds after each op, so each bf16 level of
    the kernel lies no further from the float32 levels than the twin's
    (within half as far again: a largest gap over a map wanders)."""
    need_cuda()
    levels, taps = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        model, cfg = xf.folded_model(phi, dtype)
        with torch.inference_mode():
            if taps is None:
                taps = list(model.backbone(xf.nhwc_images(
                    batch, cfg.image_size, dtype, torch.Generator(device="cuda").manual_seed(11))))
            inputs = [t.to(dtype) for t in taps]
            got = [t.float() for t in model.bifpn(inputs)]
            with xf.hooked("bifpn_node", _node_twin):
                want = [t.float() for t in model.bifpn(inputs)]
        levels[dtype] = got, want
        del model, inputs
        torch.cuda.empty_cache()
    f32, f32_twin = levels[torch.float32]
    for g, w in zip(f32, f32_twin):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item(), phi
    for g, w, ref in zip(*levels[torch.bfloat16], f32):
        gap, twin_gap = ((t - ref).abs().max().item() for t in (g, w))
        assert gap <= 1.5 * twin_gap, (phi, tuple(ref.shape), gap, twin_gap)


@pytest.fixture(scope="module")
def captured():
    """The D0 pipeline (bf16, BN folded) captured in a CUDA graph: the
    launch counters' change over its warm-up and capture, and its replay
    against the eager call."""
    need_cuda()
    from efficientdet_tpu_torch.utils.cuda_graph import GraphedCall

    model, cfg = et.build_efficientdet(0, dtype=torch.bfloat16, device="cuda")
    fused = et.fuse_for_inference(model)
    x = torch.randint(0, 256, (8, 512, 512, 3), dtype=torch.uint8, device="cuda")
    before = xf.counts()
    graph = GraphedCall(lambda t: et.predict_pipeline(fused, t), x,
                        pool=torch.cuda.graph_pool_handle())
    launched = {k: v - before[k] for k, v in xf.counts().items()}
    replay = [t.clone() for t in graph(x)]
    with torch.inference_mode():
        eager = et.predict_pipeline(fused, x)
    return launched, all(torch.equal(a, b) for a, b in zip(replay, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("op", xf.OPS)
def test_graph_capture_and_replay_on_the_gpu(op, captured):
    launched, replay_equals_eager = captured
    assert launched[f"{op}.launches"] > 0  # warm-up and capture went through the op
    assert replay_equals_eager


@pytest.mark.cuda
def test_edz_round_trip_on_the_gpu(tmp_path):
    need_cuda()
    from efficientdet_tpu_torch.export import export_predict, load_exported, save_exported

    model, cfg = et.build_efficientdet(0, dtype=torch.bfloat16, device="cuda")
    fused = et.fuse_for_inference(model)
    exported, _ = export_predict(fused, 4)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert sum("conv_epilogue" in t for t in targets) == 32
    assert sum("depthwise_conv_silu" in t for t in targets) == 16
    assert sum("bifpn_node" in t for t in targets) == 24
    path = str(tmp_path / "d0.edz")
    save_exported(path, fused, 4)
    predict, _ = load_exported(path, device="cuda")
    x = torch.randint(0, 256, (4, 512, 512, 3), dtype=torch.uint8, device="cuda")
    with torch.inference_mode():
        eager = et.predict_pipeline(fused, x)
    before = xf.counts()
    got = predict(x)
    launched = {k: v - before[k] for k, v in xf.counts().items()}
    # the loaded program's launches
    assert launched == {"conv_epilogue.launches": 32, "conv_epilogue.padded": 4,
                        "depthwise_conv.launches": 16, "bifpn_node.launches": 24}
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
