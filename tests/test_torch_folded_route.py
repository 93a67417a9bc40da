"""The folded backbone's route through its custom ops.

Where both ops share a test, each case names its op
(``tests/torch_folded.py``). On the CPU: each op's calls per folded forward
with grad off at D0, D4 and D7x, none off the folded path (the unfused
model, grad on, a training step), the launch counters left alone by the
twins; the folded taps against the parent's routes; a spatial band's
exceptions. The ``cuda``-marked tests (``python -m pytest --noconftest -q
-m cuda tests/test_torch_folded_route.py`` on a card): the counters per
forward, the taps with the epilogue kernel against its twin, a CUDA graph
and an ``.edz`` round trip.
"""

import copy
import functools
from contextlib import nullcontext

import pytest
import torch

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.experiments import folded_ops as xf
from efficientdet_tpu_torch.models import conv as conv_mod
from efficientdet_tpu_torch.models.detector import init_weights
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
    random_folded_backbone,
    slim,
)


# ------------------------------------------------------- calls per forward


@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("op", xf.OPS)
def test_calls_per_folded_forward(op, phi):
    """A folded forward with grad off makes one depthwise call a block (16
    at D0, 32 at D4, 55 at D7x) and leaves the epilogue the stem, the
    expands and the projects (32, 63, 107; 4 of them padded), under
    ``inference_mode`` and ``no_grad`` alike (D0, D4); on the CPU they run
    the twins, which the launch counters do not count (they count the
    card's launches)."""
    for grad_off in ("inference_mode", "no_grad") if phi != "7x" else ("inference_mode",):
        calls, counted = folded_calls(phi, grad_off)
        assert len(calls[op]) == CALLS_PER_FORWARD[op][phi], grad_off
        if op == "conv_epilogue":
            assert sum(c.pads is not None for c in calls[op]) == 4
        assert not any(counted.values()), counted


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
        feats = folded.backbone(x.permute(0, 3, 1, 2).contiguous())
    return steps, feats


@pytest.mark.parametrize("op", xf.OPS)
def test_no_call_off_the_folded_path(op, off_path):
    """The unfused model and a call with grad make no call of either op;
    the folded pipeline makes every call of a forward, and so does the
    folded backbone on an NCHW map, whose layout every call's output keeps
    (the project conv's residual is in it)."""
    steps, feats = off_path
    assert steps["unfused"][op] == [] and steps["grad"][op] == []
    for step in ("pipeline", "nchw"):
        assert len(steps[step][op]) == CALLS_PER_FORWARD[op][0], step
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
    backbone = random_folded_backbone(phi)
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
    backbone, cfg = xf.folded_backbone(phi, torch.bfloat16)
    images = xf.nhwc_images(1, cfg.image_size, torch.bfloat16,
                            torch.Generator(device="cuda").manual_seed(1))
    before = xf.counts()
    calls, _ = xf.forward_calls(backbone, images)
    launched = {k: v - before[k] for k, v in xf.counts().items()}
    assert launched == {"conv_epilogue.launches": CALLS_PER_FORWARD["conv_epilogue"][phi],
                        "conv_epilogue.padded": 4,
                        "depthwise_conv.launches": CALLS_PER_FORWARD["depthwise_conv"][phi]}
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
        backbone, cfg = xf.folded_backbone(phi, dtype)
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
                        "depthwise_conv.launches": 16}
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
