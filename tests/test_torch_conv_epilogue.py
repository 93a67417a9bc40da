"""The folded backbone's one-pass conv epilogue (ops/conv_epilogue.py).

On the CPU: the custom ops run the plain twin (ATen's add, silu, add and
pad), held here to that sequence written out, at every epilogue call a
folded B0 forward makes where the depthwise convs also end in one (as on a
spatial band; elsewhere ops/depthwise_conv.py finishes them) and at a B4
stage, in f32 and bf16; the folded
backbone's taps through the epilogue against the parent's path (the bias
inside the conv, then silu, add and ``F.pad``), which any call with grad
still takes; the epilogue's calls per forward (none off the folded path),
and the launch counters left alone by the twin; the spatial band's exception;
``opcheck`` of both ops.

The ``cuda``-marked tests run the kernel on a card (they skip here; there
``python -m pytest --noconftest -q -m cuda tests/test_torch_conv_epilogue.py``):
the kernel against its twin at every D0@512 batch-128 call and at D4's
stage-2 expand shape (float32 bit for bit; bf16 within one ulp of the twin
computed in float32 and rounded once, since the kernel rounds once where
the twin rounds after each op), the whole folded backbone's taps against
the same backbone run with the twin at D0 and D4 sizes, one CUDA-graph
capture and replay, one ``.edz`` export and load at D0, and the launch
counters per folded forward at D0 and D4.
"""

import contextlib
import dataclasses
import itertools

import pytest
import torch
import torch.nn.functional as F

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.experiments import conv_epilogue as xp
from efficientdet_tpu_torch.models import conv as conv_mod
from efficientdet_tpu_torch.models.detector import init_weights
from efficientdet_tpu_torch.models import efficientnet
from efficientdet_tpu_torch.models.efficientnet import EfficientNet
from efficientdet_tpu_torch.ops import conv_epilogue as ce
from efficientdet_tpu_torch.ops import depthwise_conv as dc

OPS = torch.ops.efficientdet_tpu_torch
SIZE = 128  # the CPU tests' image size


def _plain(x, bias, residual, silu, pads):
    """The folded model's ops before the kernel, written out."""
    y = x + bias.reshape(1, -1, 1, 1)
    if silu:
        y = F.silu(y)
    if residual is not None:
        y = y + residual
    if pads is not None:
        y = F.pad(y, (pads[2], pads[3], pads[0], pads[1]))
    return y


LAYOUTS = {"nchw": torch.contiguous_format, "nhwc": torch.channels_last}


def _inputs(shape, dtype, residual, seed, layout="nchw"):
    g = torch.Generator().manual_seed(seed)
    fmt = LAYOUTS[layout]
    x = (torch.randn(shape, generator=g) * 3).to(dtype).contiguous(memory_format=fmt)
    bias = torch.randn(shape[1], generator=g).to(dtype)
    res = (torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=fmt)
           if residual else None)
    return x, bias, res


def _random_folded_backbone(phi):
    """B``phi`` built folded (every conv with a bias), weights drawn at
    1 / fan-in."""
    backbone = EfficientNet(et.ModelConfig.for_phi(phi).backbone, fuse_bn=True).eval()
    g = torch.Generator().manual_seed(phi)
    with torch.no_grad():
        for name, p in backbone.named_parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 10
            p.copy_(torch.randn(p.shape, generator=g) * fan_in ** -0.5)
    return backbone


def _slim(image_size=SIZE):
    cfg = et.ModelConfig.for_phi(0, num_classes=4, image_size=image_size)
    return dataclasses.replace(cfg, bifpn_width=16, bifpn_depth=2, head_depth=2)


@contextlib.contextmanager
def _depthwise_on_the_epilogue():
    """A folded backbone's depthwise convs on ATen's conv and the epilogue,
    as a spatial band still runs them (elsewhere the one-pass depthwise
    kernel of ops/depthwise_conv.py takes them)."""
    fn = efficientnet.depthwise_folds
    efficientnet.depthwise_folds = lambda conv, x: False
    try:
        yield
    finally:
        efficientnet.depthwise_folds = fn


@pytest.fixture(scope="module")
def b0_calls():
    """Every epilogue call of a folded B0 forward at 128 px, on a
    channels-last batch as the detector's, its depthwise convs' included
    (:func:`_depthwise_on_the_epilogue`)."""
    images = xp.nhwc_images(1, SIZE, torch.float32, torch.Generator().manual_seed(0), "cpu")
    with _depthwise_on_the_epilogue():
        return xp.forward_calls(_random_folded_backbone(0), images)[0]


# shapes with a scalar tail (H x W and C odd)
EDGE_SHAPES = [(2, 3, 5, 7), (1, 5, 9, 9), (3, 1, 1, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("index", range(0, 48, 4))
def test_twin_is_the_plain_sequence_at_b0_calls(b0_calls, index, dtype):
    """Four of B0's calls a case: each with its own flags and with SiLU and
    the residual flipped, unpadded, with its own pad and the k3 and k5
    stride-2 pads, channels-last (the call's own layout) and contiguous."""
    for i in range(index, index + 4):
        call = b0_calls[i]
        assert call.channels_last or min(call.shape[1], call.shape[2] * call.shape[3]) == 1
        for silu, residual in {(call.silu, call.residual), (not call.silu, not call.residual)}:
            for pads in {call.pads, None, (0, 1, 0, 1), (1, 2, 1, 2)}:
                for layout in LAYOUTS:
                    x, bias, res = _inputs(call.shape, dtype, residual, i, layout)
                    want = _plain(x, bias, res, silu, pads)
                    got = ce.conv_epilogue(x.clone(memory_format=LAYOUTS[layout]), bias, res,
                                           silu, pads)
                    assert got.dtype == dtype and torch.equal(got, want), (i, silu, pads, layout)
                    assert got.is_contiguous(memory_format=LAYOUTS[layout])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", EDGE_SHAPES + [(1, 192, 32, 32)],
                         ids=["odd", "odd_c", "one_row", "b4_stage2_expand"])
def test_twin_at_edge_shapes_and_a_b4_stage(shape, dtype, layout):
    fmt = LAYOUTS[layout]
    for silu in (False, True):
        for residual in (False, True):
            for pads in (None, (0, 1, 0, 1), (1, 2, 1, 2), (1, 1, 1, 1)):
                x, bias, res = _inputs(shape, dtype, residual, sum(shape), layout)
                want = _plain(x, bias, res, silu, pads)
                xi = x.clone(memory_format=fmt)
                got = ce.conv_epilogue(xi, bias, res, silu, pads)
                assert torch.equal(got, want) and got.is_contiguous(memory_format=fmt)
                if pads is None:  # in place: the same storage
                    assert got.data_ptr() == xi.data_ptr()
                else:
                    assert got.shape == ce.padded_shape(x, pads)
                    assert torch.equal(xi, x)  # the input is left alone


def test_b0_calls_and_their_pads(b0_calls):
    calls = b0_calls
    assert len(calls) == 48
    # on the folded route the depthwise kernel takes B0's 16 depthwise convs
    images = xp.nhwc_images(1, SIZE, torch.float32, torch.Generator().manual_seed(0), "cpu")
    folded_route = xp.forward_calls(_random_folded_backbone(0), images)[0]
    assert len(folded_route) == 32 and sum(c.pads is not None for c in folded_route) == 4
    padded = [c for c in calls if c.pads is not None]
    # stages 2, 3, 4 and 6 open with a stride-2 depthwise conv: k3, k5, k3, k5
    assert [c.pads for c in padded] == [(0, 1, 0, 1), (1, 2, 1, 2), (0, 1, 0, 1), (1, 2, 1, 2)]
    assert [c.shape[1] for c in padded] == [96, 144, 240, 672]
    assert sum(c.residual for c in calls) == 9  # B0's residual blocks
    assert calls[0] == xp.Call((1, 32, SIZE // 2, SIZE // 2), True, False, None, True)  # the stem


@pytest.mark.parametrize("phi,layout", [(0, "nhwc"), (0, "nchw"), (4, "nhwc")])
def test_taps_equal_the_bias_in_conv_path(phi, layout):
    """A folded backbone's C3, C4, C5 on the CPU in f32: through the
    epilogue (grad off) and through the parent's ops (grad on: the bias
    inside the conv, silu, add, F.pad) agree to float32 rounding."""
    backbone = _random_folded_backbone(phi)
    g = torch.Generator().manual_seed(3)
    x = (xp.nhwc_images(2, SIZE, torch.float32, g, "cpu") if layout == "nhwc"
         else torch.randn(2, 3, SIZE, SIZE, generator=g))
    with torch.enable_grad():
        want = [t.detach() for t in backbone(x)]
    with torch.inference_mode():
        got = backbone(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * w.abs().max().item())


def _counters():
    return ce.conv_epilogue.launches, ce.conv_epilogue.padded


@pytest.mark.parametrize("phi,launches", [(0, 32), (4, 63)])
def test_counter_per_folded_forward(phi, launches):
    """A folded forward with grad off makes 32 epilogue calls at D0 and 63
    at D4 (the stem, the expands and the projects: the depthwise kernel
    finishes the depthwise convs itself), 4 of them padded; here they run
    the twin, which the launch counters do not count (they count the card's
    launches)."""
    backbone = _random_folded_backbone(phi)
    x = xp.nhwc_images(1, SIZE, torch.float32, torch.Generator().manual_seed(phi), "cpu")
    for mode in (torch.inference_mode, torch.no_grad):
        before = _counters()
        with xp.recording() as (calls, _), mode():
            backbone(x)
        assert (len(calls), sum(c.pads is not None for c in calls)) == (launches, 4)
        assert _counters() == before


def test_counter_reads_zero_off_the_folded_path():
    unfused = init_weights(et.EfficientDet(_slim()), 0).eval()
    folded = et.fuse_for_inference(unfused)
    x = torch.rand(1, SIZE, SIZE, 3)
    with xp.recording() as (calls, _), torch.inference_mode():
        unfused(x)  # no conv bias: BN after the conv
        assert calls == []
        et.predict_pipeline(folded, (x * 255).to(torch.uint8))  # the control
    assert (len(calls), sum(c.pads is not None for c in calls)) == (32, 4)
    with xp.recording() as (calls, _), torch.enable_grad():
        folded(x)  # a call with grad
    assert calls == []


def test_a_training_step_launches_none():
    model = init_weights(et.EfficientDet(_slim()), 0).train()
    tc = et.TrainConfig(batch_size=1, max_gt_boxes=4)
    state = et.create_train_state(model, tc, device="cpu")
    step = et.make_train_step(model, tc, device="cpu")
    batch = {"images": torch.rand(1, SIZE, SIZE, 3),
             "gt_boxes": torch.tensor([[[4.0, 4.0, 30.0, 40.0]] + [[0.0] * 4] * 3]),
             "gt_labels": torch.tensor([[1] + [-1] * 3], dtype=torch.int32)}
    with xp.recording() as (calls, _):
        state, metrics = step(state, batch)
    assert state.step == 1 and torch.isfinite(metrics["loss"] if "loss" in metrics
                                              else next(iter(metrics.values())))
    assert calls == []


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

    class Band:
        def banded(self, t):
            return True

    monkeypatch.setattr(conv_mod, "active_context", lambda: Band())
    assert dw.explicit_pads(x) is None


@pytest.mark.parametrize("residual", [False, True])
def test_opcheck(residual):
    x, bias, res = _inputs((2, 6, 5, 4), torch.float32, residual, seed=1)
    torch.library.opcheck(OPS.conv_epilogue_.default, (x, bias, res, True))
    torch.library.opcheck(OPS.conv_epilogue_padded.default, (x, bias, res, False, [1, 2, 0, 1]))


def test_fake_shapes():
    with torch.device("meta"):
        x, b = torch.empty(2, 6, 5, 4), torch.empty(6)
        assert OPS.conv_epilogue_padded(x, b, None, True, [1, 2, 0, 1]).shape == (2, 6, 8, 5)
        assert OPS.conv_epilogue_(x, b, None, True) is None


# --------------------------------------------------------------- on a card


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ with no CPU mode")
    torch.backends.cudnn.allow_tf32 = False


def _twin_hook(fn, x, bias, residual, silu, pads):
    """The model's epilogue call answered by the twin instead of the kernel."""
    y = ce.conv_epilogue_reference(x, bias, residual, silu, pads or (0, 0, 0, 0))
    return y if pads is not None else x.copy_(y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_against_twin_at_d0_b128_calls_on_the_gpu(dtype):
    _need_cuda()
    backbone, cfg = xp.folded_backbone(0, dtype)
    images = xp.nhwc_images(128, 512, dtype, torch.Generator(device="cuda").manual_seed(0))
    calls, worst = xp.forward_calls(backbone, images, check=True)
    assert len(calls) == 32 and sum(c.pads is not None for c in calls) == 4
    assert all(c.channels_last for c in calls)
    if dtype == torch.float32:
        assert worst["max_abs_err"] == 0.0, worst
    else:
        assert worst["ulps"] <= 1, worst


@pytest.mark.cuda
@pytest.mark.parametrize("phi,launches", [(0, 32), (4, 63)])
def test_counter_per_folded_forward_on_the_gpu(phi, launches):
    """The launch counters read one launch a call, 4 of them padded."""
    _need_cuda()
    backbone, cfg = xp.folded_backbone(phi, torch.bfloat16)
    images = xp.nhwc_images(1, cfg.image_size, torch.bfloat16,
                            torch.Generator(device="cuda").manual_seed(phi))
    before = _counters()
    calls, _ = xp.forward_calls(backbone, images)
    after = _counters()
    assert len(calls) == launches
    assert (after[0] - before[0], after[1] - before[1]) == (launches, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_against_twin_at_d4_stage2_expand_and_edges_on_the_gpu(dtype):
    """D4@1024 batch 64's stage-2 expand output (192 channels at 512 x 512,
    SiLU, channels-last as on the detector's path), written into the k3
    stride-2 pad and in place; and shapes
    with a scalar tail, every flag, both layouts, twice."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (64, 192, 512, 512)
    x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype).contiguous(
        memory_format=torch.channels_last)
    bias = torch.randn(shape[1], generator=gen, device="cuda").to(dtype)
    for pads in ((0, 1, 0, 1), None):
        x0 = x.clone(memory_format=torch.channels_last) if pads is None else x
        got = ce.conv_epilogue(x0, bias, None, True, pads)
        r = xp.compare(got, x, bias, None, True, pads)
        assert r.get("max_abs_err", 0.0) == 0.0 and r.get("ulps", 0) <= 1, (pads, r)
        del x0, got
    del x
    for shape in EDGE_SHAPES + [(2, 16, 9, 11), (2, 24, 8, 8)]:  # C a multiple of 8
        for silu, residual, pads, layout in itertools.product(
                (False, True), (False, True), (None, (0, 1, 0, 1), (1, 2, 1, 2)), LAYOUTS):
            x, bias, res = (None if t is None else t.cuda().to(dtype)
                            for t in _inputs(shape, torch.float32, residual, sum(shape), layout))
            fmt = LAYOUTS[layout]
            got = ce.conv_epilogue(x.clone(memory_format=fmt), bias, res, silu, pads)
            again = ce.conv_epilogue(x.clone(memory_format=fmt), bias, res, silu, pads)
            assert torch.equal(got, again) and got.is_contiguous(memory_format=fmt)
            r = xp.compare(got, x, bias, res, silu, pads)
            assert r.get("max_abs_err", 0.0) == 0.0 and r.get("ulps", 0) <= 1, (shape, layout, r)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_past_2_to_32_elements_on_the_gpu(layout):
    """More than 2^32 output elements (bf16, 8.6 GB): the kernel's 64-bit
    index walk, unpadded and into a k5 pad, against the twin."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = (16, 64, 2048, 2049)
    assert shape[0] * shape[1] * shape[2] * shape[3] > 2 ** 32
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16).contiguous(
        memory_format=LAYOUTS[layout])
    bias = torch.randn(shape[1], generator=gen, device="cuda").to(torch.bfloat16)
    for pads in ((1, 2, 1, 2), None):
        x0 = x if pads is not None else x.clone(memory_format=LAYOUTS[layout])
        got = ce.conv_epilogue(x0, bias, None, True, pads)
        r = xp.compare(got, x, bias, None, True, pads, chunk=2)
        assert r["ulps"] <= 1, (pads, r)
        del x0, got


@pytest.mark.cuda
@pytest.mark.parametrize("phi,batch", [(0, 16), (4, 4)])
def test_backbone_taps_against_the_twin_on_the_gpu(phi, batch):
    """The folded backbone's taps with the kernel and with the twin in its
    place, on the card: float32 equal bit for bit (the kernel equals each
    twin call); bf16 within 2% of each tap's largest magnitude (the twin
    rounds after each op, the kernel once: a one-ulp difference of an
    epilogue's output carries on through the later blocks)."""
    _need_cuda()
    for dtype in (torch.float32, torch.bfloat16):
        backbone, cfg = xp.folded_backbone(phi, dtype)
        x = xp.nhwc_images(batch, cfg.image_size, dtype,
                           torch.Generator(device="cuda").manual_seed(phi))
        with torch.inference_mode():
            got = backbone(x)
            with xp._wrapped(_twin_hook):
                want = backbone(x)
        for g, w in zip(got, want):
            if dtype == torch.float32:
                assert torch.equal(g, w), (phi, (g - w).abs().max().item())
            else:
                err = (g.float() - w.float()).abs().max().item()
                assert err <= 0.02 * w.float().abs().max().item(), (phi, err)


@pytest.mark.cuda
def test_graph_capture_and_replay_on_the_gpu():
    _need_cuda()
    from efficientdet_tpu_torch.utils.cuda_graph import GraphedCall

    model, cfg = et.build_efficientdet(0, dtype=torch.bfloat16, device="cuda")
    fused = et.fuse_for_inference(model)
    x = torch.randint(0, 256, (8, 512, 512, 3), dtype=torch.uint8, device="cuda")
    before = ce.conv_epilogue.launches
    graph = GraphedCall(lambda t: et.predict_pipeline(fused, t), x,
                        pool=torch.cuda.graph_pool_handle())
    assert ce.conv_epilogue.launches > before  # warm-up and capture went through the op
    replay = [t.clone() for t in graph(x)]
    with torch.inference_mode():
        eager = et.predict_pipeline(fused, x)
    assert all(torch.equal(a, b) for a, b in zip(replay, eager))


@pytest.mark.cuda
def test_edz_round_trip_on_the_gpu(tmp_path):
    _need_cuda()
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
    before, dw = _counters(), dc.depthwise_conv.launches
    got = predict(x)
    after = _counters()
    assert (after[0] - before[0], after[1] - before[1]) == (32, 4)  # the loaded program's launches
    assert dc.depthwise_conv.launches - dw == 16
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
