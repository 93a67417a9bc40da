"""The folded backbone's one-pass depthwise conv (ops/depthwise_conv.py).

On the CPU: the custom op runs its plain twin (ATen's depthwise conv, the
conv epilogue's twin, a float32 sum of each band), held here to the sequence
the folded model ran before (``F.conv2d``, the epilogue twin, ``torch.mean``)
at every depthwise call of a folded B0 forward and at B4 and B7 calls cut
in height, width and batch, in float32 and bf16; edge shapes; the SE mean
from the sums against ``torch.mean``; a folded backbone's taps through the
op against the parent's route; the calls a forward makes (none off the
folded path) and the launch counter left alone by the twin; the plan's
tiles; ``opcheck`` and the fake.

The ``cuda``-marked tests run the kernel on a card (they skip here; there
``python -m pytest --noconftest -q -m cuda tests/test_torch_depthwise_conv.py``):
every depthwise call of a folded D0@512, D4@1024 and D7x@1536 forward
against the twin (``experiments/depthwise_conv.check``: float32 and bf16
within the stated bounds, bf16 within one ulp of the twin run in float32
and rounded once, as the conv epilogue's rule), D4's stage-2 depthwise conv
at batch 64 (an input of 2.43e9 elements), two runs equal bit for bit, the
launch counters per folded forward and one CUDA-graph capture and replay.
"""

import contextlib
import dataclasses

import pytest
import torch
import torch.nn.functional as F

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.experiments import conv_epilogue as xce
from efficientdet_tpu_torch.experiments import depthwise_conv as xd
from efficientdet_tpu_torch.models import conv as conv_mod
from efficientdet_tpu_torch.models import efficientnet
from efficientdet_tpu_torch.models.detector import init_weights
from efficientdet_tpu_torch.models.efficientnet import EfficientNet
from efficientdet_tpu_torch.ops import conv_epilogue as ce
from efficientdet_tpu_torch.ops import depthwise_conv as dc

OPS = torch.ops.efficientdet_tpu_torch
SIZE = 128  # the CPU tests' image size
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LAYOUTS = {"nhwc": torch.channels_last, "nchw": torch.contiguous_format}
U32 = 2.0 ** -24


def _plain(x, weight, bias, stride, pads):
    """The folded model's ops before the kernel: the conv without its bias
    (the pad inside it where symmetric, as ``same_conv``; else ``F.pad``),
    the epilogue's twin, and the SE's float32 mean."""
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


def _inputs(shape, k, dtype, seed, layout="nhwc"):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 2).to(dtype).contiguous(memory_format=LAYOUTS[layout])
    w = (torch.randn(shape[1], 1, k, k, generator=g) / k).to(dtype)
    b = torch.randn(shape[1], generator=g).to(dtype)
    return x, w, b


def _assert_matches_plain(x, w, b, stride, pads):
    y, sums = dc.depthwise_conv(x, w, b, stride, pads)
    want, mean = _plain(x, w, b, stride, pads)
    assert y.dtype == x.dtype and torch.equal(y, want)
    assert y.is_contiguous(memory_format=LAYOUTS["nhwc" if ce.channels_last(x) else "nchw"])
    n = dc.bands(y.shape[2], dc._plan_of(x, w, stride, pads)[0].th)
    assert sums.shape == (x.shape[0], n, x.shape[1]) and sums.dtype == torch.float32
    assert ((dc.se_mean(sums) - mean).abs() <= _mean_tol(want)).all()


def _random_folded_backbone(phi):
    """B``phi``'s backbone built folded (every conv with a bias), weights
    drawn at 1 / fan-in."""
    backbone = EfficientNet(et.ModelConfig.for_phi(phi).backbone, fuse_bn=True).eval()
    g = torch.Generator().manual_seed({0: 0, 4: 4, "7x": 7}[phi])
    with torch.no_grad():
        for _, p in backbone.named_parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 10
            p.copy_(torch.randn(p.shape, generator=g) * fan_in ** -0.5)
    return backbone


@contextlib.contextmanager
def _parent_route():
    """The depthwise convs on the parent's route: ATen's conv, the epilogue
    and ``torch.mean`` (the path a band still takes)."""
    fn = efficientnet.depthwise_folds
    efficientnet.depthwise_folds = lambda conv, x: False
    try:
        yield
    finally:
        efficientnet.depthwise_folds = fn


@pytest.fixture(scope="module")
def calls_by_phi():
    """Every depthwise call of a folded B0, B4 and B7 forward at 128 px on
    a channels-last batch of one, as the detector's."""
    out = {}
    for phi in (0, 4, "7x"):
        images = xce.nhwc_images(1, SIZE, torch.float32, torch.Generator().manual_seed(1), "cpu")
        out[phi] = xd.forward_calls(_random_folded_backbone(phi), images)[0]
    return out


# -------------------------------------------------------------- the twin


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phi", [0, 4, "7x"])
def test_twin_is_the_plain_sequence_at_each_call(calls_by_phi, phi, dtype):
    """Each depthwise call of the forward (B4 and B7: their calls at 128 px,
    the width, k and stride of each block kept), on inputs drawn at its
    shape: the twin's output equals ATen's sequence bit for bit, its sums
    give the SE mean within the stated tolerance."""
    for i, call in enumerate(calls_by_phi[phi]):
        assert call.channels_last
        x, w, b = _inputs(call.shape, call.k, DTYPES[dtype], i)
        _assert_matches_plain(x, w, b, call.stride, call.pads)


EDGES = [((2, 24, 9, 11), 3, 1, (1, 1, 1, 1)), ((2, 24, 10, 12), 3, 2, (0, 1, 0, 1)),
         ((3, 40, 13, 7), 5, 1, (2, 2, 2, 2)), ((2, 40, 12, 12), 5, 2, (1, 2, 1, 2)),
         ((1, 3840, 6, 6), 3, 1, (1, 1, 1, 1)), ((2, 3840, 9, 9), 5, 2, (0, 0, 0, 0)),
         ((2, 144, 17, 19), 3, 2, (0, 0, 0, 0)), ((1, 16, 1, 1), 3, 1, (1, 1, 1, 1)),
         ((2, 8, 5, 3), 5, 1, (2, 2, 2, 2))]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("edge", range(len(EDGES)),
                         ids=["k3s1_odd", "k3s2_pad01", "k5s1_odd", "k5s2_pad12", "c3840_k3",
                              "c3840_k5_prepadded", "c144_prepadded", "one_pixel", "c8_k5"])
def test_twin_at_edge_shapes(edge, dtype, layout):
    shape, k, stride, pads = EDGES[edge]
    x, w, b = _inputs(shape, k, DTYPES[dtype], edge, layout)
    _assert_matches_plain(x, w, b, stride, pads)


def test_se_mean_from_the_sums():
    """One band and many: the sums' shares add up to ``torch.mean`` within
    the stated tolerance, and a band's rows past the map's edge count
    nothing (a constant map's mean is the constant)."""
    for shape in [(2, 32, 5, 7), (1, 16, 40, 9), (3, 8, 64, 64)]:
        x, w, b = _inputs(shape, 3, torch.float32, sum(shape))
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


# ------------------------------------------------------- the model's route


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phi", [0, 4])
def test_taps_equal_the_parents_route(phi, dtype):
    """A folded backbone's C3, C4, C5 through the op against the parent's
    route (ATen's conv, the epilogue, ``torch.mean``): the outputs are the
    same ATen ops, the SE means differ in their sums' order, so float32
    taps agree to float32 rounding and bf16 taps to a bf16 ulp of the
    tap's scale."""
    backbone = _random_folded_backbone(phi).to(DTYPES[dtype])
    x = xce.nhwc_images(2, SIZE, DTYPES[dtype], torch.Generator().manual_seed(3), "cpu")
    with torch.inference_mode():
        got = backbone(x)
        with _parent_route():
            want = backbone(x)
    for g, w in zip(got, want):
        scale = w.float().abs().max().item()
        tol = 1e-5 if dtype == "f32" else 2 ** -7
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("phi,calls,epilogues", [(0, 16, 32), (4, 32, 63), ("7x", 55, 107)])
def test_calls_per_folded_forward(calls_by_phi, phi, calls, epilogues):
    """A folded forward with grad off makes one depthwise call a block (16 at
    D0, 32 at D4, 55 at D7x) and leaves the epilogue the stem, the expands
    and the projects (32, 63, 107; 4 of them padded); on the CPU they run
    the twins, which the launch counters do not count."""
    assert len(calls_by_phi[phi]) == calls
    backbone = _random_folded_backbone(phi)
    x = xce.nhwc_images(1, SIZE, torch.float32, torch.Generator().manual_seed(2), "cpu")
    before = dc.depthwise_conv.launches, ce.conv_epilogue.launches
    with xd.recording() as (dw, _), xce.recording() as (epi, _), torch.inference_mode():
        backbone(x)
    assert (len(dw), len(epi), sum(c.pads is not None for c in epi)) == (calls, epilogues, 4)
    assert (dc.depthwise_conv.launches, ce.conv_epilogue.launches) == before


def _slim():
    cfg = et.ModelConfig.for_phi(0, num_classes=4, image_size=SIZE)
    return dataclasses.replace(cfg, bifpn_width=16, bifpn_depth=2, head_depth=2)


def test_no_call_off_the_folded_path():
    """The unfused model and a call with grad keep ATen's depthwise conv;
    the folded pipeline takes the op, on an NCHW map too, whose layout
    every call's output keeps (the project conv's residual is in it)."""
    unfused = init_weights(et.EfficientDet(_slim()), 0).eval()
    folded = et.fuse_for_inference(unfused)
    x = torch.rand(1, SIZE, SIZE, 3)
    with xd.recording() as (calls, _), torch.inference_mode():
        unfused(x)
        assert calls == []
        et.predict_pipeline(folded, (x * 255).to(torch.uint8))  # the control
    assert len(calls) == 16
    with xd.recording() as (calls, _), torch.enable_grad():
        folded(x)
    assert calls == []
    with xd.recording() as (calls, _), torch.inference_mode():
        feats = folded.backbone(x.permute(0, 3, 1, 2).contiguous())  # NCHW
    assert len(calls) == 16 and not any(c.channels_last for c in calls)
    assert all(not ce.channels_last(f) and f.is_contiguous() for f in feats)


def test_a_training_step_makes_none():
    model = init_weights(et.EfficientDet(_slim()), 0).train()
    tc = et.TrainConfig(batch_size=1, max_gt_boxes=4)
    state = et.create_train_state(model, tc, device="cpu")
    step = et.make_train_step(model, tc, device="cpu")
    batch = {"images": torch.rand(1, SIZE, SIZE, 3),
             "gt_boxes": torch.tensor([[[4.0, 4.0, 30.0, 40.0]] + [[0.0] * 4] * 3]),
             "gt_labels": torch.tensor([[1] + [-1] * 3], dtype=torch.int32)}
    with xd.recording() as (calls, _):
        state, _ = step(state, batch)
    assert state.step == 1 and calls == []


def test_a_band_keeps_the_parents_route(monkeypatch):
    """Under a spatial context a banded map's halo comes from its
    neighbours, and its SE mean from an all-reduce: the op takes no band."""
    dw = conv_mod.Conv2d(16, 16, 3, groups=16)
    x = torch.zeros(1, 16, 8, 8).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert conv_mod.depthwise_folds(dw, x)

        class Band:
            def banded(self, t):
                return True

        monkeypatch.setattr(conv_mod, "active_context", lambda: Band())
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


# ----------------------------------------------------------------- the plan


@pytest.mark.parametrize("dtype", DTYPES)
def test_plans_at_every_call(calls_by_phi, dtype):
    """Every call's plan: a slice of whole 16-byte pieces dividing C, lanes
    within a warp, the kernel's rows a lane, bands of at most 64 rows,
    shared memory within an SM's."""
    esize = torch.empty((), dtype=DTYPES[dtype]).element_size()
    for phi, calls in calls_by_phi.items():
        for call in calls:
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


# ------------------------------------------------------- the op's contract


@pytest.mark.parametrize("stride,pads", [(1, [1, 1, 1, 1]), (2, [0, 1, 0, 1]), (2, [0, 0, 0, 0])])
def test_opcheck(stride, pads):
    x, w, b = _inputs((2, 16, 7, 6), 3, torch.float32, stride)
    torch.library.opcheck(OPS.depthwise_conv_silu.default, (x, w, b, stride, pads))


def test_fake_shapes():
    with torch.device("meta"):
        x = torch.empty(2, 16, 9, 9).contiguous(memory_format=torch.channels_last)
        y, sums = OPS.depthwise_conv_silu(x, torch.empty(16, 1, 5, 5), torch.empty(16), 2,
                                          [1, 2, 1, 2])
    assert y.shape == (2, 16, 4, 4) and y.is_contiguous(memory_format=torch.channels_last)
    assert sums.shape == (2, 1, 16) and sums.dtype == torch.float32


def test_the_launcher_refuses_what_the_kernel_does_not_take():
    x, w, b = _inputs((1, 16, 8, 8), 3, torch.float32, 0)
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


# --------------------------------------------------------------- on a card


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ with no CPU mode")
    torch.backends.cudnn.allow_tf32 = False


def _assert_within_rules(worst, dtype):
    assert worst["excess"] <= 1.0 and worst["sums_excess"] <= 1.0, worst
    if dtype == torch.bfloat16:
        assert worst["ulps"] <= 1, worst


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phi,batch", [(0, 16), (4, 4), ("7x", 2)])
def test_kernel_against_twin_at_every_call_on_the_gpu(phi, batch, dtype):
    """Every depthwise call of a folded forward of drawn weights, on the
    call's own inputs, and its launches: one a call."""
    _need_cuda()
    backbone, cfg = xce.folded_backbone(phi, DTYPES[dtype])
    images = xce.nhwc_images(batch, cfg.image_size, DTYPES[dtype],
                             torch.Generator(device="cuda").manual_seed(7))
    before = dc.depthwise_conv.launches
    calls, worst = xd.forward_calls(backbone, images, check_calls=True)
    assert dc.depthwise_conv.launches - before == len(calls) == {0: 16, 4: 32, "7x": 55}[phi]
    _assert_within_rules(worst, DTYPES[dtype])


@pytest.mark.cuda
def test_shared_memory_mirror_on_the_gpu(calls_by_phi):
    """``smem_bytes``, which the plan sizes its tiles by, against the
    kernel's own count at every call's plan, in both dtypes."""
    _need_cuda()
    import ctypes

    from efficientdet_tpu_torch.ops import cuda_build

    fn = cuda_build.load("depthwise_conv").depthwise_conv_smem_bytes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5
    for calls in calls_by_phi.values():
        for call in calls:
            for esize in (2, 4):
                ho, wo = dc.out_size(*call.shape[2:], call.k, call.stride, call.pads)
                p = dc.plan(call.shape[1], ho, wo, call.k, call.stride, esize)
                want = dc.smem_bytes(call.k, call.stride, p.cs, p.cg, esize)
                assert fn(call.k, call.stride, p.cs, p.cg, esize) == want, (call, p)


@pytest.mark.cuda
def test_kernel_past_2_to_31_elements_on_the_gpu():
    """D4@1024 batch 64's stage-2 depthwise conv: 144 channels, k3 stride 2
    over the expand's padded 513 x 513 maps, 2.43e9 input elements."""
    _need_cuda()
    call = xd.Call((64, 144, 513, 513), 3, 2, (0, 0, 0, 0), True)
    assert 64 * 144 * 513 * 513 > 2 ** 31
    x, w, b = xd._inputs(call, torch.bfloat16, torch.Generator(device="cuda").manual_seed(8))
    y, sums = dc.depthwise_conv(x, w, b, 2, call.pads)
    again = dc.depthwise_conv(x, w, b, 2, call.pads)
    assert torch.equal(y, again[0]) and torch.equal(sums, again[1])
    _assert_within_rules(xd.check(y, sums, x, w, b, 2, call.pads, chunk=4), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_at_edge_shapes_on_the_gpu(dtype):
    _need_cuda()
    for shape, k, stride, pads in EDGES:
        x, w, b = (t.cuda() for t in _inputs(shape, k, DTYPES[dtype], sum(shape)))
        y, sums = dc.depthwise_conv(x, w, b, stride, pads)
        again = dc.depthwise_conv(x, w, b, stride, pads)
        assert torch.equal(y, again[0]) and torch.equal(sums, again[1])
        worst = xd.check(y, sums, x, w, b, stride, pads)
        assert worst["excess"] <= 1.0 and worst["sums_excess"] <= 1.0, (shape, worst)


@pytest.mark.cuda
def test_graph_capture_and_replay_on_the_gpu():
    _need_cuda()
    from efficientdet_tpu_torch.utils.cuda_graph import GraphedCall

    model, cfg = et.build_efficientdet(0, dtype=torch.bfloat16, device="cuda")
    fused = et.fuse_for_inference(model)
    x = torch.randint(0, 256, (8, 512, 512, 3), dtype=torch.uint8, device="cuda")
    before = dc.depthwise_conv.launches
    graph = GraphedCall(lambda t: et.predict_pipeline(fused, t), x,
                        pool=torch.cuda.graph_pool_handle())
    assert dc.depthwise_conv.launches > before  # warm-up and capture went through the op
    replay = [t.clone() for t in graph(x)]
    with torch.inference_mode():
        eager = et.predict_pipeline(fused, x)
    assert all(torch.equal(a, b) for a, b in zip(replay, eager))
