"""The slim detector in the port against the JAX package's, on the CPU.

The ``slim_d0`` model (full B0, BiFPN and heads at width 16, depth 2,
128 px, 6 classes) gets weights and BN statistics drawn with numpy from a
seed, which both packages load (the port through utils/convert.py). One
jitted JAX forward gives the backbone taps, the BiFPN outputs and the
anchor-major head outputs. Conv sums run in another order on the two sides,
so features agree to rtol/atol 1e-4 of their scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import efficientdet_tpu.ops.nms as jn
from efficientdet_tpu.anchors import anchors_for_shape
from efficientdet_tpu.configs import EvalConfig as JEvalConfig
from efficientdet_tpu.models.bifpn import BiFPN as JBiFPN
from efficientdet_tpu.models.efficientnet import EfficientNet as JEfficientNet
from efficientdet_tpu.utils.fold_bn import fold_bn_variables
import efficientdet_tpu_torch as et
import efficientdet_tpu_torch.ops.nms as tn
from efficientdet_tpu_torch.utils.convert import load_flax_variables

TOL = 1e-4


def _randomize(variables, rng):
    def draw(path, v):
        name = path[-1].key
        shape = np.shape(v)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, (1.5 / fan_in) ** 0.5, shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "fusion_weights":
            return rng.uniform(-0.3, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, variables)


def _port_config(cfg):
    fields = {f.name for f in dataclasses.fields(et.ModelConfig)} - {"anchor"}
    return et.ModelConfig(**{k: getattr(cfg, k) for k in fields})


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def slim(slim_d0):
    model, cfg, variables = slim_d0
    rng = np.random.RandomState(0)
    variables = _randomize(jax.tree.map(np.asarray, variables), rng)
    images = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    x = ((images.astype(np.float32) / 255.0 - np.float32([0.485, 0.456, 0.406]))
         / np.float32([0.229, 0.224, 0.225])).astype(np.float32)

    def taps(mdl, method):
        return isinstance(mdl, (JEfficientNet, JBiFPN)) and method == "__call__"

    @jax.jit
    def forward(v, x):
        (cls_out, box_out), state = model.apply(
            v, x, return_anchor_major_levels=True,
            capture_intermediates=taps, mutable=["intermediates"],
        )
        return cls_out[:2], box_out[0], state["intermediates"]

    (z, amax), zb, inter = forward(variables, x)
    hws = tuple(h * w for h, w in cfg.feature_shapes())
    port = load_flax_variables(et.EfficientDet(_port_config(cfg)), variables).eval()
    return dict(
        cfg=cfg, variables=variables, images=images, x=x, port=port, hws=hws,
        z=np.array(z), amax=np.array(amax), zb=np.array(zb),
        taps=[np.asarray(t) for t in inter["backbone"]["__call__"][0]],
        fpn=[np.asarray(t) for t in inter["bifpn"]["__call__"][0]],
    )


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_backbone_taps(slim):
    with torch.no_grad():
        got = slim["port"].backbone(_nchw(slim["x"]))
    for g, w in zip(got, slim["taps"]):
        _close(g.permute(0, 2, 3, 1), w)


def test_bifpn_outputs(slim):
    with torch.no_grad():
        got = slim["port"].features(torch.from_numpy(slim["x"]))
    assert len(got) == 5
    for g, w in zip(got, slim["fpn"]):
        _close(g.permute(0, 2, 3, 1), w)


def _anchor_major(model, x):
    with torch.no_grad():
        (z, amax, hws), (zb, _) = model(torch.from_numpy(x), anchor_major=True)
    return z, amax, hws, zb


def test_head_outputs(slim):
    z, amax, hws, zb = _anchor_major(slim["port"], slim["x"])
    m = slim["z"].shape[1]
    assert hws == slim["hws"] and z.shape[1] % 512 == 0 and z.shape[1] >= m
    _close(z[:, :m], slim["z"])
    _close(amax, slim["amax"])
    _close(zb[:m], slim["zb"])


def test_concat_heads_match_anchor_major(slim):
    z, amax, hws, zb = _anchor_major(slim["port"], slim["x"])
    with torch.no_grad():
        cls, box = slim["port"](torch.from_numpy(slim["x"]))
    b, a = 2, slim["cfg"].num_anchors_per_cell
    off = row = 0
    for hw in hws:
        lvl = cls[:, off:off + hw * a].reshape(b, hw, a, -1).permute(2, 0, 1, 3)
        torch.testing.assert_close(lvl.reshape(a, b * hw, -1), z[:, row:row + b * hw], rtol=TOL, atol=TOL)
        lb = box[:, off:off + hw * a].reshape(b * hw, a * 4)
        torch.testing.assert_close(lb, zb[row:row + b * hw], rtol=TOL, atol=TOL)
        off += hw * a
        row += b * hw


@pytest.fixture(scope="module")
def fused(slim):
    return et.fuse_for_inference(slim["port"])


def test_fused_matches_unfused(slim, fused):
    assert not any("bn" in k.split(".")[-2] for k in fused.state_dict() if "." in k)
    z, amax, _, zb = _anchor_major(slim["port"], slim["x"])
    fz, famax, _, fzb = _anchor_major(fused, slim["x"])
    for g, w in ((fz, z), (famax, amax), (fzb, zb)):
        _close(g, w.numpy())


def test_jax_fold_bridged_matches_port_fold(slim, fused):
    jf = fold_bn_variables(slim["variables"], eps=slim["cfg"].bn_epsilon)
    bridged = et.EfficientDet(slim["port"].config, fuse_bn=True)
    load_flax_variables(bridged, jf)
    want = fused.state_dict()
    got = bridged.state_dict()
    assert set(got) == set(want)
    for k in want:  # the same float32 arithmetic on both sides
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7)
    fz, _, _, _ = _anchor_major(fused, slim["x"])
    bz, _, _, _ = _anchor_major(bridged.eval(), slim["x"])
    torch.testing.assert_close(bz, fz, rtol=1e-5, atol=1e-5)


def test_fused_bf16_stores_the_compute_dtype(slim, fused):
    cfg = slim["port"].config
    unfused = et.EfficientDet(cfg, torch.bfloat16)
    unfused.load_state_dict(slim["port"].state_dict())
    stored = et.fuse_for_inference(unfused)
    head_biases = {"class_net.net.final.pointwise.bias", "box_net.net.final.pointwise.bias"}
    for k, v in stored.state_dict().items():
        if k in head_biases:
            assert v.dtype == torch.float32, k
        elif k.endswith((".weight", ".bias")):
            assert v.dtype == torch.bfloat16, k
    # the same function as float32 weights cast at each call: equal outputs
    cast_per_call = et.EfficientDet(cfg, torch.bfloat16, fuse_bn=True)
    cast_per_call.load_state_dict(fused.state_dict())
    got = _anchor_major(stored, slim["x"])
    want = _anchor_major(cast_per_call.eval(), slim["x"])
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    anchors = stored.anchors(128, torch.device("cpu"))
    assert anchors is stored.anchors(128, torch.device("cpu"))
    np.testing.assert_array_equal(anchors.numpy(), anchors_for_shape((128, 128)))


@pytest.mark.parametrize("kw", [dict(), dict(per_anchor_top_c=2, nms_iou_threshold=0.3)])
def test_detections_from_the_same_head_outputs(slim, kw):
    hws = slim["hws"]
    anchors = anchors_for_shape((128, 128))
    cls_out = (slim["z"], slim["amax"], hws)
    box_out = (slim["zb"], hws)
    jc = jn.anchor_major_candidates(
        jnp.asarray(anchors), (jnp.asarray(box_out[0]), hws),
        (jnp.asarray(cls_out[0]), jnp.asarray(cls_out[1]), hws), (128, 128), JEvalConfig(**kw),
    )
    want = jn._pairs_and_suppress(*jc, JEvalConfig(**kw), use_pallas=False)
    got = tn.batched_filter_from_anchor_major_levels(
        torch.from_numpy(anchors), (torch.from_numpy(box_out[0]), hws),
        (torch.from_numpy(cls_out[0]), torch.from_numpy(cls_out[1]), hws),
        (128, 128), et.EvalConfig(**kw),
    )
    for name, g, w in zip(("boxes", "scores", "classes", "num_valid"), got, want):
        if name == "scores":  # ATen's and XLA's logistic differ by <= 2 ulps
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2.0 ** -22, atol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[3].min()) > 0


def test_predict_pipeline_on_cpu(slim, fused):
    images = torch.from_numpy(slim["images"])
    predict = et.make_predict_fn(fused)
    boxes, scores, classes, n = predict(images)
    assert boxes.shape == (2, 100, 4) and scores.shape == classes.shape == (2, 100)
    assert n.dtype == torch.int32 and n.shape == (2,)
    for i in range(2):
        k = int(n[i])
        assert 0 < k <= 100
        assert torch.all((scores[i, :k] > 0) & (scores[i, :k] <= 1))
        assert torch.all((classes[i, :k] >= 0) & (classes[i, :k] < 6))
        assert torch.all(scores[i, k:] == -1) and torch.all(classes[i, k:] == -1)
    concat = et.make_predict_fn(fused, front_end="concat")(images)
    for g, w in zip(concat, (boxes, scores, classes, n)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # the same function as the model's anchor-major outputs fed to the NMS
    x = torch.from_numpy(slim["x"])
    with torch.no_grad():
        cls_out, box_out = fused(x, anchor_major=True)
    anchors = torch.from_numpy(anchors_for_shape((128, 128)))
    direct = tn.batched_filter_from_anchor_major_levels(anchors, box_out, cls_out, (128, 128))
    torch.testing.assert_close(direct[3], n)
