"""The port's single-image path against the JAX package's, on the CPU.

``preprocess_image``, ``letterbox_hostside``, the spec NMS
(``filter_detections``), ``filter_detections_from_logits``, the refusal
of an unknown front end and the ``Predictor`` (with its cache bound,
checkpoint round trip and CLI). Inputs are made with numpy from a seed; the
model is a tiny D0 (BiFPN and heads at width 16, depth 1, 128 px) whose
weights are drawn with numpy and bridged into the port by
``utils/convert.from_flax_variables``.
"""

import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import efficientdet_tpu.ops.nms as jn
from efficientdet_tpu.anchors import anchors_for_shape
from efficientdet_tpu.configs import EvalConfig as JEvalConfig
from efficientdet_tpu.configs import ModelConfig as JModelConfig
from efficientdet_tpu.data.common import letterbox_hostside as j_letterbox
from efficientdet_tpu.models.detector import EfficientDet as JEfficientDet
from efficientdet_tpu.ops.preprocess import preprocess_image as j_preprocess
from efficientdet_tpu.predict import Predictor as JPredictor
import efficientdet_tpu_torch as et
import efficientdet_tpu_torch.ops.nms as tn
from efficientdet_tpu_torch.data.common import letterbox_hostside
from efficientdet_tpu_torch.predict import MAX_CACHED_SHAPES, Predictor, main
from efficientdet_tpu_torch.utils.checkpoint import save_params
from efficientdet_tpu_torch.utils.convert import from_flax_variables

SIZE = 128


def _tiny_config(num_classes):
    return dataclasses.replace(
        JModelConfig.for_phi(0, num_classes=num_classes, image_size=SIZE),
        bifpn_width=16, bifpn_depth=1, head_depth=1,
    )


def _port_config(cfg):
    fields = {f.name for f in dataclasses.fields(et.ModelConfig)} - {"anchor"}
    return et.ModelConfig(**{k: getattr(cfg, k) for k in fields})


def _draw_variables(model, rng):
    """Every leaf drawn with numpy (shapes from eval_shape: no init compile).

    Convs fan-in normal, BN statistics away from the identity, class-head
    final bias near the prior so that some scores pass the threshold and
    some do not."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))

    def draw(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        name, shape = keys[-1], leaf.shape
        if name == "kernel":
            return rng.normal(0, (1.5 / int(np.prod(shape[:-1]))) ** 0.5, shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "fusion_weights":
            return rng.uniform(-0.3, 1.5, shape).astype(np.float32)
        if name == "bias" and "class_net" in keys and "final" in keys:
            return rng.normal(-10.5, 0.5, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, config, numpy variables, port model) at 6 classes."""
    cfg = _tiny_config(6)
    model = JEfficientDet(config=cfg)
    variables = _draw_variables(model, np.random.RandomState(0))
    port = et.EfficientDet(_port_config(cfg))
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return model, cfg, variables, port.eval()


def _image(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


# -- preprocessing -----------------------------------------------------------

@pytest.mark.parametrize("hw", [(480, 640), (100, 200), (300, 200), (60, 90), (64, 64),
                                (256, 256), (128, 128), (127, 64)])
def test_preprocess_image_matches_jax(hw):
    """Shrinking (antialiased), enlarging (plain bilinear), square and not:
    within 1e-4 after normalisation (float32 resamples in another order),
    the scale exactly."""
    img = _image(sum(hw), *hw)
    want, want_scale = j_preprocess(jnp.asarray(img), SIZE)
    got, scale = et.preprocess_image(torch.from_numpy(img), SIZE)
    assert got.shape == (SIZE, SIZE, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert scale.dtype == torch.float32 and scale.shape == ()
    assert float(scale) == float(want_scale)


@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (1080, 1920), (300, 200), (90, 128)])
def test_letterbox_hostside_matches_cv2(hw):
    """Torch bilinear, rounded, against the JAX package's cv2 INTER_LINEAR:
    within one grey level (cv2 sums in 11-bit fixed point); the padding and
    the scale exactly."""
    img = _image(7, *hw)
    want, want_scale = j_letterbox(img, 512)
    got, scale = letterbox_hostside(img, 512)
    assert got.dtype == np.uint8 and got.shape == (512, 512, 3)
    assert scale == want_scale
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got[want.sum(-1) == 0].sum() <= 3 * want[want.sum(-1) == 0].size)
    nh, nw = round(hw[0] * scale), round(hw[1] * scale)
    assert not got[nh:].any() and not got[:, nw:].any()


def test_letterbox_hostside_takes_uint8_rgb_only():
    with pytest.raises(TypeError, match="uint8"):
        letterbox_hostside(np.zeros((8, 8, 3), np.float32), 64)
    with pytest.raises(TypeError, match="uint8"):
        letterbox_hostside(np.zeros((8, 8), np.uint8), 64)


# -- NMS: the spec, the single-image path, the front ends ---------------------

def _boxes_scores(seed, b, a, c):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 100, (b, a, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (b, a, 2))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, a, c)).astype(np.float32) ** 4
    return boxes, scores


@pytest.mark.parametrize("seed,a,c,thr,top_k,max_det", [(0, 300, 4, 0.01, 1000, 400),
                                                       (1, 500, 3, 0.3, 200, 50),
                                                       (2, 120, 7, 0.9, 64, 50)])
def test_filter_detections_matches_jax(seed, a, c, thr, top_k, max_det):
    """The readable spec, one image and batched: exactly the JAX package's."""
    boxes, scores = _boxes_scores(seed, 2, a, c)
    ec = et.EvalConfig(score_threshold=thr, pre_nms_top_k=top_k, max_detections=max_det)
    want = jn.batched_filter_detections(jnp.asarray(boxes), jnp.asarray(scores), JEvalConfig(
        score_threshold=thr, pre_nms_top_k=top_k, max_detections=max_det))
    got = tn.batched_filter_detections(torch.from_numpy(boxes), torch.from_numpy(scores), ec)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = tn.filter_detections(torch.from_numpy(boxes[1]), torch.from_numpy(scores[1]),
                               thr, 0.5, max_det, top_k)
    for g, w in zip(one, got):
        np.testing.assert_array_equal(g.numpy(), w[1].numpy())
    assert (got[3] > 0).all()


def _logits(seed, a, c, spread=3.0):
    rng = np.random.RandomState(seed)
    deltas = rng.normal(0, 0.5, (a, 4)).astype(np.float32)
    logits = rng.normal(-3.0, spread, (a, c)).astype(np.float32)
    return deltas, logits


@pytest.mark.parametrize("num_classes,score_threshold", [(6, 0.01), (20, 0.3)])
def test_filter_detections_from_logits_matches_jax(num_classes, score_threshold):
    """Single image, selection in logit space, parity-exact preset: boxes,
    classes and counts exactly; scores to 2e-7 (torch.sigmoid and
    jax.nn.sigmoid differ by up to two float32 ulps, ROADMAP Queue 3)."""
    anchors = anchors_for_shape((SIZE, SIZE))
    deltas, logits = _logits(num_classes, anchors.shape[0], num_classes)
    want = jn.filter_detections_from_logits(
        jnp.asarray(anchors), jnp.asarray(deltas), jnp.asarray(logits), (SIZE, SIZE),
        score_threshold=score_threshold)
    got = tn.filter_detections_from_logits(
        torch.from_numpy(anchors), torch.from_numpy(deltas), torch.from_numpy(logits), (SIZE, SIZE),
        score_threshold=score_threshold)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3]) > 0
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=2e-7)


def test_predict_pipeline_refuses_an_unknown_front_end(tiny):
    """Two front ends, ``"anchor_major"`` and ``"concat"``; any other name
    is refused before the model runs."""
    *_, port = tiny
    images = torch.zeros((1, SIZE, SIZE, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown front_end 'pixel_gather'"):
        et.predict_pipeline(port, images, front_end="pixel_gather")


# -- the Predictor -----------------------------------------------------------

def _port_predictor(tiny, **kw):
    """A CPU Predictor carrying the tiny bridged model (the constructor
    builds phi 0's widths; the tiny model replaces it, as the JAX side's)."""
    _, cfg, _, port = tiny
    p = Predictor(phi=0, num_classes=cfg.num_classes, image_size=SIZE, device="cpu", **kw)
    p.model, p.config = port, _port_config(cfg)
    return p


@pytest.mark.parametrize("hw", [(90, 140), (200, 150)])
def test_predictor_matches_jax(tiny, hw):
    """One source image through the whole path, against the JAX package's
    Predictor on the same weights: counts and classes exactly, boxes within
    1e-3 source pixels, scores within 1e-5 (float32 convs sum in another
    order on the two sides)."""
    model, cfg, variables, _ = tiny
    jp = JPredictor(phi=0, num_classes=cfg.num_classes, image_size=SIZE, variables=variables)
    jp.model, jp.config = model, cfg
    img = _image(hw[0], *hw)
    want = jp(img)
    got = _port_predictor(tiny)(img)
    assert 0 < len(got[0]) < 100
    assert len(got[0]) == len(want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    assert got[0].dtype == np.float32 and got[2].dtype == np.int32


def test_predictor_cache_is_bounded(tiny):
    """One runner per source shape, at most 8, the oldest evicted first;
    a cached shape reuses its runner; the eager call agrees exactly."""
    p = _port_predictor(tiny)
    shapes = [(60 + 10 * i, 80) for i in range(MAX_CACHED_SHAPES + 1)]
    first = p._compiled(*shapes[0])
    assert p._compiled(*shapes[0]) is first
    for hw in shapes[1:]:
        p._compiled(*hw)
    assert len(p._run_cache) == MAX_CACHED_SHAPES
    assert list(p._run_cache) == shapes[1:]
    img = _image(3, 70, 80)
    for got, want in zip(p(img), p.eager(img)):
        np.testing.assert_array_equal(got, want)


def test_checkpoint_round_trip(tmp_path):
    """save_params -> Predictor.from_checkpoint: the weights and the
    detections of the saved model, whatever the new one's seed."""
    kw = dict(phi=0, num_classes=4, image_size=SIZE, device="cpu")
    src = Predictor(seed=1, **kw)
    path = str(tmp_path / "params.pt")
    save_params(path, src.model.state_dict())
    back = Predictor.from_checkpoint(path, seed=2, **kw)
    for k, v in src.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    img = _image(5, 100, 120)
    for got, want in zip(back(img), src(img)):
        np.testing.assert_array_equal(got, want)
    bad = str(tmp_path / "bad.pt")
    save_params(bad, {k: v for k, v in src.model.state_dict().items() if "class_net" not in k})
    with pytest.raises(RuntimeError, match="Missing key"):
        Predictor.from_checkpoint(bad, **kw)


class _SharedBufferGraph:
    """A stand-in for a shape's GraphedCall on the card: one static input
    per shape and one set of outputs shared by every shape (the graphs of a
    pool), with a pause between the copy-in and the "replay", which writes
    the outputs from the static input."""

    def __init__(self, hw, outputs):
        self.static_input = torch.zeros(hw + (3,), dtype=torch.uint8)
        self.outputs = outputs

    def __call__(self, x):
        self.static_input.copy_(x)
        time.sleep(0.001)
        value = self.static_input.float().mean()
        for t in self.outputs[:3]:
            t.fill_(value)
        return self.outputs


def test_concurrent_callers_get_their_own_answers():
    """Threads sharing one Predictor at two source shapes, over runners that
    share their buffers as the card's graphs do: every caller gets the
    answer of its own image (one lock covers cache, copy-in, replay and
    copy-out)."""
    p = Predictor(phi=0, num_classes=4, image_size=SIZE, device="cpu")
    outputs = (torch.zeros(1, 4), torch.zeros(1), torch.zeros(1, dtype=torch.int32),
               torch.ones((), dtype=torch.int32))
    runners = {}

    def compiled(h, w):
        return runners.setdefault((h, w), _SharedBufferGraph((h, w), outputs))

    p._compiled = compiled
    shapes = [(24, 32), (32, 24)]
    errors, done = [], []

    def caller(k):
        img = np.full(shapes[k % 2] + (3,), 10 + k, np.uint8)
        for _ in range(25):
            boxes, scores, classes = p(img)
            if not (boxes == 10 + k).all() or not (classes == 10 + k).all():
                errors.append((k, float(boxes.ravel()[0])))
        done.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and sorted(done) == list(range(8))
    assert not errors, f"{len(errors)} answers of another caller's image, e.g. {errors[:3]}"
    assert sorted(runners) == sorted(shapes)


def test_predictor_rejects_bad_input():
    p = Predictor(phi=0, num_classes=4, image_size=SIZE, device="cpu")
    with pytest.raises(ValueError, match="RGB"):
        p(np.zeros((10, 10), np.uint8))
    with pytest.raises(ValueError, match="dtype"):
        Predictor(dtype="f16", device="cpu")


def test_cli_on_a_png(tmp_path, capsys):
    """The demo CLI: a PNG in, detections printed, the drawing written."""
    from PIL import Image

    src = str(tmp_path / "in.png")
    Image.fromarray(_image(9, 96, 160)).save(src)
    params = str(tmp_path / "params.pt")
    save_params(params, Predictor(phi=0, num_classes=3, device="cpu", seed=4).model.state_dict())
    out = str(tmp_path / "out.png")
    main(["--image", src, "--output", out, "--num-classes", "3", "--checkpoint", params,
          "--score-threshold", "0.0", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "100 detections >= 0.0" in text and f"wrote {out}" in text
    assert "class=" in text
    with Image.open(out) as im:
        assert im.size == (160, 96)
