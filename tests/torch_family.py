"""One EfficientDet-D``phi`` at full width and depth through both packages, on the CPU.

Shared by ``tests/test_torch_family_*.py``: each of those files star-imports
the fixtures and tests defined here and names its phis in ``family_for`` (one
file a few phis, so that xdist's loadfile deals them to several workers).
The flax variables are drawn with numpy over the shapes of
``jax.eval_shape(model.init, ...)`` (no init compile) and bridged into the
port with ``load_flax_variables`` (D6/D7 at conv gain 1 with their BN
statistics calibrated first: ``CALIBRATED``). One jitted JAX call normalises a batch of
uint8 noise and returns the backbone taps, the BiFPN outputs, the
anchor-major head outputs and the detections the JAX ``predict_pipeline``
makes of them; the port runs the same stages eagerly and its own
``predict_pipeline``, unfused and BN-folded.

Tolerances: features and head outputs within 1e-4 of their scale; the NMS of
the same head outputs exact; ``predict_pipeline``: counts and classes exact,
scores within 1e-5, boxes within 1e-3 px of the JAX package's, or within the
phi's ``FLOAT32_BOX_PX`` where the JAX package's float64 witness shows
float32 rounding moving them further.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import efficientdet_tpu.ops.nms as jn
from efficientdet_tpu.anchors import anchors_for_shape
from efficientdet_tpu.configs import EvalConfig as JEvalConfig
from efficientdet_tpu.configs import ModelConfig as JModelConfig
from efficientdet_tpu.models.bifpn import BiFPN as JBiFPN
from efficientdet_tpu.models.detector import EfficientDet as JEfficientDet
from efficientdet_tpu.models.efficientnet import EfficientNet as JEfficientNet
from efficientdet_tpu.ops.preprocess import preprocess_batch_fixed as jpreprocess
import efficientdet_tpu_torch as et
import efficientdet_tpu_torch.ops.nms as tn
from efficientdet_tpu_torch.experiments.drawn_weights import calibrate_bn, calibration_images
from efficientdet_tpu_torch.ops.preprocess import preprocess_batch_fixed
from efficientdet_tpu_torch.utils.convert import load_flax_variables

# The slim detector's rules (tests/test_torch_detector.py): features and head
# outputs within TOL of each tensor's scale; the pipelines' boxes in pixels
# and scores absolute.
TOL = 1e-4
BOX_PX = 1e-3
SCORE = 1e-5
# Where float32 rounding alone moves a phi's pipeline boxes past BOX_PX, the
# fixed limit that holds them against the JAX package instead; each entry is
# justified by the JAX package's float64 witness recorded in ROADMAP Queue 3
# item 5 (``python tests/torch_family.py --witness 5``).
FLOAT32_BOX_PX = {5: 1e-2}
# D1 at its own 640 px (P7 5 x 5); D2-D7 at 384 px, the smallest multiple of
# 128 whose P7 is odd and above 1 (3 x 3).
SIZES = {1: 640, 2: 384, 3: 384, 4: 384, 5: 384, 6: 384, 7: 384}
NUM_CLASSES = 90
# The phis drawn at conv gain 1 with their BN statistics calibrated
# (calibrate_variables), as the entry-point tests draw them: drawn statistics
# do not normalise, and the unweighted BiFPN of D6/D7 sums two or three
# inputs at each of its layers, so that at the other phis' draw (gain 1.5,
# uncalibrated) their P3-P7 reach about 1e11, every kept score is 1.0 and
# the boxes are clipped, and a comparison sees nothing but ties; calibrated
# at gain 1.5 their class logits still reach 2e2 (every kept score 1.0).
CALIBRATED = (6, 7)
CALIBRATED_GAIN = 1.0


def draw_variables(shapes, rng: np.random.RandomState, gain: float = 1.5):
    """numpy draws over a tree of ShapeDtypeStructs: fan-in convs of
    variance ``gain`` / fan-in, BN variances and scales in [0.5, 1.5],
    fusion weights in [-0.3, 1.5] (some switched off by the relu), every
    other leaf N(0, 0.2)."""
    def draw(path, s):
        name = path[-1].key
        shape = tuple(s.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, (gain / fan_in) ** 0.5, shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "fusion_weights":
            return rng.uniform(-0.3, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


_STATS = {"mean": "running_mean", "var": "running_var"}


def calibrate_variables(cfg, variables, seed: int):
    """``variables`` with every BN's running statistics moved halfway to its
    statistics on four noise images (``experiments/drawn_weights.calibrate_bn``,
    run on the port) and written back into the flax tree, so that both
    packages hold the same values."""
    port = load_flax_variables(et.EfficientDet(port_config(cfg)), variables)
    state = calibrate_bn(port, calibration_images(cfg.image_size, seed)).state_dict()

    def stat(path, _):
        keys = [p.key for p in path]
        return state[".".join(keys[:-1] + [_STATS[keys[-1]]])].numpy().copy()

    return {**variables,
            "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


def port_config(cfg):
    fields = {f.name for f in dataclasses.fields(et.ModelConfig)} - {"anchor"}
    return et.ModelConfig(
        **{k: getattr(cfg, k) for k in fields},
        anchor=et.AnchorConfig(**dataclasses.asdict(cfg.anchor)),
    )


def _taps(mdl, method):
    return isinstance(mdl, (JEfficientNet, JBiFPN)) and method == "__call__"


def jax_run(phi: int, seed: int = 0):
    """The JAX side of one phi: config, variables, images and every output."""
    size = SIZES[phi]
    cfg = JModelConfig.for_phi(phi, num_classes=NUM_CLASSES, image_size=size)
    model = JEfficientDet(config=cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    rng = np.random.RandomState(seed)
    variables = draw_variables(shapes, rng, CALIBRATED_GAIN if phi in CALIBRATED else 1.5)
    images = rng.randint(0, 256, (1, size, size, 3)).astype(np.uint8)
    if phi in CALIBRATED:
        variables = calibrate_variables(cfg, jax.tree.map(np.asarray, variables), seed)
    anchors = jnp.asarray(anchors_for_shape((size, size), cfg.anchor))

    @jax.jit
    def forward(v, images):
        x = jpreprocess(images)
        (cls_out, box_out), state = model.apply(
            v, x, return_anchor_major_levels=True,
            capture_intermediates=_taps, mutable=["intermediates"],
        )
        cand = jn.anchor_major_candidates(anchors, box_out, cls_out, (size, size), JEvalConfig())
        dets = jn._pairs_and_suppress(*cand, JEvalConfig(), use_pallas=False)
        return cls_out[:2], box_out[0], state["intermediates"], dets

    (z, amax), zb, inter, dets = forward(variables, jnp.asarray(images))
    return dict(
        phi=phi, size=size, cfg=cfg, variables=variables, images=images,
        hws=tuple(h * w for h, w in cfg.feature_shapes()),
        z=np.asarray(z), amax=np.asarray(amax), zb=np.asarray(zb),
        taps=[np.asarray(t) for t in inter["backbone"]["__call__"][0]],
        fpn=[np.asarray(t) for t in inter["bifpn"]["__call__"][0]],
        dets=tuple(np.asarray(d) for d in dets),
    )


@torch.no_grad()
def port_run(ref):
    """The port's side on the same variables and images."""
    port = load_flax_variables(et.EfficientDet(port_config(ref["cfg"])), ref["variables"]).eval()
    images = torch.from_numpy(ref["images"])
    x = preprocess_batch_fixed(images).permute(0, 3, 1, 2)
    taps = port.backbone(x)
    fpn = port.bifpn(list(taps))
    (z, amax, hws), (zb, _) = port.class_net(fpn, True), port.box_net(fpn, True)
    unfused = et.predict_pipeline(port, images)
    folded = et.predict_pipeline(et.fuse_for_inference(port), images)
    return dict(
        taps=[t.permute(0, 2, 3, 1).numpy() for t in taps],
        fpn=[t.permute(0, 2, 3, 1).numpy() for t in fpn],
        z=z.numpy(), amax=amax.numpy(), zb=zb.numpy(), hws=hws,
        unfused=tuple(d.numpy() for d in unfused), folded=tuple(d.numpy() for d in folded),
    )


def nms_of_jax_heads(ref):
    """The port's NMS and the JAX one, op by op, on the JAX head outputs:
    (port detections, JAX detections). The jitted JAX program's own
    detections (``ref["dets"]``) may differ by an ulp of a box: XLA fuses
    the decode there."""
    hws, size = ref["hws"], (ref["size"],) * 2
    anchors = anchors_for_shape(size, ref["cfg"].anchor)
    z, amax, zb = (np.array(ref[k]) for k in ("z", "amax", "zb"))
    cand = jn.anchor_major_candidates(
        jnp.asarray(anchors), (jnp.asarray(zb), hws), (jnp.asarray(z), jnp.asarray(amax), hws),
        size, JEvalConfig(),
    )
    want = jn._pairs_and_suppress(*cand, JEvalConfig(), use_pallas=False)
    got = tn.batched_filter_from_anchor_major_levels(
        torch.from_numpy(anchors), (torch.from_numpy(zb), hws),
        (torch.from_numpy(z), torch.from_numpy(amax), hws), size, et.EvalConfig(),
    )
    return tuple(d.numpy() for d in got), tuple(np.asarray(d) for d in want)


def scaled_error(got, want) -> float:
    """max |got - want| over the tensor's largest |want| (its scale)."""
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check_within_scale(pairs):
    """Each (name, got, want) within TOL of want's scale (largest |want|)."""
    for name, g, w in pairs:
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * np.abs(w).max(), err_msg=name)


def head_pairs(got, ref):
    """The anchor-major head outputs, the port's padded rows cut to the JAX
    package's."""
    assert got["hws"] == ref["hws"]
    m = ref["z"].shape[1]
    return [("z", got["z"][:, :m], ref["z"]), ("amax", got["amax"], ref["amax"]),
            ("zb", got["zb"][:m], ref["zb"])]


def check_same_head_detections(got, want):
    """Detections from the same head outputs: exact (scores: the logistic's
    two ulps, ATen's against XLA's)."""
    for name, g, w in zip(("boxes", "scores", "classes", "num_valid"), got, want):
        if name == "scores":
            np.testing.assert_allclose(g, w, rtol=2.0 ** -22, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got[3].min()) > 0


def jax_float64_detections(ref):
    """The float64 witness, made by the JAX package alone: its detector
    with ``dtype`` float64 (under ``jax.enable_x64``) on the same variables
    and normalised images, its head outputs rounded once to float32 and sent
    through its own NMS, op by op. The JAX BN computes its affine in float32
    (``efficientdet_tpu/models/normalization.py``), so the witness rounds
    once a BN; :func:`port_float64_detections` is the cross-check. About 15
    minutes for D5 on the CPU: the script's, not the tests'."""
    with jax.enable_x64(True):
        model = JEfficientDet(config=ref["cfg"], dtype=jnp.float64)
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), ref["variables"])
        x = jpreprocess(jnp.asarray(ref["images"])).astype(jnp.float64)
        cls, box = jax.jit(lambda v, x: model.apply(v, x, return_anchor_major_levels=True))(
            variables, x)
        heads = {"z": np.asarray(cls[0], np.float32), "amax": np.asarray(cls[1], np.float32),
                 "zb": np.asarray(box[0], np.float32)}
    assert heads["z"].shape == ref["z"].shape and heads["zb"].shape == ref["zb"].shape
    return nms_of_jax_heads({**ref, **heads})[1]


def port_float64_detections(ref):
    """The port in float64 on the same variables and images, its head
    outputs rounded once to float32 and sent through the port's NMS
    ("concat" front end): the cross-check of the JAX witness."""
    port = et.EfficientDet(port_config(ref["cfg"]), dtype=torch.float64)
    port = load_flax_variables(port, ref["variables"]).double().eval()
    images = torch.from_numpy(ref["images"])
    size = (ref["size"],) * 2
    with torch.no_grad():
        cls, box = port(preprocess_batch_fixed(images, dtype=torch.float64))
    anchors = torch.from_numpy(anchors_for_shape(size, ref["cfg"].anchor))
    dets = tn.batched_filter_from_logits(anchors, box.float(), cls.float(), size, et.EvalConfig())
    return tuple(d.numpy() for d in dets)


def box_px(got, want) -> float:
    return float(np.abs(got[0] - want[0]).max())


def check_pipeline(got, want, phi):
    """predict_pipeline against the JAX one: counts and classes exact,
    scores within SCORE, boxes within BOX_PX pixels, or within the phi's
    FLOAT32_BOX_PX where the JAX package's float64 witness shows float32
    rounding moving them further (D5: P7 anchors of about 1,150 px turn a
    delta's rounding into thousandths of a pixel; ROADMAP Queue 3 item 5)."""
    _, scores, classes, n = got
    np.testing.assert_array_equal(n, want[3], err_msg="num_valid")
    np.testing.assert_array_equal(classes, want[2], err_msg="classes")
    np.testing.assert_allclose(scores, want[1], rtol=0, atol=SCORE, err_msg="scores")
    limit = FLOAT32_BOX_PX.get(phi, BOX_PX)
    assert box_px(got, want) <= limit, (phi, box_px(got, want), limit)


def report(phi: int, witness: bool = False) -> dict:
    """Every measured distance of one phi (ROADMAP records them); with
    ``witness``, also the distances from the JAX package's float64
    detections and from the port's."""
    ref = jax_run(phi)
    got = port_run(ref)
    rec = {
        "phi": phi, "size": ref["size"],
        "taps": max(scaled_error(g, w) for g, w in zip(got["taps"], ref["taps"])),
        "bifpn": max(scaled_error(g, w) for g, w in zip(got["fpn"], ref["fpn"])),
        "heads": max(scaled_error(g, w) for _, g, w in head_pairs(got, ref)),
        "num_valid": int(ref["dets"][3][0]),
        "box_px": {"unfused_vs_jax": box_px(got["unfused"], ref["dets"]),
                   "folded_vs_jax": box_px(got["folded"], ref["dets"])},
        "score": max(float(np.abs(got[k][1] - ref["dets"][1]).max()) for k in ("unfused", "folded")),
    }
    if witness:
        x, y = jax_float64_detections(ref), port_float64_detections(ref)
        rec["float64"] = {
            "same_counts_and_classes": all(
                np.array_equal(d[3], x[3]) and np.array_equal(d[2], x[2])
                for d in (ref["dets"], got["unfused"], got["folded"], y)),
            "jax_vs_jax_float64": box_px(ref["dets"], x),
            "unfused_vs_jax_float64": box_px(got["unfused"], x),
            "folded_vs_jax_float64": box_px(got["folded"], x),
            "port_float64_vs_jax_float64": box_px(y, x),
        }
    return rec


# The tests: ``from torch_family import *`` in a file that sets
# ``family = family_for([phi, ...])``.
__all__ = ["one_torch_thread", "family_for", "test_backbone_taps",
           "test_bifpn_outputs", "test_head_outputs",
           "test_detections_from_the_same_head_outputs", "test_predict_pipeline"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs six test processes on the host's
    cores, and a team of threads in each stalls its parallel regions."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def family_for(phis):
    """The module's ``family`` fixture: (JAX outputs, port outputs) of each
    phi in turn."""
    @pytest.fixture(scope="module", params=phis)
    def family(request):
        ref = jax_run(request.param)
        return ref, port_run(ref)
    return family


def test_backbone_taps(family):
    ref, got = family
    assert len(got["taps"]) == len(ref["taps"]) == 3
    check_within_scale([(f"C{i + 3}", g, w) for i, (g, w) in enumerate(zip(got["taps"], ref["taps"]))])


def test_bifpn_outputs(family):
    ref, got = family
    assert len(got["fpn"]) == len(ref["fpn"]) == 5
    check_within_scale([(f"P{i + 3}", g, w) for i, (g, w) in enumerate(zip(got["fpn"], ref["fpn"]))])


def test_head_outputs(family):
    ref, got = family
    check_within_scale(head_pairs(got, ref))


def test_detections_from_the_same_head_outputs(family):
    check_same_head_detections(*nms_of_jax_heads(family[0]))


@pytest.mark.parametrize("variant", ["unfused", "folded"])
def test_predict_pipeline(family, variant):
    ref, got = family
    check_pipeline(got[variant], ref["dets"], ref["phi"])


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_family.py [--witness] [phi ...]:
    # one JSON line a phi
    import json
    import sys

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)  # as the tests run
    args = sys.argv[1:]
    witness = "--witness" in args
    for p in [int(a) for a in args if a != "--witness"] or sorted(SIZES):
        print(json.dumps(report(p, witness)), flush=True)
