"""The entry points above D0 (Predictor, .edz artifact, server, sharded predict) against the JAX package, on the CPU.

Shared by ``tests/test_torch_entry_d4.py`` and ``test_torch_entry_d7.py``:
each star-imports the fixtures and tests defined here and names its phi in
``entry_for``. D4 (weighted BiFPN 224 x 7, B4, head depth 4) and D7
(unweighted BiFPN 384 x 8, B6, head depth 5, anchor scale 5) together reach
every branch above D0. Both at 384 px (the family tests' size, P7 3 x 3),
90 classes.

Weights: flax variables drawn with numpy over ``jax.eval_shape`` (no init
compile; ``torch_family.draw_variables`` at conv gain 1) and bridged into
the port by ``utils/convert.py``; then every BN's running statistics moved
halfway to its statistics on four noise images
(``experiments/drawn_weights.calibrate_bn``, on the port) and written back
into the flax tree, so both sides hold the same values. Drawn statistics
alone do not normalise, and D7's unweighted fusion sums two or three inputs
at each of 8 layers: at the family's gain 1.5 its P3-P7 reach 1e11 and
every kept score is 1.0, so a comparison there sees ties and clipped boxes
only. Calibrated, both phis' class logits stay below -3 (kept scores
0.03-0.04) and their box deltas below 1.

Tolerances: the Predictor's rule (the JAX ``Predictor`` against the port's:
counts and classes exact, boxes within 1e-3 source pixels, scores within
1e-5); the export rule (the port's artifact against the JAX package's:
counts and classes exact, boxes within 1e-3 px, scores within
EXPORT_SCORE_REL relative: the slim D0's 2^-22, the logistic's two ulps on
logits that agree, does not hold at depth, where the logits themselves
differ in their last bits; ``python tests/torch_entry.py 4 7``, the JAX
package's float64 witness, puts its own float32 artifact's scores 1.66e-7
(D4) and 2.46e-7 (D7) from float64 and the port's 2.48e-7 and 2.42e-7, the
two 2.48e-7 and 3.22e-7 apart, so 2^-21 = 4.77e-7, their sum's bound); in
both, detections whose scores lie within the score tolerance
of each other may come in either order (:func:`check_detections`). The port
against its own ``predict_pipeline``: bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdet_tpu import export as jexport
from efficientdet_tpu.configs import ModelConfig as JModelConfig
from efficientdet_tpu.models.detector import EfficientDet as JEfficientDet
from efficientdet_tpu.predict import Predictor as JPredictor
import efficientdet_tpu_torch as et
from efficientdet_tpu_torch import export
from efficientdet_tpu_torch.data.common import letterbox_hostside
from efficientdet_tpu_torch.ops.preprocess import preprocess_image
from efficientdet_tpu_torch.predict import Predictor
from efficientdet_tpu_torch.utils.convert import from_flax_variables, load_flax_variables
from efficientdet_tpu_torch.utils.detections import detection_mismatch
from torch_family import calibrate_variables, draw_variables, one_torch_thread, port_config

SIZE = 384
NUM_CLASSES = 90
GAIN = 1.0  # the draw's conv gain (see above)
# one source the model shrinks (480 x 640 -> 288 x 384) and one it enlarges
SHRINK, ENLARGE = (480, 640), (300, 200)
EXPORT_BATCH = 2
BOX_PX = 1e-3
SCORE = 1e-5
EXPORT_SCORE_REL = 2.0 ** -21  # see above: the float64 witness

def entry_variables(phi: int, seed: int = 0):
    """(JAX config, JAX model, numpy flax variables) of D``phi`` at SIZE."""
    cfg = JModelConfig.for_phi(phi, num_classes=NUM_CLASSES, image_size=SIZE)
    jmodel = JEfficientDet(config=cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    variables = jax.tree.map(np.asarray, draw_variables(shapes, np.random.RandomState(seed),
                                                        gain=GAIN))
    return cfg, jmodel, calibrate_variables(cfg, variables, seed)


def source_image(seed: int, hw) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, tuple(hw) + (3,)).astype(np.uint8)


def export_images(phi: int) -> np.ndarray:
    rng = np.random.RandomState(10 + phi)
    return rng.randint(0, 256, (EXPORT_BATCH, SIZE, SIZE, 3)).astype(np.uint8)


def check_detections(got, want, box_px=BOX_PX, score_atol=SCORE, score_rtol=0.0):
    """One image's detections against another's by
    ``utils.detections.detection_mismatch`` (near-tied scores in either
    order)."""
    fault = detection_mismatch(got, want, box_px, score_atol, score_rtol)
    assert fault is None, fault


def assert_equal_detections(got, want):
    for name, g, w in zip(("boxes", "scores", "classes", "num_valid"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


def served(dets, i, scale):
    """Image ``i``'s detections of a padded batch, boxes in source pixels,
    as the server hands them back."""
    b, s, c, n = dets
    k = int(n[i])
    return b[i, :k].numpy() / scale, s[i, :k].numpy(), c[i, :k].numpy()


def entry_for(phi: int):
    """The module's ``entry`` fixture: D``phi``'s JAX model, variables and
    the port's unfused model on the same weights."""
    @pytest.fixture(scope="module")
    def entry():
        cfg, jmodel, variables = entry_variables(phi)
        port = load_flax_variables(et.EfficientDet(port_config(cfg)), variables).eval()
        return dict(phi=phi, cfg=cfg, jmodel=jmodel, variables=variables, port=port)
    return entry


def port_predictor(entry) -> Predictor:
    return Predictor(phi=entry["phi"], num_classes=NUM_CLASSES, image_size=SIZE, device="cpu",
                     variables=from_flax_variables(entry["variables"]))


@pytest.fixture(scope="module")
def artifact(entry, tmp_path_factory):
    """The port's artifact of the unfused model (export folds the BNs)."""
    path = str(tmp_path_factory.mktemp("export") / f"d{entry['phi']}.edz")
    manifest = export.save_exported(path, entry["port"], EXPORT_BATCH)
    predict, loaded = export.load_exported(path, device="cpu")
    return dict(path=path, manifest=manifest, predict=predict, loaded=loaded)


@pytest.fixture(scope="module")
def jax_artifact(entry, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_export") / f"d{entry['phi']}_jax.edz")
    manifest = jexport.save_exported(path, entry["jmodel"], entry["variables"],
                                     batch_size=EXPORT_BATCH)
    predict, _ = jexport.load_exported(path)
    outputs = [np.asarray(o) for o in predict(jnp.asarray(export_images(entry["phi"])))]
    return dict(manifest=manifest, outputs=outputs)


# The tests: ``from torch_entry import *`` in a file that sets
# ``entry = entry_for(phi)``.
__all__ = ["one_torch_thread", "entry_for", "artifact", "jax_artifact",
           "test_predictor_matches_jax", "test_predictor_equals_predict_pipeline",
           "test_artifact_equals_predict_pipeline_bit_for_bit",
           "test_artifact_matches_the_jax_artifact", "test_artifact_manifest_model_block",
           "test_from_artifact_serves_predict_pipeline"]


def test_predictor_matches_jax(entry):
    """The port's Predictor against the JAX one, the same bridged weights on
    both sides, one source the model shrinks: the Predictor's rule."""
    jp = JPredictor(phi=entry["phi"], num_classes=NUM_CLASSES, image_size=SIZE,
                    variables=entry["variables"])
    img = source_image(1, SHRINK)
    want = jp(img)
    got = port_predictor(entry)(img)
    check_detections(got, want)
    assert got[0].dtype == np.float32 and got[2].dtype == np.int32


@pytest.mark.parametrize("hw", [SHRINK, ENLARGE], ids=["shrink", "enlarge"])
def test_predictor_equals_predict_pipeline(entry, hw):
    """The Predictor (preprocess_image's antialiased shrink or bilinear
    enlargement to SIZE, then the single-image NMS) equals the port's
    batched predict_pipeline on the same letterboxed canvas through the
    same "concat" heads, boxes divided by the scale, bit for bit; eager()
    equals the call. (The "anchor_major" heads sum each logit in another
    order: a score an ulp apart.)"""
    p = port_predictor(entry)
    img = source_image(2, hw)
    got = p(img)
    canvas, scale = preprocess_image(torch.from_numpy(img), SIZE)
    with torch.inference_mode():
        dets = et.predict_pipeline(p.model, canvas[None], p.eval_config, preprocess=False,
                                   front_end="concat")
    want = served(dets, 0, scale.numpy())
    assert len(got[0]) > 0
    for name, g, w in zip(("boxes", "scores", "classes"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    for g, w in zip(p.eager(img), got):
        np.testing.assert_array_equal(g, w)


def test_artifact_equals_predict_pipeline_bit_for_bit(entry, artifact):
    images = torch.from_numpy(export_images(entry["phi"]))
    got = artifact["predict"](images)
    want = et.predict_pipeline(et.fuse_for_inference(entry["port"]), images)
    assert_equal_detections(got, want)
    assert int(got[3].min()) > 0


def test_artifact_matches_the_jax_artifact(entry, artifact, jax_artifact):
    """The export rule: counts and classes exact, boxes within 1e-3 px,
    scores within EXPORT_SCORE_REL relative (the float64 witness above),
    near-ties in either order (check_detections); the manifests' shared
    blocks equal."""
    got = [t.numpy() for t in artifact["predict"](torch.from_numpy(export_images(entry["phi"])))]
    want = jax_artifact["outputs"]
    np.testing.assert_array_equal(got[3], want[3])
    for i, n in enumerate(want[3]):
        check_detections([t[i, :n] for t in got[:3]], [t[i, :n] for t in want[:3]],
                         score_atol=0.0, score_rtol=EXPORT_SCORE_REL)
    for key in ("batch_size", "preprocess", "fused_bn", "model", "eval_config"):
        assert artifact["manifest"][key] == jax_artifact["manifest"][key], key


def test_artifact_manifest_model_block(entry, artifact):
    """The manifest's model block names the phi and its fusion: D7's
    unweighted BiFPN has no fusion weights among the program's inputs."""
    man = artifact["manifest"]
    assert man == artifact["loaded"]
    weighted = entry["phi"] < 6
    assert man["model"] == {"phi": entry["phi"], "image_size": SIZE, "num_classes": NUM_CLASSES,
                            "weighted_bifpn": weighted}
    has_fusion = any(s["path"][-1] == "fusion_weights" for s in man["variables"])
    assert has_fusion == weighted


def test_from_artifact_serves_predict_pipeline(entry, artifact):
    """BatchingPredictor.from_artifact on the CPU: one bucket of the
    exported batch; two concurrent requests, each answer equal to
    predict_pipeline's detections of its letterboxed source."""
    pred = et.BatchingPredictor.from_artifact(artifact["path"], max_delay_ms=2000.0,
                                              device="cpu")
    imgs = [source_image(20 + i, hw) for i, hw in enumerate([SHRINK, ENLARGE])]
    try:
        assert pred._buckets == [EXPORT_BATCH] and pred.size == SIZE
        futs = [pred.predict(im) for im in imgs]
        answers = [f.result(timeout=300) for f in futs]
    finally:
        pred.close()
    canvases = [letterbox_hostside(im, SIZE) for im in imgs]
    batch = torch.from_numpy(np.stack([cv for cv, _ in canvases]))
    dets = et.predict_pipeline(et.fuse_for_inference(entry["port"]), batch)
    for i, (got, (_, scale)) in enumerate(zip(answers, canvases)):
        want = served(dets, i, scale)
        assert len(want[0]) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def jax_float64_export_detections(cfg, variables, images):
    """The float64 witness of the artifacts' detections, made by the JAX
    package alone: its unfused detector in float64 (under
    ``jax.enable_x64``) on ``images``, the head outputs rounded once to
    float32 and sent through its own NMS (``torch_family.nms_of_jax_heads``,
    the export's default EvalConfig). About a minute a phi at 384 px on
    the CPU: the script's, not the tests'."""
    from efficientdet_tpu.ops.preprocess import preprocess_batch_fixed as jpreprocess
    from torch_family import nms_of_jax_heads

    with jax.enable_x64(True):
        model = JEfficientDet(config=cfg, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        x = jpreprocess(jnp.asarray(images)).astype(jnp.float64)
        cls, box = jax.jit(lambda v, x: model.apply(v, x, return_anchor_major_levels=True))(v64, x)
        heads = {"z": np.asarray(cls[0], np.float32), "amax": np.asarray(cls[1], np.float32),
                 "zb": np.asarray(box[0], np.float32)}
    ref = {"cfg": cfg, "size": SIZE, "hws": tuple(h * w for h, w in cfg.feature_shapes())}
    return nms_of_jax_heads({**ref, **heads})[1]


def score_rel(got, want) -> float:
    """The largest relative score distance, place by place over the valid
    detections (both sorted by score)."""
    worst = 0.0
    for i, n in enumerate(want[3]):
        g, w = got[1][i, :n], want[1][i, :n]
        worst = max(worst, float((np.abs(g - w) / np.abs(w)).max()))
    return worst


def witness(phi: int) -> dict:
    """Every artifact's distance from the others and from the float64
    witness: the scores' largest relative distance and the boxes' largest
    pixel distance (positional)."""
    import tempfile

    cfg, jmodel, variables = entry_variables(phi)
    port = load_flax_variables(et.EfficientDet(port_config(cfg)), variables).eval()
    images = export_images(phi)
    with tempfile.TemporaryDirectory() as tmp:
        jexport.save_exported(f"{tmp}/j.edz", jmodel, variables, batch_size=EXPORT_BATCH)
        jpredict, _ = jexport.load_exported(f"{tmp}/j.edz")
        dets = {"jax": [np.asarray(o) for o in jpredict(jnp.asarray(images))]}
        export.save_exported(f"{tmp}/p.edz", port, EXPORT_BATCH)
        predict, _ = export.load_exported(f"{tmp}/p.edz", device="cpu")
        dets["port"] = [t.numpy() for t in predict(torch.from_numpy(images))]
    dets["float64"] = [np.asarray(d) for d in jax_float64_export_detections(cfg, variables, images)]
    rec = {"phi": phi, "num_valid": [int(n) for n in dets["float64"][3]]}
    for a, b in (("port", "jax"), ("jax", "float64"), ("port", "float64")):
        rec[f"{a}_vs_{b}"] = {
            "same_counts_and_classes": bool(np.array_equal(dets[a][3], dets[b][3])
                                            and np.array_equal(dets[a][2], dets[b][2])),
            "score_rel": score_rel(dets[a], dets[b]),
            "box_px": float(np.abs(dets[a][0] - dets[b][0]).max())}
    return rec


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_entry.py [phi ...]:
    # the artifacts' float64 witness, one JSON line a phi
    import json
    import sys

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)  # as the tests run
    for p in [int(a) for a in sys.argv[1:]] or [4, 7]:
        print(json.dumps(witness(p)), flush=True)
