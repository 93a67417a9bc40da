"""The port's .edz export (efficientdet_tpu_torch/export.py), on the CPU.

The slim D0 (full B0, BiFPN and heads at width 16, depth 2, 128 px, 6
classes) gets weights drawn with numpy over the JAX model's shapes
(``jax.eval_shape``, no init compile), bridged into the port with
``load_flax_variables``. The port's artifact must equal its own
``predict_pipeline`` on the fused model bit for bit; against the JAX
package's artifact of the same variables, conv sums run in another order on
the two sides, so boxes agree within 1e-3 px and scores within the
tolerance stated at :func:`test_artifact_matches_the_jax_artifact`.
"""

import dataclasses
import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdet_tpu import export as jexport
from efficientdet_tpu.configs import ModelConfig as JModelConfig
from efficientdet_tpu.models.detector import EfficientDet as JEfficientDet
import efficientdet_tpu_torch as et
from efficientdet_tpu_torch import export
from efficientdet_tpu_torch.utils.convert import load_flax_variables

BATCH = 2


def _randomize(variables, rng):
    """The detector tests' draws: fan-in kernels, BN statistics and fusion
    weights spread, so the logits do not tie."""
    def draw(path, v):
        name = path[-1].key
        shape = np.shape(v)
        if name == "kernel":
            return rng.normal(0, (1.5 / int(np.prod(shape[:-1]))) ** 0.5, shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "fusion_weights":
            return rng.uniform(-0.3, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def slim():
    cfg = JModelConfig.for_phi(0, num_classes=6, image_size=128)
    cfg = dataclasses.replace(cfg, bifpn_width=16, bifpn_depth=2, head_depth=2)
    jmodel = JEfficientDet(config=cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    rng = np.random.RandomState(0)
    variables = _randomize(shapes, rng)
    images = rng.randint(0, 256, (BATCH, 128, 128, 3)).astype(np.uint8)
    fields = {f.name for f in dataclasses.fields(et.ModelConfig)} - {"anchor"}
    pcfg = et.ModelConfig(**{k: getattr(cfg, k) for k in fields})
    port = load_flax_variables(et.EfficientDet(pcfg), variables).eval()
    return dict(jmodel=jmodel, variables=variables, images=images, port=port)


@pytest.fixture(scope="module")
def artifact(slim, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "slim_d0.edz")
    manifest = export.save_exported(path, slim["port"], BATCH)
    predict, loaded = export.load_exported(path, device="cpu")
    return dict(path=path, manifest=manifest, predict=predict, loaded=loaded)


@pytest.fixture(scope="module")
def jax_artifact(slim, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_export") / "slim_d0_jax.edz")
    manifest = jexport.save_exported(path, slim["jmodel"], slim["variables"], batch_size=BATCH)
    predict, _ = jexport.load_exported(path)
    outputs = [np.asarray(o) for o in predict(jnp.asarray(slim["images"]))]
    return dict(path=path, manifest=manifest, outputs=outputs)


def test_artifact_equals_predict_pipeline_bit_for_bit(slim, artifact):
    images = torch.from_numpy(slim["images"])
    got = artifact["predict"](images)
    want = et.predict_pipeline(et.fuse_for_inference(slim["port"]), images)
    assert len(got) == 4
    for name, g, w in zip(("boxes", "scores", "classes", "num_valid"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    assert int(got[3].min()) > 0


def test_artifact_matches_the_jax_artifact(slim, artifact, jax_artifact):
    """Counts and classes exact, boxes within 1e-3 px; scores within 2**-22
    relative, the logistic's <= 2 ulps on logits that agree."""
    got = [t.numpy() for t in artifact["predict"](torch.from_numpy(slim["images"]))]
    boxes, scores, classes, n = jax_artifact["outputs"]
    np.testing.assert_array_equal(got[3], n)
    np.testing.assert_array_equal(got[2], classes)
    np.testing.assert_allclose(got[0], boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], scores, rtol=2.0 ** -22, atol=0)
    for key in ("batch_size", "preprocess", "fused_bn", "model", "eval_config"):
        assert artifact["manifest"][key] == jax_artifact["manifest"][key], key


def test_artifact_has_the_jax_members_and_manifest_keys(artifact, jax_artifact):
    with zipfile.ZipFile(artifact["path"]) as zf:
        names = zf.namelist()
        on_disk = json.loads(zf.read("manifest.json"))
    with zipfile.ZipFile(jax_artifact["path"]) as zf:
        jax_names = zf.namelist()
    man = artifact["manifest"]
    assert on_disk == man == artifact["loaded"]
    assert names[:2] == ["manifest.json", "program.pt2"]
    assert jax_names[:2] == ["manifest.json", "program.stablehlo"]
    assert names[2:] == [f"vars/{i}.bin" for i in range(len(man["variables"]))]
    assert all(n.startswith("vars/") for n in jax_names[2:])
    want = set(jax_artifact["manifest"]) - {"jax_version"} | {"torch_version", "runtime"}
    assert set(man) == want
    assert man["runtime"] == "torch" and man["torch_version"] == torch.__version__
    assert man["platforms"] == ["cpu"] and man["dtype"] == "float32"
    assert man["model"] == {"phi": 0, "image_size": 128, "num_classes": 6, "weighted_bifpn": True}


def test_weights_are_inputs_and_the_program_is_small(slim, artifact):
    with zipfile.ZipFile(artifact["path"]) as zf:
        program = zf.getinfo("program.pt2").file_size
        weight_bytes = sum(i.file_size for i in zf.infolist() if i.filename.startswith("vars/"))
        ep = torch.export.load(io.BytesIO(zf.read("program.pt2")))
    assert program < weight_bytes
    assert dict(ep.state_dict) == {}
    assert list(ep.module().parameters()) == []
    # the one constant is the anchors
    assert [tuple(c.shape) for c in ep.constants.values()] == [(slim["port"].config.total_anchors(), 4)]
    fused = et.fuse_for_inference(slim["port"]).state_dict()
    specs = artifact["manifest"]["variables"]
    assert [".".join(s["path"]) for s in specs] == list(fused)
    assert weight_bytes == sum(v.numel() * v.element_size() for v in fused.values())


def _rewrite(src, dst, edit=None, drop=()):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            if name in drop:
                continue
            data = zin.read(name)
            if name == "manifest.json" and edit:
                data = json.dumps(edit(json.loads(data)))
            zout.writestr(name, data)


def test_loader_rejects_a_newer_format(artifact, tmp_path):
    newer = str(tmp_path / "newer.edz")

    def bump(m):
        m["format_version"] = export.FORMAT_VERSION + 1
        return m

    _rewrite(artifact["path"], newer, edit=bump)
    with pytest.raises(ValueError, match="newer than this loader"):
        export.load_exported(newer, device="cpu")


def test_loader_rejects_a_jax_artifact(jax_artifact):
    with pytest.raises(ValueError, match="JAX package"):
        export.load_exported(jax_artifact["path"], device="cpu")


def test_wrong_batch_shape_is_rejected(artifact):
    with pytest.raises(ValueError, match="shape"):
        artifact["predict"](torch.zeros((BATCH + 1, 128, 128, 3), dtype=torch.uint8))


def test_load_builds_no_model(artifact, slim, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("load_exported built a model")

    monkeypatch.setattr(et.EfficientDet, "__init__", refuse)
    monkeypatch.setattr(et, "fuse_for_inference", refuse)
    predict, _ = export.load_exported(artifact["path"], device="cpu")
    got = predict(torch.from_numpy(slim["images"]))
    want = artifact["predict"](torch.from_numpy(slim["images"]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_load_without_gpu_raises(artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_exported(artifact["path"])


def test_cli_exports_an_artifact(tmp_path, capsys):
    out = str(tmp_path / "d0.edz")
    export.main(["--phi", "0", "--image-size", "128", "--num-classes", "4", "--dtype", "f32",
                 "--device", "cpu", "--out", out])
    event = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert event["event"] == "exported" and event["batch_size"] == 1
    assert event["model"] == {"phi": 0, "image_size": 128, "num_classes": 4, "weighted_bifpn": True}
    predict, manifest = export.load_exported(out, device="cpu")
    boxes, scores, classes, n = predict(torch.zeros((1, 128, 128, 3), dtype=torch.uint8))
    assert boxes.shape == (1, 100, 4) and n.shape == (1,)
    assert manifest["eval_config"] == dataclasses.asdict(et.EvalConfig())


def test_cli_without_a_model_scale_fails_cleanly(tmp_path):
    with pytest.raises(SystemExit, match="no model scale"):
        export.main(["--device", "cpu", "--out", str(tmp_path / "x.edz")])
    with pytest.raises(SystemExit, match="train_config.json"):
        export.main(["--device", "cpu", "--snapshot", str(tmp_path), "--out", str(tmp_path / "x.edz")])
