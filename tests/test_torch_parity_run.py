"""The port's weights-day drill (efficientdet_tpu_torch/tools/parity_run.py)
end to end on the CPU, against the JAX package's archive and evaluator.

The two cases of tests/test_parity_run.py (which the JAX package marks slow;
these run in tier-1): the same slim detector (B0, BiFPN and heads at width
8, depth 1, 128 px), its flax variables drawn with numpy over
``jax.eval_shape`` (no JAX compile) and written by the JAX package's
``export_detector_tf_style`` into an ``.npz`` of TF names; a two-image COCO
directory of PNG files. The drill must import strictly (a truncated array
raises), print one parity line, map the automl 90-id convention, hold the
weights of ``from_flax_variables`` bit for bit, and give the COCO stats that
the JAX evaluator computes from its saved detections.
"""

import dataclasses
import json
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdet_tpu.configs import ModelConfig as JModelConfig
from efficientdet_tpu.evaluation.coco_eval import CocoEvaluator
from efficientdet_tpu.models.detector import EfficientDet as JEfficientDet
from efficientdet_tpu.utils.convert import export_detector_tf_style
from efficientdet_tpu_torch.data import CocoDataset
from efficientdet_tpu_torch.tools import parity_run
from efficientdet_tpu_torch.utils.convert import from_flax_variables
from torch_family import draw_variables

SIZE = 128
SHRINK = ["--image-size", "128", "--bifpn-width", "8", "--bifpn-depth", "1", "--head-depth", "1"]
STATS_TOL = 1e-12


def _png(img: np.ndarray) -> bytes:
    """An RGB uint8 image as PNG bytes, with the standard library alone."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.fixture
def coco_dir(tmp_path):
    """tests/test_parity_run.py's COCO set: two images, one car each,
    categories {3: car, 17: cat}."""
    img_dir = tmp_path / "val2017"
    img_dir.mkdir()
    ann_dir = tmp_path / "annotations"
    ann_dir.mkdir()
    images, anns = [], []
    rng = np.random.RandomState(0)
    for i, (w, h) in enumerate([(96, 64), (64, 96)], start=1):
        arr = rng.randint(0, 255, (h, w, 3), np.uint8)
        (img_dir / f"{i:012d}.png").write_bytes(_png(arr))
        images.append({"id": i, "width": w, "height": h, "file_name": f"{i:012d}.png"})
        anns.append({"id": i, "image_id": i, "category_id": 3,
                     "bbox": [5, 5, 30, 30], "area": 900, "iscrowd": 0})
    cats = [{"id": 3, "name": "car"}, {"id": 17, "name": "cat"}]
    with open(ann_dir / "instances_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return str(tmp_path)


def slim_archive(tmp_path, num_classes, seed):
    """(flax variables, TF-named arrays, .npz path) of the slim detector."""
    cfg = dataclasses.replace(JModelConfig.for_phi(0, num_classes=num_classes, image_size=SIZE),
                              bifpn_width=8, bifpn_depth=1, head_depth=1)
    shapes = jax.eval_shape(JEfficientDet(config=cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    variables = jax.tree.map(np.asarray, draw_variables(shapes, np.random.RandomState(seed)))
    tf_vars = {k: np.asarray(v) for k, v in export_detector_tf_style(variables, cfg).items()}
    path = tmp_path / f"synthetic_{num_classes}c.npz"
    np.savez(path, **tf_vars)
    return variables, tf_vars, str(path)


def drill(weights, coco_dir, num_classes, *extra):
    return parity_run.run(parity_run.parse_args([
        "--weights", weights, "--coco-path", coco_dir, "--phi", "0",
        "--num-classes", str(num_classes), *SHRINK, "--batch-size", "2", "--dtype", "f32",
        "--paper-ap", "0.0", "--device", "cpu", *extra]))


def parity_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{") and '"parity"' in ln]


def test_parity_run_end_to_end(tmp_path, coco_dir, capsys):
    variables, tf_vars, weights = slim_archive(tmp_path, 2, seed=7)
    saved = tmp_path / "dets.json"
    result = drill(weights, coco_dir, 2, "--save-detections", str(saved))
    out = capsys.readouterr().out
    assert "strict full-coverage import ok" in out
    lines = parity_lines(out)
    assert len(lines) == 1
    rec = lines[0]
    assert rec == result["record"]
    assert rec["phi"] == 0 and rec["images"] == 2
    assert np.isfinite(rec["AP"]) and "within_0.2" in rec
    assert rec["delta"] == rec["AP"] - rec["paper_AP"]

    # the drill's weights are the flax variables' bit for bit
    state = result["model"].state_dict()
    want = from_flax_variables(variables)
    assert state.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(state[k], v), k

    # the port's COCO stats are what the JAX evaluator makes of its detections
    dets = json.loads(saved.read_text())
    assert dets, "the random model kept no detection"
    ds = CocoDataset(coco_dir, "val2017")
    ev = CocoEvaluator(ds.coco.dataset["annotations"], [ds.image_id(i) for i in range(len(ds))],
                       ds.cat_ids)
    ev.add_detections(dets)
    jax_stats = ev.summarize()
    assert jax_stats.keys() == result["stats"].keys()
    for k, v in jax_stats.items():
        assert abs(result["stats"][k] - v) <= STATS_TOL, k

    # a truncated array fails the strict shape gate
    bad = dict(tf_vars)
    k = sorted(bad)[0]
    bad[k] = bad[k].reshape(-1)[: max(bad[k].size - 1, 1)]
    bad_path = tmp_path / "bad.npz"
    np.savez(bad_path, **bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        drill(str(bad_path), coco_dir, 2)


def test_parity_run_model_classes_exceed_dataset(tmp_path, coco_dir, capsys):
    """A model of more classes than the dataset annotates (4 against the
    two categories {3, 17}): the automl convention category_id = label + 1,
    with the labels whose id has no annotations dropped."""
    _, _, weights = slim_archive(tmp_path, 4, seed=3)
    drill(weights, coco_dir, 4)
    out = capsys.readouterr().out
    assert "label map: automl 90-id convention" in out
    assert "1/4 labels have annotated categories" in out
    assert np.isfinite(parity_lines(out)[-1]["AP"])


def test_parity_run_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = parity_run.parse_args(["--weights", str(tmp_path / "none.npz"),
                                  "--coco-path", str(tmp_path)])
    assert args.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity_run.run(args)
