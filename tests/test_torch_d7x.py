"""EfficientDet-D7x on the CPU: google/automl's ``efficientdet-d7x`` (B7, BiFPN
384 x 8 with sum fusion over P3..P8, heads 5 deep, anchor scale 4, anchor
strides 8..256) at its published widths and depth, at 256 px (P8 1 x 1),
against the benchmark's plain reference ``portbench/reference/levels.py``.

Weights are drawn by ``portbench.lib.weights.draw`` at gain 1 from a seed,
with the BN statistics calibrated, and load into both sides by name.
Tolerances: each level's logits and deltas within 1e-4 of the level's
largest reference magnitude (the family's rule); detections with counts
and classes exact, scores within 1e-5 and boxes within 1e-3 px, float32
against float32. The test also holds the level-generic pieces that D7x
added: the BiFPN's node plan (P3..P7 as it was), its spans and fusion
counters, the automl name map over P3..P8, the command lines' ``--phi``,
the training step, the ``.edz`` artifact and the ``Predictor`` on six
levels.
"""

import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.models import bifpn
from efficientdet_tpu_torch.ops.preprocess import preprocess_batch_fixed
from efficientdet_tpu_torch.utils import convert, profiling
from portbench.lib.detect import reference_outputs
from portbench.lib.models import port_model, reference_config
from portbench.lib.weights import calibrate, draw
from portbench.reference.config import Eval
from portbench.reference.levels import Detector
from portbench.reference.model import normalize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256
SEED = 2 ** 31 + 18
LEVEL_TOL = 1e-4
SCORE_TOL = 1e-5
BOX_TOL_PX = 1e-3
# the five-level BiFPN's nodes as the layer ran them before the node plan
FIVE_LEVEL_NODES = (("p6_td", 2), ("p5_td", 2), ("p4_td", 2), ("p3_out", 2),
                    ("p4_out", 3), ("p5_out", 3), ("p6_out", 3), ("p7_out", 2))
# a narrow six-level model: B0's backbone and D0's BiFPN width, P3..P8
NARROW = dict(backbone="efficientnet-b0", bifpn_width=64, bifpn_depth=2, head_depth=2,
              survival_prob=1.0)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def d7x():
    """The configuration file at 256 px, the drawn weights, one image, and
    the reference's levels and detections."""
    with open(os.path.join(ROOT, "portbench", "configs", "effdet-d7x.json")) as f:
        cfg = json.load(f)
    cfg["image_size"] = SIZE
    rc = reference_config(cfg)
    ref = Detector(rc)
    ref.load_state_dict(draw(ref, SEED, gain=1.0))
    calibrate(ref, SEED)
    ref.eval()
    sd = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    images = torch.randint(0, 256, (1, SIZE, SIZE, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        levels = ref(normalize(images), levels=True)
    _, _, dets, _ = next(reference_outputs(ref, images, Eval(), 1))
    return {"cfg": cfg, "sd": sd, "images": images, "levels": levels, "dets": dets}


def narrow_config(**overrides):
    cfg = et.ModelConfig.for_phi("7x", num_classes=6, image_size=SIZE)
    return dataclasses.replace(cfg, **{**NARROW, **overrides})


# ---------------------------------------------------------------- configuration

def test_for_phi_7x_gives_automls_d7x():
    c = et.ModelConfig.for_phi("7x")
    assert (c.phi, c.image_size, c.backbone, c.bifpn_width, c.bifpn_depth, c.head_depth) == (
        "7x", 1536, "efficientnet-b7", 384, 8, 5)
    assert (c.min_level, c.max_level, c.num_levels, c.weighted_bifpn) == (3, 8, 6, False)
    assert c.anchor.strides == (8, 16, 32, 64, 128, 256) and c.anchor.anchor_scale == 4.0
    assert c.feature_shapes()[-1] == (6, 6) and c.total_anchors() == 442_260
    for phi in range(8):  # the five-level phis keep P3..P7
        assert et.ModelConfig.for_phi(phi).anchor.strides == (8, 16, 32, 64, 128)
    assert et.ModelConfig.for_phi("7x", image_size=256).image_size == 256
    for bad in (dict(phi="7x", image_size=1152), dict(phi="8x"), dict(phi=True)):
        with pytest.raises(ValueError):
            et.ModelConfig.for_phi(**bad)
    assert et.efficientdet_d7x.__name__ == "efficientdet_d7x"


def test_the_node_plan_of_p3_p7_is_the_five_level_bifpn():
    assert [(n, len(i)) for n, _, i in bifpn.node_plan(3, 7)] == list(FIVE_LEVEL_NODES)
    plan = bifpn.node_plan(3, 8)
    assert [n for n, _, _ in plan] == ["p7_td", "p6_td", "p5_td", "p4_td", "p3_out",
                                       "p4_out", "p5_out", "p6_out", "p7_out", "p8_out"]
    # automl's bifpn_config(3, 8): inputs 0..5, nodes 6..15
    assert [i for _, _, i in plan] == [(4, 5), (3, 6), (2, 7), (1, 8), (0, 9),
                                       (1, 9, 10), (2, 8, 11), (3, 7, 12), (4, 6, 13), (5, 14)]
    layer = bifpn.BiFPNLayer(16, first=False, max_level=8)
    assert [n for n, _ in layer.named_children()] == [n for n, _, _ in plan]


# ---------------------------------------------------------------- against the reference

@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "folded"])
def test_each_level_matches_the_reference(d7x, fuse):
    port = port_model(d7x["cfg"], d7x["sd"], torch.float32, "cpu", fuse=fuse)
    with torch.no_grad():
        cls, box = port(preprocess_batch_fixed(d7x["images"]), raw_levels=True)
    want_cls, want_box = d7x["levels"]
    assert len(cls) == len(box) == len(want_cls) == 6
    assert cls[-1].shape[1:3] == (1, 1)  # P8
    for got, want in zip(cls + box, want_cls + want_box):
        assert got.shape == want.shape
        gap = float((got - want).abs().max())
        assert gap <= LEVEL_TOL * float(want.abs().max()), (got.shape, gap)


@pytest.mark.parametrize("front_end", ["anchor_major", "concat"])
def test_detections_match_the_reference(d7x, front_end):
    port = port_model(d7x["cfg"], d7x["sd"], torch.float32, "cpu", fuse=True)
    predict = et.make_predict_fn(port, et.EvalConfig(), front_end=front_end)
    boxes, scores, classes, n = predict(d7x["images"])
    k = int(n[0])
    want_boxes, want_scores, want_classes = d7x["dets"]
    assert k == len(want_scores) > 0
    assert torch.equal(classes[0, :k].long(), want_classes.long())
    assert float((scores[0, :k] - want_scores).abs().max()) <= SCORE_TOL
    assert float((boxes[0, :k] - want_boxes).abs().max()) <= BOX_TOL_PX


# ---------------------------------------------------------------- spans and counters

def test_the_bifpn_spans_and_fusion_counters():
    model = et.EfficientDet(narrow_config(bifpn_depth=8, bifpn_width=16)).eval()
    x = torch.zeros((1, SIZE, SIZE, 3))
    profiling.clear()
    before = (bifpn.fuse.sum, bifpn.fuse.weighted)
    try:
        with profiling.record_spans(), torch.no_grad():
            model(x)
        rows = profiling.summary()
    finally:
        profiling.clear()
    assert (bifpn.fuse.sum - before[0], bifpn.fuse.weighted - before[1]) == (80, 0)
    # ten nodes a layer, each with one resample; the first layer pools P6, P7, P8
    assert rows["bifpn.fuse"]["count"] == 80 and rows["bifpn.resample"]["count"] == 83
    with torch.no_grad():
        model(x)  # unrecorded: counted, no span kept
    assert bifpn.fuse.sum - before[0] == 160 and profiling.summary() == {}
    d0, _ = et.build_efficientdet(0, image_size=128, device="cpu")
    before = (bifpn.fuse.sum, bifpn.fuse.weighted)
    with torch.no_grad():
        d0(torch.zeros((1, 128, 128, 3)))
    assert (bifpn.fuse.sum - before[0], bifpn.fuse.weighted - before[1]) == (0, 24)


def test_the_bifpn_spans_open_no_profiler_range():
    """Under a profiler session the BiFPN's spans are kept, and the trace
    holds the stages' ranges alone: a range for each node would cost a traced call
    host time that no reader of the trace needs."""
    model = et.EfficientDet(narrow_config(bifpn_width=16)).eval()
    profiling.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
                torch.no_grad():
            model(torch.zeros((1, SIZE, SIZE, 3)))
        rows = profiling.summary()
    finally:
        profiling.clear()
    assert rows["bifpn.fuse"]["count"] == 20 and rows["bifpn.resample"]["count"] == 23
    ranges = {e.name for e in prof.events() if not e.name.startswith("aten::")}
    assert ranges == {profiling.RANGE_NAMES[st] for st in ("backbone", "bifpn", "heads")}


# ---------------------------------------------------------------- command lines

@pytest.mark.parametrize("cli", ["train", "evaluate", "predict", "serve", "parity_run"])
def test_each_command_line_takes_phi_7x(cli):
    from efficientdet_tpu_torch import evaluate, predict, serve, train
    from efficientdet_tpu_torch.tools import parity_run

    parse, argv = {"train": (train.parse_args, ["coco", "data"]),
                   "evaluate": (evaluate.parse_args, ["coco", "data", "--snapshot", "s"]),
                   "predict": (predict.main, ["--image", "x.jpg"]),
                   "serve": (serve.main, []),
                   "parity_run": (parity_run.parse_args, ["--weights", "w", "--coco-path", "c"])}[cli]
    # argparse checks --phi as it reads it, before --help ends the parse
    for phi, code in (("7x", 0), ("7", 0), ("8", 2), ("7X", 2)):
        with pytest.raises(SystemExit) as e:
            parse(argv + ["--phi", phi, "--help"])
        assert e.value.code == code, phi
    if cli not in ("predict", "serve"):
        assert parse(argv + ["--phi", "7x"]).phi == "7x"
    assert parity_run.PAPER_AP["7x"] == 55.1


# ---------------------------------------------------------------- name map

def test_the_automl_name_map_over_p3_p8():
    cfg = et.ModelConfig.for_phi("7x", image_size=SIZE)
    m = convert.bifpn_name_map(2, weighted=True, min_level=3, max_level=8)
    names = {v for v in m.values() if isinstance(v, str)}
    for j in range(10):
        assert f"fpn_cells/cell_1/fnode{j}/op_after_combine{j + 6}/conv/depthwise_kernel" in names
    resamples = sorted({n.split("/")[3] for n in names if "/resample_0_" in n})
    assert resamples == ["resample_0_0_10", "resample_0_1_11", "resample_0_1_9",
                         "resample_0_2_12", "resample_0_2_8"]
    wsm = {k.split("/")[3]: len(v) for k, v in m.items() if isinstance(v, tuple)
           and "layer1" in k}
    assert wsm == {"p7_td": 2, "p6_td": 2, "p5_td": 2, "p4_td": 2, "p3_out": 2,
                   "p4_out": 3, "p5_out": 3, "p6_out": 3, "p7_out": 3, "p8_out": 2}
    assert convert.bifpn_name_map(3) == convert.bifpn_name_map(3, min_level=3, max_level=7)
    full = convert.detector_name_map(cfg)
    with torch.device("meta"):
        state = et.EfficientDet(cfg).state_dict()
    convert.assert_full_coverage(state, full)
    assert "class_net/class-4-bn-8/gamma" in set(full.values())


# ---------------------------------------------------------------- training, artifact, Predictor

def test_one_training_step_on_six_levels():
    cfg = narrow_config()
    model = et.EfficientDet(cfg).train()
    rng = np.random.RandomState(3)
    boxes = np.full((2, 4, 4), -1.0, np.float32)
    boxes[:, :2] = [[20, 30, 120, 140], [100, 60, 250, 250]]
    labels = np.full((2, 4), -1, np.int32)
    labels[:, :2] = [[1, 4], [0, 5]]
    batch = {"images": rng.randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8),
             "gt_boxes": boxes, "gt_labels": labels}
    tc = et.TrainConfig(batch_size=2, max_gt_boxes=4)
    state = et.create_train_state(model, tc, device="cpu")
    step = et.make_train_step(model, tc, device="cpu")
    profiling.clear()
    try:
        with profiling.record_spans():
            state, metrics = step(state, batch, torch.Generator().manual_seed(0))
        counts = collections.Counter(s.name for s in profiling.RECORDER.spans())
    finally:
        profiling.clear()
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    assert counts["loss.focal"] == counts["loss.huber"] == 2 * 6  # each level, both ways
    assert model.anchors(SIZE, torch.device("cpu")).shape[0] == cfg.total_anchors() == 12_285
    labels_t, _, state_t = et.anchor_targets_batch_compact(
        model.anchors(SIZE, torch.device("cpu")), torch.from_numpy(boxes),
        torch.from_numpy(labels))
    assert labels_t.shape == state_t.shape == (2, 12_285) and int((state_t == 1).sum()) > 0


def test_the_artifact_and_the_predictor_take_7x(tmp_path):
    model = et.EfficientDet(narrow_config(bifpn_width=16)).eval()
    path = str(tmp_path / "d7x_narrow.edz")
    manifest = et.save_exported(path, model, 1)
    assert manifest["model"]["phi"] == "7x"
    predict, loaded = et.load_exported(path, device="cpu")
    assert loaded["model"]["phi"] == "7x"
    images = torch.randint(0, 256, (1, SIZE, SIZE, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    want = et.predict_pipeline(et.fuse_for_inference(model), images)
    got = predict(images)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    p = et.Predictor(phi="7x", image_size=SIZE, device="cpu")
    assert p.config.max_level == 8 and p.config.backbone == "efficientnet-b7"
    boxes, scores, classes = p(np.zeros((120, 200, 3), np.uint8))
    assert boxes.shape[1:] == (4,) and len(scores) == len(classes) <= 100
