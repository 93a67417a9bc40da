"""The port's spatial mode (height bands, parallel/context.py) on gloo ranks.

Every activation of an image is split by height over the ranks; SAME convs
and the max-pool read halo rows of their neighbours; levels too thin to
split are gathered and computed whole on every rank. The ranks run
tests/torch_parallel_ranks.py (no JAX) through ``parallel/launch.py``; the
references run in the pytest process: the port's serial layers, pipeline
and step, and the JAX package's ``make_spatial_predict_fn`` on conftest's
8 fake devices.

Tolerances. Layers: outputs and input gradients within 1e-5 of their scale
(float32; the banded convolutions sum the same products in another blocking).
Predict against the serial pipeline: counts and classes exact, boxes within
1e-4 px and scores within 1e-6 (this file's model gave at most 1.6e-5 px and
1.0e-7: the convolutions of a band and of the whole map round differently,
and decoding multiplies a box delta's rounding by its anchor's size);
against JAX's ``make_spatial_predict_fn``, the JAX test's atol 1e-4 on all
four outputs (tests/test_predict.py::TestSpatialPredict; at most 3.1e-5 px
here). Gradients: tests/test_train.py::TestSpatialTrain's rtol 1e-4, atol
1e-6; one spatial step against the one-process step at PR 6's tolerances
(tests/torch_parallel_ref.py) and the JAX test's BN-statistics check (rtol
1e-4, atol 1e-6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from efficientdet_tpu.configs import EvalConfig as JEvalConfig
from efficientdet_tpu.models.detector import EfficientDet as JEfficientDet
from efficientdet_tpu.parallel import make_mesh as j_make_mesh
from efficientdet_tpu.parallel import make_spatial_predict_fn as j_spatial_predict
import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.parallel.context import BandLayout
from efficientdet_tpu_torch.parallel.launch import spawn
from efficientdet_tpu_torch.parallel.tolerances import FLOAT64_SCALE
from efficientdet_tpu_torch.train_lib import _loss
import torch_parallel_ranks as R
import torch_parallel_ref as ref

NUM_CLASSES = 8
RANKS = "tests/torch_parallel_ranks.py"
TIMEOUT = 150  # seconds a spawn may take, its ranks' start-up included
LAYER_TOL = 1e-5
HALO_ROWS = [3, 2, 4]  # three ranks' bands, uneven


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test processes on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("size, world, unit, bounds", [
    (128, 2, 32, [0, 64, 128]),
    (256, 4, 32, [0, 64, 128, 192, 256]),
    (128, 3, 16, [0, 48, 96, 128]),
    (640, 4, 64, [0, 192, 384, 512, 640]),
])
def test_band_layout(size, world, unit, bounds):
    """One split fixes every level: each banded level's bands tile it, hold
    at least two rows (the 5x5 halo), and are twice the next coarser
    level's; levels above ``unit`` are whole."""
    lays = [BandLayout(size, world, r) for r in range(world)]
    assert lays[0].unit == unit and lays[0].bounds == bounds
    stride = 1
    while stride <= size:
        if stride <= unit:
            bands = [lay.band(stride) for lay in lays]
            assert bands[0][0] == 0 and bands[-1][1] == lays[0].rows(stride)
            assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
            assert all(hi - lo >= 2 for lo, hi in bands)
            if 2 * stride <= unit:
                assert all(lo == 2 * c_lo and hi == 2 * c_hi for (lo, hi), (c_lo, c_hi)
                           in zip(bands, (lay.band(2 * stride) for lay in lays)))
        else:
            assert not lays[0].banded(stride)
        stride *= 2
    with pytest.raises(ValueError):
        BandLayout(4, 3, 0)


@pytest.fixture(scope="module")
def layers():
    """Every layer case and halo pair on three ranks at 128 px (bands of
    3, 3 and 2 rows at stride 16; strides 32 and up whole)."""
    got = spawn(f"{RANKS}:layer_cases", 3, dict(image_size=128, halo_rows=HALO_ROWS),
                device="cpu", timeout_s=TIMEOUT)
    return got


@pytest.mark.parametrize("case", [c[0] for c in R.LAYER_CASES])
def test_banded_layer_equals_the_serial_layer(layers, case):
    """Kernel sizes, strides and pads of the B0 backbone and the BiFPN: the
    banded output and the input gradient equal the serial layer's."""
    assert layers[0]["layout"] == {"unit": 16, "bounds": [0, 48, 96, 128]}
    for r, res in enumerate(layers):
        c = res[case]
        assert c["out_err"] <= LAYER_TOL * max(c["out_scale"], 1.0), (r, c)
        assert c["grad_err"] <= LAYER_TOL * max(c["grad_scale"], 1.0), (r, c)
        if "stats_err" in c:
            assert c["stats_err"] <= LAYER_TOL, (r, c)


@pytest.mark.parametrize("above, below", R.HALO_PAIRS)
def test_halo_exchange(layers, above, below):
    """The rows a band receives (pads of -1 at the image's edges) and the
    gradients it sends back to their owners, on uneven bands."""
    total = sum(HALO_ROWS)
    for r, res in enumerate(layers):
        got = res["halo"][f"{above}_{below}"]
        lo = sum(HALO_ROWS[:r])
        hi = lo + HALO_ROWS[r]
        want = [float(i) if 0 <= i < total else -1.0 for i in range(lo - above, hi + below)]
        assert got["rows"].tolist() == want
        grad = np.ones(HALO_ROWS[r])
        if r < len(HALO_ROWS) - 1 and above:
            grad[HALO_ROWS[r] - above:] += 1  # lent to the next rank's halo above it
        if r > 0 and below:
            grad[:below] += 1  # lent to the previous rank's halo below it
        assert got["grad"].tolist() == grad.tolist()


@pytest.fixture(scope="module")
def slim():
    """The slim D0 (B0, width 16, depth 1, 8 classes; the JAX test's shape)
    with bridged numpy-drawn weights; its spec at 128 and 256 px."""
    cfg = ref.jax_config(128, NUM_CLASSES, depth=1, head=1)
    variables = ref.draw_variables(JEfficientDet(config=cfg), 128, seed=1)
    specs = {s: ref.spec_of(dataclasses.replace(cfg, image_size=s)) for s in (128, 256)}
    return {"cfg": cfg, "variables": variables, "specs": specs,
            "state": ref.port_state(specs[128], variables)}


EVAL = {"approx_anchor_prefilter": False}


@pytest.fixture(scope="module")
def jax_spatial(slim):
    """The JAX package's spatial predict on its 8 fake devices, by size."""
    out = {}
    for size in (128, 256):
        cfg = dataclasses.replace(slim["cfg"], image_size=size)
        fn = j_spatial_predict(JEfficientDet(config=cfg), j_make_mesh(), JEvalConfig(**EVAL))
        out[size] = [np.asarray(t) for t in fn(slim["variables"], _images(size))]
    return out


def _images(size):
    return np.random.RandomState(size).randint(0, 255, (2, size, size, 3)).astype(np.uint8)


@pytest.mark.parametrize("world, size", [(2, 256), (2, 128), (4, 256)])
def test_spatial_predict(slim, jax_spatial, world, size):
    """Against the serial pipeline and the JAX spatial predict. At 128 px
    on 2 ranks P6 (2 rows) and P7 (1 row) are computed whole; at 256 px on
    4 ranks P6 (4 rows) and P7 (2 rows)."""
    spec = slim["specs"][size]
    got = spawn(f"{RANKS}:predict", world, dict(
        spec=spec, state=slim["state"], images=torch.from_numpy(_images(size)), mode="spatial",
        eval_config=EVAL), device="cpu", timeout_s=TIMEOUT)
    for r in range(1, world):
        assert all(torch.equal(a, b) for a, b in zip(got[0]["dets"], got[r]["dets"]))
    model = R.build_model(spec, slim["state"])
    want = et.predict_pipeline(model, torch.from_numpy(_images(size)), et.EvalConfig(**EVAL))
    assert int(want[3].min()) > 0
    ref.assert_detections(got[0]["dets"], want, box_tol=1e-4, score_tol=1e-6)
    j = jax_spatial[size]
    for name, a, b in zip(("boxes", "scores", "classes", "n"), got[0]["dets"], j):
        np.testing.assert_allclose(a.numpy().astype(np.float32), b.astype(np.float32), atol=1e-4,
                                   err_msg=name)


@pytest.fixture(scope="module")
def spatial_training(slim):
    """On two ranks at 128 px: eval-mode gradients of the detection loss,
    then one spatial training step (stochastic depth on), in float32 and in
    float64."""
    spec = slim["specs"][128]
    grad_batch = ref.torch_batch(ref.synth_batch(11, 2, 128, NUM_CLASSES))
    step_batch = ref.torch_batch(ref.synth_batch(12, 2, 128, NUM_CLASSES))
    tc = {"batch_size": 2, "learning_rate": ref.LR}
    calls = [("spatial_grads", dict(spec=spec, state=slim["state"], batch=grad_batch,
                                    train_config=tc)),
             ("train_steps", dict(spec=spec, state=slim["state"], batches=[step_batch],
                                  train_config=tc, mode="spatial", seed=5)),
             ("train_steps", dict(spec=dict(spec, dtype="float64"), state=slim["state"],
                                  batches=[step_batch], train_config=tc, mode="spatial", seed=5))]
    got = spawn(f"{RANKS}:many", 2, dict(calls=calls), device="cpu", timeout_s=TIMEOUT)
    return {"spec": spec, "grad_batch": grad_batch, "step_batch": step_batch, "tc": tc,
            "ranks": [g["results"] for g in got]}


def test_spatial_gradients_equal_the_serial_ones(slim, spatial_training):
    st = spatial_training
    model = R.build_model(st["spec"], slim["state"])
    b = st["grad_batch"]
    total, _, _ = _loss(model, et.TrainConfig(**st["tc"]), b["images"], b["gt_boxes"],
                        b["gt_labels"], None)
    names = [k for k, _ in model.named_parameters()]
    want = dict(zip(names, torch.autograd.grad(total, list(model.parameters()))))
    for grads in (r[0] for r in st["ranks"]):
        assert grads["loss"] == pytest.approx(float(total.detach()), rel=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(grads["grads"][k].numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_spatial_step_equals_the_one_process_step(slim, spatial_training):
    st = spatial_training
    model = R.build_model(st["spec"], slim["state"]).train()
    tc = et.TrainConfig(**st["tc"])
    want = R.run_steps(model, tc, et.make_train_step(model, tc, "cpu"), [st["step_batch"]], 5)
    steps = [r[1] for r in st["ranks"]]
    for k, v in steps[0]["params"].items():
        assert torch.equal(steps[1]["params"][k], v), k
    ref.compare_to_port_step(steps[0], want)
    for k, v in want["buffers"].items():
        np.testing.assert_allclose(steps[0]["buffers"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_spatial_step_in_float64_equals_the_one_process_step(slim, spatial_training):
    """The spatial step in float64 against the one-process float64 step at
    FLOAT64_SCALE of the tolerances: the bands regroup the sums, which moves
    a float64 step by about 1e-12, so a larger difference would be a defect."""
    st = spatial_training
    spec = dict(st["spec"], dtype="float64")
    model = R.build_model(spec, slim["state"]).train()
    tc = et.TrainConfig(**st["tc"])
    want = R.run_steps(model, tc, et.make_train_step(model, tc, "cpu"), [st["step_batch"]], 5)
    steps = [r[2] for r in st["ranks"]]
    for k, v in steps[0]["params"].items():
        assert torch.equal(steps[1]["params"][k], v), k
    ref.compare_to_port_step(steps[0], want, scale=FLOAT64_SCALE)
