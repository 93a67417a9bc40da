"""The port's data parallelism (parallel/) on gloo ranks on the CPU.

Each multi-rank test spawns its ranks through ``parallel/launch.py`` (fresh
processes, one intra-op thread each, a hard timeout) running
tests/torch_parallel_ranks.py, which imports no JAX; the references run in
the pytest process: the port's one-process functions on the global batch,
and the JAX package's sharded functions on conftest's fake devices.

Model: the slim D0 (B0 backbone, BiFPN and heads at width 16, depth 2,
128 px, 6 classes) with stochastic depth on (survival 0.8), weights drawn
with numpy and bridged from the JAX tree (tests/torch_parallel_ref.py, which
also states the tolerances). The JAX comparison of the training step turns
stochastic depth off (the two packages draw different numbers).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from efficientdet_tpu.configs import EvalConfig as JEvalConfig
from efficientdet_tpu.configs import TrainConfig as JTrainConfig
from efficientdet_tpu.models.detector import EfficientDet as JEfficientDet
from efficientdet_tpu.parallel import make_mesh as j_make_mesh
from efficientdet_tpu.parallel import make_sharded_predict_fn as j_sharded_predict
from efficientdet_tpu.parallel import make_sharded_train_step as j_sharded_step
from efficientdet_tpu.parallel import shard_batch as j_shard_batch
from efficientdet_tpu.train_lib import TrainState as JTrainState
from efficientdet_tpu.train_lib import make_optimizer as j_make_optimizer
import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.data.device_cache import cache_order
from efficientdet_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    data_sharding,
    make_mesh,
    make_sharded_predict_fn,
    make_sharded_train_step,
    replicate,
    shard_batch,
)
from efficientdet_tpu_torch.parallel import collectives as C
from efficientdet_tpu_torch.parallel.launch import free_port, spawn
from efficientdet_tpu_torch.parallel import tolerances as T
from efficientdet_tpu_torch.parallel.tolerances import FLOAT64_SCALE
import torch_parallel_ranks as R
import torch_parallel_ref as ref

SIZE = 128
NUM_CLASSES = 6
RANKS = "tests/torch_parallel_ranks.py"
TIMEOUT = 150  # seconds a spawn may take, its ranks' start-up included


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test processes on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def slim():
    """The slim D0's JAX config, bridged weights and the ranks' spec."""
    cfg = ref.jax_config(SIZE, NUM_CLASSES)
    variables = ref.draw_variables(JEfficientDet(config=cfg), SIZE, seed=0)
    spec = ref.spec_of(cfg)
    return {"cfg": cfg, "variables": variables, "spec": spec,
            "state": ref.port_state(spec, variables)}


def _one_process(spec, state, batches, train_config, seed=0):
    model = R.build_model(spec, state).train()
    tc = et.TrainConfig(**train_config)
    return R.run_steps(model, tc, et.make_train_step(model, tc, "cpu"), batches, seed)


def test_mesh_and_shard_batch_in_process(monkeypatch):
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert mesh.shape == {MODEL_AXIS: 1, DATA_AXIS: 1}
    with pytest.raises(NotImplementedError):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(device="cpu", world_size=2, rank=0)
    mesh = make_mesh(device="cpu", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                     rank=0, timeout_s=30)
    try:
        assert mesh.group is not None and mesh.backend == "gloo"
        batch = shard_batch({"images": np.ones((3, 4, 4, 3), np.uint8),
                             "gt_labels": np.zeros((3, 2), np.int32)}, mesh)
        assert batch["images"].dtype == torch.uint8 and batch["images"].device.type == "cpu"
        assert data_sharding(mesh).rows(5) == (0, 5) and replicate(mesh).rows(5) == (0, 5)
        x = torch.arange(6.0).view(2, 3)
        assert torch.equal(C.sum_over_ranks([x], mesh.group)[0], x)
        whole, empty = C.gather_rows([x, x[:0]], 0, [(0, 2, 2), (0, 0, 0)], mesh.group)
        assert torch.equal(whole, x) and empty.shape == (0, 3)
        monkeypatch.setattr(C, "BUCKET_BYTES", 8)  # a bucket a tensor
        assert all(torch.equal(a, b) for a, b in zip(C.all_reduce_grads([x, 2 * x], mesh.group),
                                                     [x, 2 * x]))
    finally:
        mesh.close()
    assert make_mesh(device="cpu").group is None


def test_step_tolerance_rules():
    """parallel/tolerances.py on made-up steps: the gradient in units of its
    tolerance, a zero reference, and the float64-anchored rule, model-wide."""
    exact = {"a": torch.tensor([1.0, -2.0], dtype=torch.float64),
             "b": torch.tensor([0.5], dtype=torch.float64)}
    tol = T.grad_tolerances(exact)
    assert tol["a"] == pytest.approx(1e-4 * 2 + 1e-6 * 2) and tol["b"] == pytest.approx(
        1e-4 * 0.5 + 1e-6 * 2)
    ref_mu = {"a": exact["a"] + torch.tensor([0.0, 2 * tol["a"]], dtype=torch.float64),
              "b": exact["b"].clone()}
    got_mu = {"a": exact["a"].clone(), "b": exact["b"] + 5 * tol["b"]}
    ratio, leaf = T.grad_against_exact(got_mu, ref_mu, exact)
    assert leaf == "b" and ratio == pytest.approx(5 / (1 + 2 * 2))
    metrics = {"loss": 2.0, "cls_loss": 1.5, "box_loss": 0.5, "num_positives": 3.0,
               "grad_norm": 4.0}
    stats = {"bn.running_var": torch.tensor([1.0, 0.0])}
    params = {"a": torch.tensor([0.1, 0.2]), "b": torch.tensor([0.3])}
    want = (metrics, exact, stats, params)
    same = T.step_errors(want, want, lr=1e-3)
    assert T.step_holds(same) and same["grad"] == 0.0
    off = T.step_errors((dict(metrics, box_loss=0.5 * (1 + 3e-5)), got_mu, stats, params), want,
                        lr=1e-3)
    assert off["grad"] == pytest.approx(5) and off["grad_worst_leaf"] == "b"
    assert off["loss"] == pytest.approx(3) and not T.step_holds(off)
    zero = dict(metrics, box_loss=0.0)
    assert T.step_errors((dict(zero, box_loss=1e-12), exact, stats, params),
                         (zero, exact, stats, params), lr=1e-3)["loss"] == float("inf")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_equals_the_one_process_step(slim, world):
    """Stochastic depth and the device augmenter on: N ranks draw what one
    process draws for the concatenated batch, normalise with its BN
    statistics and positive count, and sum its gradients."""
    batches = [ref.torch_batch(ref.synth_batch(1, 4, SIZE, NUM_CLASSES, uint8=True))]
    tc = {"batch_size": 4, "learning_rate": ref.LR, "device_augment": True}
    want = _one_process(slim["spec"], slim["state"], batches, tc, seed=3)
    got = spawn(f"{RANKS}:train_steps", world, dict(
        spec=slim["spec"], state=slim["state"], batches=batches, train_config=tc, mode="data",
        seed=3), device="cpu", timeout_s=TIMEOUT)
    for r in range(1, world):  # replicated without a broadcast
        for k, v in got[0]["params"].items():
            assert torch.equal(got[r]["params"][k], v), k
        assert got[r]["metrics"] == got[0]["metrics"]
    ref.compare_to_port_step(got[0], want)


def test_sharded_step_in_float64_equals_the_one_process_step(slim):
    """The same two-rank step in float64 against the one-process float64
    step, at FLOAT64_SCALE of the tolerances: regrouping the sums over the
    ranks moves a float64 step by about 1e-12, so a larger difference in any
    leaf (a gradient, a BN statistic) would be a defect, not rounding."""
    spec = dict(slim["spec"], dtype="float64")
    batches = [ref.torch_batch(ref.synth_batch(1, 4, SIZE, NUM_CLASSES, uint8=True))]
    tc = {"batch_size": 4, "learning_rate": ref.LR, "device_augment": True}
    want = _one_process(spec, slim["state"], batches, tc, seed=3)
    got = spawn(f"{RANKS}:train_steps", 2, dict(
        spec=spec, state=slim["state"], batches=batches, train_config=tc, mode="data",
        seed=3), device="cpu", timeout_s=TIMEOUT)
    assert got[0]["mu"]["bifpn.layer0.p3_out.conv.pointwise.weight"].dtype == torch.float64
    ref.compare_to_port_step(got[0], want, scale=FLOAT64_SCALE)


def test_sharded_step_matches_jax(slim):
    """Stochastic depth off, no augmenter: two ranks against the JAX
    package's make_sharded_train_step on a two-device mesh (the setup of
    tests/test_train.py::TestShardedTrain): loss rtol 1e-4, gradients, BN
    statistics and parameters at PR 6's tolerances."""
    cfg = dataclasses.replace(slim["cfg"], survival_prob=1.0)
    spec = ref.spec_of(cfg)
    model = JEfficientDet(config=cfg)
    jtc = JTrainConfig(batch_size=4, learning_rate=ref.LR)
    mesh = j_make_mesh(jax.devices()[:2])
    params = slim["variables"]["params"]
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=slim["variables"]["batch_stats"],
                        opt_state=j_make_optimizer(jtc).init(params), ema_params=None,
                        lr_scale=jnp.ones((), jnp.float32))
    batch = ref.synth_batch(2, 4, SIZE, NUM_CLASSES)
    step = j_sharded_step(model, jtc, mesh, donate_state=False)
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    new, metrics = step(jax.device_put(state, repl), j_shard_batch(batch, mesh),
                        jax.random.PRNGKey(1))
    adam = [s for s in jax.tree.leaves(new.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
    got = spawn(f"{RANKS}:train_steps", 2, dict(
        spec=spec, state=ref.port_state(spec, slim["variables"]), batches=[ref.torch_batch(batch)],
        train_config={"batch_size": 4, "learning_rate": ref.LR}, mode="data"),
        device="cpu", timeout_s=TIMEOUT)
    ref.compare_step(got[0], jax.tree.map(np.asarray, metrics), ref.as_port(adam.mu),
                     ref.as_port(new.batch_stats, "batch_stats"), ref.as_port(new.params),
                     loss_rel=1e-4)


def test_sharded_predict(slim):
    """Two ranks, f32: each rank's rows equal predict_pipeline on those rows
    bit for bit (a batch of 5: 3 + 2; a batch of 1: rank 1's share empty),
    every rank holds the whole batch's detections; against
    predict_pipeline on the whole batch counts and classes are exact, boxes
    within 1e-4 px and scores 1e-6 (the CPU's convolutions pick their
    blocking by batch size: 7.6e-6 px and 3.0e-8 on this model); against
    the JAX package's make_sharded_predict_fn, tests/test_predict.py's
    tolerance (scores 1e-5, counts exact)."""
    images = np.random.RandomState(1).randint(0, 255, (5, SIZE, SIZE, 3)).astype(np.uint8)
    ec = {"max_detections": 10, "pre_nms_top_k": 100}
    x = torch.from_numpy(images)
    calls = [("predict", dict(spec=slim["spec"], state=slim["state"], images=batch, mode="data",
                              eval_config=ec)) for batch in (x, x[:1])]
    got = [r["results"] for r in spawn(f"{RANKS}:many", 2, dict(calls=calls), device="cpu",
                                       timeout_s=TIMEOUT)]
    model = R.build_model(slim["spec"], slim["state"])
    for c in range(2):  # 3 + 2 images, then 1 + 0 (rank 1's share empty)
        assert all(torch.equal(a, b) for a, b in zip(got[0][c]["dets"], got[1][c]["dets"]))
    per_rank = [et.predict_pipeline(model, x[lo:hi], et.EvalConfig(**ec))
                for lo, hi in ((0, 3), (3, 5))]
    ref.assert_detections(got[0][0]["dets"], [torch.cat(p) for p in zip(*per_rank)])
    ref.assert_detections(got[0][1]["dets"], et.predict_pipeline(model, x[:1], et.EvalConfig(**ec)))
    got = got[0]
    ref.assert_detections(got[0]["dets"], et.predict_pipeline(model, x, et.EvalConfig(**ec)),
                          box_tol=1e-4, score_tol=1e-6)
    jmesh = j_make_mesh()
    jpred = j_sharded_predict(JEfficientDet(config=slim["cfg"]), jmesh, JEvalConfig(**ec))
    # JAX splits the batch over its 8 devices: a batch of 8
    images8 = np.concatenate([images, images[:3]])
    want = [np.asarray(t)[:5] for t in jpred(slim["variables"], images8)]
    np.testing.assert_allclose(got[0]["dets"][1].numpy(), want[1], atol=1e-5)
    np.testing.assert_array_equal(got[0]["dets"][3].numpy(), want[3])


def test_device_cache_over_the_mesh():
    """5 images over 2 ranks: the pool wrap-pads to 6, each rank keeps 3;
    get_batch gives each rank its rows of the batch, equal to the unsharded
    cache's (tests/test_device_cache.py::TestShardedPool)."""
    idx = [3, 0, 4, 4, 1, 2]
    got = spawn(f"{RANKS}:device_cache", 2, dict(n=5, indices=idx, batch_size=8),
                device="cpu", timeout_s=TIMEOUT)
    plain = et.DeviceDataCache(R.ArrayDataset(5), target_size=64, max_gt=5, device="cpu")
    want = plain.get_batch(idx)
    first = plain.get_batch(next(cache_order(5, 8, seed=0, drop_last=False)))
    per_image = plain.nbytes() // 5
    for r, (lo, hi) in enumerate(((0, 3), (3, 6))):
        res = got[r]
        assert res["len"] == 5
        assert res["local_nbytes"] == 3 * per_image and res["nbytes"] == 6 * per_image
        for k, v in want.items():
            assert torch.equal(res["batch"][k], v[lo:hi]), k
        flo, fhi = (0, 4) if r == 0 else (4, 8)
        for k, v in first.items():
            assert torch.equal(res["first"][k], v[flo:fhi]), k


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("csvmesh")
    rng = np.random.RandomState(0)
    rows = []
    for i, (w, h) in enumerate([(160, 120), (96, 128), (128, 128), (200, 100)]):
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(root / f"img{i}.png")
        rows.append(f"img{i}.png,10,12,{w // 2},{h // 2},thing")
        rows.append(f"img{i}.png,{w // 3},{h // 3},{w - 5},{h - 5},widget")
    (root / "annots.csv").write_text("\n".join(rows) + "\n")
    (root / "classes.csv").write_text("thing,0\nwidget,1\n")
    return root


def test_train_cli_over_two_ranks(csv_dir, tmp_path):
    """train.py's loop on two ranks: a global batch of 2 (one image a rank),
    two epochs of one step with the VOC evaluation and a plateau patience of
    1: both ranks report the same losses, mAP and learning-rate decision
    (rank 0's mAP, broadcast), and rank 0 alone writes the snapshot
    directory. A global batch that does not divide by the ranks exits."""
    argv = ["csv", str(csv_dir / "annots.csv"), str(csv_dir / "classes.csv"), "--device", "cpu",
            "--image-size", "128", "--batch-size", "2", "--epochs", "2", "--steps", "1",
            "--val-annotations-path", str(csv_dir / "annots.csv"), "--reduce-lr-patience", "1",
            "--snapshot-path", str(tmp_path / "ck{rank}")]
    got = spawn(f"{RANKS}:train_cli", 2, dict(argv=argv), device="cpu", timeout_s=TIMEOUT)
    assert got[0]["history"] == got[1]["history"]
    assert [h["step"] for h in got[0]["history"]] == [1, 2] and got[0]["step"] == 2
    first, second = (h["mAP"] for h in got[0]["history"])
    assert got[0]["history"][-1]["lr_scale"] == pytest.approx(0.1 if second <= first else 1.0)
    assert {"train_config.json", "train_log.jsonl"} <= set(got[0]["files"])
    assert any(f.isdigit() for f in got[0]["files"])
    assert got[1]["files"] == [] and not os.path.exists(tmp_path / "ck1")
    with pytest.raises(RuntimeError, match="not divisible"):
        spawn(f"{RANKS}:train_cli", 2, dict(argv=[a if a != "2" else "3" for a in argv]),
              device="cpu", timeout_s=TIMEOUT)
