"""The port's training step against the JAX package's, on the CPU.

One JAX train-step program (module fixture): EfficientDet on the
``efficientnet-tiny`` backbone, BiFPN and heads at width 16, depth 1,
128 px, 4 classes, batch 2, stochastic depth off (``survival_prob=1.0``),
TrainConfig defaults (Adam 1e-3, per-level loss). Both packages start from
the same weights, drawn with numpy from a seed (fan-in normal; the JAX
package's own initialiser makes every class logit equal the prior, so two
independent inits cannot be compared) and bridged into the port by
``utils/convert.py``; the images are uniform(-1, 1) noise with the boxes
painted in (all-zero images give the JAX step an infinite gradient norm).

Tolerances: loss and its parts within 1e-5 relative; the gradient, read
from Adam's first moment after the first step (mu = (1 - b1) g, in both
packages), within 1e-4 of each leaf's largest |g| plus NOISE = 1e-6 of the
model's largest |g|; the new BN statistics within 1e-5; the new parameters
within 1e-5 where |g| is above both 1e-3 of the leaf's largest and NOISE, and
within 2 lr elsewhere (Adam's first update is about lr sign(g), and a
gradient at the level of float32 summation noise may change sign). NOISE is
float32 summation noise: a bias that feeds a training-mode BN (a conv bias
before its BN, a BN bias before the next block's BN) has an exactly zero
gradient, which both packages compute as noise of about 1e-7.
The optimizer alone is held against optax's chain on identical gradients
within 1e-6 of the learning rate; the schedules within 1e-6 relative.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from efficientdet_tpu.configs import ModelConfig as JModelConfig
from efficientdet_tpu.configs import TrainConfig as JTrainConfig
from efficientdet_tpu.configs import train_config_from_snapshot as j_from_snapshot
from efficientdet_tpu.models.detector import EfficientDet as JEfficientDet
from efficientdet_tpu.train_lib import TrainState as JTrainState
from efficientdet_tpu.train_lib import make_eval_loss_fn as j_make_eval_loss_fn
from efficientdet_tpu.train_lib import make_learning_rate_fn as j_lr_fn
from efficientdet_tpu.train_lib import make_optimizer as j_make_optimizer
from efficientdet_tpu.train_lib import make_train_step as j_make_train_step
import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.configs import train_config_from_snapshot
from efficientdet_tpu_torch.models.detector import init_weights
from efficientdet_tpu_torch.models.efficientnet import MBConvBlock
from efficientdet_tpu_torch.train_lib import make_learning_rate_fn, make_optimizer
from efficientdet_tpu_torch.utils.checkpoint import CheckpointManager
from efficientdet_tpu_torch.utils.convert import (
    adam_state_from_optax,
    from_flax_variables,
    load_flax_variables,
)

SIZE = 128
NUM_CLASSES = 4
LR = 1e-3
LOSS_REL = 1e-5
GRAD_TOL = 1e-4
STAT_TOL = 1e-5
PARAM_TOL = 1e-5
SMALL_GRAD = 1e-3
NOISE = 1e-6
OPT_TOL = 1e-6


def _jax_config(survival_prob=1.0):
    return dataclasses.replace(
        JModelConfig.for_phi(0, num_classes=NUM_CLASSES, image_size=SIZE),
        backbone="efficientnet-tiny", bifpn_width=16, bifpn_depth=1, head_depth=1,
        survival_prob=survival_prob,
    )


def _port_config(cfg, **changes):
    fields = {f.name for f in dataclasses.fields(et.ModelConfig)} - {"anchor"}
    return dataclasses.replace(et.ModelConfig(**{k: getattr(cfg, k) for k in fields}), **changes)


def _draw_variables(model, rng):
    """Every leaf drawn with numpy (shapes from eval_shape: no init compile)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))

    def draw(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        name, shape = keys[-1], leaf.shape
        if name == "kernel":
            return rng.normal(0, (1.5 / int(np.prod(shape[:-1]))) ** 0.5, shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "fusion_weights":
            return rng.uniform(0.2, 1.5, shape).astype(np.float32)
        if name == "bias" and "class_net" in keys and "final" in keys:
            return rng.normal(-4.6, 0.3, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def synth_batch(rng, batch=2, size=SIZE, num_classes=NUM_CLASSES, max_gt=8):
    """tests/test_train.py's synthetic batch: uniform(-1, 1) images with one
    box each, painted in."""
    images = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    gt_boxes = np.zeros((batch, max_gt, 4), np.float32)
    gt_labels = np.full((batch, max_gt), -1, np.int32)
    for i in range(batch):
        x1, y1 = rng.randint(0, size // 2, 2)
        w, h = rng.randint(size // 4, size // 2, 2)
        gt_boxes[i, 0] = [x1, y1, min(x1 + w, size - 1), min(y1 + h, size - 1)]
        gt_labels[i, 0] = rng.randint(0, num_classes)
        images[i, y1:y1 + h, x1:x1 + w, :] += 1.0
    return {"images": images, "gt_boxes": gt_boxes, "gt_labels": gt_labels}


def _adam_leaves(opt_state):
    return [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _as_port(tree, coll="params"):
    """A flax tree -> numpy arrays by the port's state-dict names."""
    return {k: v.numpy() for k, v in from_flax_variables({coll: _np_tree(tree)}).items()}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test processes on the host's
    cores, and a team of threads in each stalls its parallel regions (the
    B0 steps below ran 90x slower that way than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """The JAX model, weights and two steps of its one compiled program."""
    cfg = _jax_config()
    model = JEfficientDet(config=cfg)
    variables = _np_tree(_draw_variables(model, np.random.RandomState(0)))
    tc = JTrainConfig(batch_size=2, learning_rate=LR)
    tx = j_make_optimizer(tc)
    state0 = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                         batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
                         ema_params=None, lr_scale=jnp.ones((), jnp.float32))
    step = jax.jit(j_make_train_step(model, tc))
    batches = [synth_batch(np.random.RandomState(s)) for s in (0, 1)]
    state1, m1 = step(state0, batches[0], jax.random.PRNGKey(0))
    state2, m2 = step(state1, batches[1], jax.random.PRNGKey(0))
    return dict(cfg=cfg, model=model, variables=variables, tc=tc, state0=state0, batches=batches,
                states=(state1, state2), metrics=(_np_tree(m1), _np_tree(m2)))


def _port_model(ref, **changes):
    model = et.EfficientDet(_port_config(ref["cfg"], **changes))
    return load_flax_variables(model, ref["variables"]).eval()


def _snapshot(state):
    """Copies of what a step changes: params, BN statistics, Adam moments."""
    return ({k: v.detach().clone() for k, v in state.params.items()},
            {k: v.clone() for k, v in state.batch_stats.items()},
            {k: v.clone() for k, v in state.opt_state["mu"].items()})


def _rel(got, want, tol=LOSS_REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * abs(want), (got, want)


def _compare_step(port_state, port_metrics, jstate, jmetrics, jgrad_mu):
    """Metrics, gradients (as mu), BN statistics and parameters of a port step
    against a JAX step. Returns the share of elements whose gradient is
    below SMALL_GRAD of their leaf's largest or NOISE (held within 2 lr)."""
    for k in ("loss", "cls_loss", "box_loss", "num_positives"):
        _rel(port_metrics[k], jmetrics[k])
    _rel(port_metrics["grad_norm"], jmetrics["grad_norm"], GRAD_TOL)
    mu = _as_port(jgrad_mu)
    noise = NOISE * max(np.abs(v).max() for v in mu.values())
    for k, want in mu.items():
        got = port_state.opt_state["mu"][k].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max() + noise,
                                   err_msg=k)
    stats = _as_port(jstate.batch_stats, "batch_stats")
    for k, want in stats.items():
        np.testing.assert_allclose(port_state.batch_stats[k].numpy(), want, rtol=STAT_TOL,
                                   atol=STAT_TOL * np.abs(want).max(), err_msg=k)
    params = _as_port(jstate.params)
    small = total = 0
    for k, want in params.items():
        got = port_state.params[k].detach().numpy()
        g = np.abs(mu[k])
        big = g > max(SMALL_GRAD * g.max(), noise)
        diff = np.abs(got - want)
        assert (diff[big] <= PARAM_TOL).all(), (k, diff[big].max())
        assert (diff[~big] <= 2 * LR * 1.0001).all(), (k, diff[~big].max())
        small += int((~big).sum())
        total += g.size
    return small / total


def test_one_step_matches_jax(ref):
    port = _port_model(ref)
    tc = et.TrainConfig(batch_size=2, learning_rate=LR)
    state = et.create_train_state(port, tc, device="cpu")
    step = et.make_train_step(port, tc, device="cpu")
    state, metrics = step(state, ref["batches"][0])
    assert state.step == 1 and state.opt_state["count"] == 1
    assert all(v.dim() == 0 and v.dtype == torch.float32 for v in metrics.values())
    jstate = ref["states"][0]
    share = _compare_step(state, metrics, jstate, ref["metrics"][0], _adam_leaves(jstate.opt_state).mu)
    print(f"elements with |g| below {SMALL_GRAD} of their leaf's largest or the noise: {share:.4%}")
    assert share < 0.25


def test_second_step_from_the_bridged_jax_state(ref):
    """Step 2 from JAX's step-1 state (params, BN statistics, Adam's moments
    and count, bridged by utils/convert.py) against JAX's step 2."""
    state1 = ref["states"][0]
    port = _port_model(ref)
    load_flax_variables(port, {"params": _np_tree(state1.params),
                               "batch_stats": _np_tree(state1.batch_stats)})
    tc = et.TrainConfig(batch_size=2, learning_rate=LR)
    state = et.create_train_state(port, tc, device="cpu")
    adam = _adam_leaves(state1.opt_state)
    state = state.replace(step=1, opt_state=adam_state_from_optax(
        _np_tree(adam.mu), _np_tree(adam.nu), int(adam.count), device="cpu"))
    state, metrics = et.make_train_step(port, tc, device="cpu")(state, ref["batches"][1])
    assert state.opt_state["count"] == 2
    jstate = ref["states"][1]
    jmu = _adam_leaves(jstate.opt_state).mu
    # mu now mixes two steps' gradients: compare it as it is, and the
    # parameters with the step-2 gradient's size taken from mu
    _compare_step(state, metrics, jstate, ref["metrics"][1], jmu)


def test_eval_loss_matches_jax(ref):
    want = _np_tree(jax.jit(j_make_eval_loss_fn(ref["model"], ref["tc"]))(ref["state0"], ref["batches"][1]))
    port = _port_model(ref)
    tc = et.TrainConfig()
    state = et.create_train_state(port, tc, device="cpu")
    before = _snapshot(state)
    got = et.make_eval_loss_fn(port, tc, device="cpu")(state, ref["batches"][1])
    assert set(got) == set(want)
    for k in want:
        _rel(got[k], want[k])
    assert not port.training
    for a, b in zip(before[:2], _snapshot(state)[:2]):
        assert all(torch.equal(a[k], b[k]) for k in a)  # no update, no BN statistics moved


# -- port-only properties of the step -----------------------------------------

def _run(ref, tc, steps=1, gen_seed=None, batch=0, **model_changes):
    port = _port_model(ref, **model_changes)
    state = et.create_train_state(port, tc, device="cpu")
    step = et.make_train_step(port, tc, device="cpu")
    gen = None if gen_seed is None else torch.Generator().manual_seed(gen_seed)
    metrics = []
    for _ in range(steps):
        state, m = step(state, ref["batches"][batch], gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return port, state, metrics


def test_per_level_and_concat_paths_agree(ref):
    _, a, ma = _run(ref, et.TrainConfig(per_level_loss=True))
    _, b, mb = _run(ref, et.TrainConfig(per_level_loss=False))
    for k in ("loss", "cls_loss", "box_loss", "grad_norm"):
        _rel(ma[0][k], mb[0][k], 1e-6)
    for k, v in a.opt_state["mu"].items():
        torch.testing.assert_close(v, b.opt_state["mu"][k], rtol=1e-5, atol=1e-6 * float(v.abs().max()))


def test_freeze_backbone(ref):
    port = _port_model(ref)
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    _, state, _ = _run(ref, et.TrainConfig(freeze_backbone=True))
    for k, v in state.params.items():
        if k.startswith("backbone."):
            assert torch.equal(v, before[k]), k
            assert not state.opt_state["mu"][k].any()
    assert any(not torch.equal(v, before[k]) for k, v in state.params.items() if k.startswith("class_net."))
    # weight decay still moves the backbone, as in the JAX package
    _, state, _ = _run(ref, et.TrainConfig(freeze_backbone=True, weight_decay=1e-2), steps=2)
    assert any(not torch.equal(v, before[k]) for k, v in state.params.items() if k.startswith("backbone."))
    # and the optimizer's state stays out of autograd's graph
    assert not any(v.requires_grad for m in ("mu", "nu") for v in state.opt_state[m].values())


def test_lr_scale_zero_freezes_the_parameters(ref):
    port = _port_model(ref)
    tc = et.TrainConfig()
    state = et.create_train_state(port, tc, device="cpu").replace(lr_scale=0.0)
    params, stats, _ = _snapshot(state)
    state, _ = et.make_train_step(port, tc, device="cpu")(state, ref["batches"][0])
    assert all(torch.equal(v, params[k]) for k, v in state.params.items())
    assert any(not torch.equal(v, stats[k]) for k, v in state.batch_stats.items())  # BN still moves
    assert state.opt_state["count"] == 1


def test_ema(ref):
    port = _port_model(ref)
    tc = et.TrainConfig(ema_decay=0.75)
    state = et.create_train_state(port, tc, device="cpu")
    ema0 = {k: v.clone() for k, v in state.ema_params.items()}
    step = et.make_train_step(port, tc, device="cpu")
    for _ in range(2):
        state, _ = step(state, ref["batches"][0])
        ema0 = {k: 0.75 * v + 0.25 * state.params[k].detach() for k, v in ema0.items()}
    for k, v in state.ema_params.items():
        torch.testing.assert_close(v, ema0[k], rtol=1e-6, atol=1e-7)
    assert et.create_train_state(port, et.TrainConfig(), device="cpu").ema_params is None


def _b0_model(**changes):
    """The B0 backbone (the tiny one has no residual block with a survival
    below 1), BiFPN and heads at width 16, depth 1, 128 px; random weights."""
    cfg = dataclasses.replace(et.ModelConfig.for_phi(0, num_classes=NUM_CLASSES, image_size=SIZE),
                              bifpn_width=16, bifpn_depth=1, head_depth=1, **changes)
    return init_weights(et.EfficientDet(cfg), seed=0).eval()


def _b0_run(steps, gen_seed, **changes):
    port = _b0_model(**changes)
    tc = et.TrainConfig()
    state = et.create_train_state(port, tc, device="cpu")
    step = et.make_train_step(port, tc, device="cpu")
    gen = torch.Generator().manual_seed(gen_seed)
    batch = synth_batch(np.random.RandomState(3))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return port, state, metrics


def test_remat_matches_no_remat_with_stochastic_depth():
    """remat and no remat: equal losses, gradients and running statistics
    after two steps, with stochastic depth on and one generator seed (the
    keep masks are drawn outside the recomputed blocks)."""
    (_, a, ma), (pb, b, mb) = (_b0_run(2, 7, survival_prob=0.5, remat=remat) for remat in (False, True))
    assert pb.config.remat and pb.backbone.remat_blocks and pb.bifpn.remat and pb.class_net.remat
    assert ma == mb
    for k, v in a.opt_state["mu"].items():
        assert torch.equal(v, b.opt_state["mu"][k]), k
    for k, v in a.batch_stats.items():
        assert torch.equal(v, b.batch_stats[k]), k
    # another seed draws other masks
    _, _, mc = _b0_run(2, 8, survival_prob=0.5)
    assert mc != ma


def test_remat_scopes():
    """build_efficientdet's remat switches, validated as in the JAX package."""
    with pytest.raises(ValueError, match="remat_scope"):
        et.build_efficientdet(0, num_classes=4, image_size=SIZE, remat=True, remat_scope="heads",
                              device="cpu")
    for scope, backbone, fpn in (("full", True, True), ("backbone", True, False), ("fpn", False, True)):
        model, cfg = et.build_efficientdet(0, num_classes=4, image_size=SIZE, remat=True,
                                           remat_scope=scope, remat_max_stage=3, device="cpu")
        assert cfg.remat and cfg.remat_scope == scope and cfg.remat_max_stage == 3
        blocks = {n for n in model.backbone.block_names if int(n[5]) <= 3}
        assert model.backbone.remat_blocks == (blocks if backbone else set())
        assert model.bifpn.remat == model.class_net.remat == model.box_net.remat == fpn
    model, cfg = et.build_efficientdet(0, num_classes=4, image_size=SIZE, device="cpu")
    assert not cfg.remat and not model.backbone.remat_blocks and not model.bifpn.remat


def test_stochastic_depth():
    model = _b0_model(survival_prob=0.8)
    net = model.backbone
    total = len(net.block_names)
    survival = [getattr(net, n).survival_prob for n in net.block_names]
    assert total == 16 and survival == [1.0 - (1.0 - 0.8) * i / total for i in range(total)]
    model.eval()
    assert net.keep_masks(4, "cpu") == {}
    model.train()
    masks = net.keep_masks(20000, "cpu", torch.Generator().manual_seed(0))
    residual = [n for n in net.block_names if getattr(net, n).residual]
    assert len(residual) == 9 and set(masks) == set(residual)
    for name, m in masks.items():
        p = getattr(net, name).survival_prob
        assert m.shape == (20000, 1, 1, 1) and set(m.unique().tolist()) <= {0.0, 1.0}
        assert abs(float(m.mean()) - p) < 4 * (p * (1 - p) / 20000) ** 0.5
    # the kept branch is scaled by 1/survival; a dropped block is the identity
    name = residual[-1]
    block = getattr(net, name).eval()
    assert isinstance(block, MBConvBlock)
    x = torch.randn(3, block.project_conv.weight.shape[0], 8, 8, generator=torch.Generator().manual_seed(1))
    branch = block(x) - x
    keep = torch.tensor([1.0, 0.0, 1.0]).view(3, 1, 1, 1)
    got = block(x, keep)
    torch.testing.assert_close(got[0] - x[0], branch[0] / block.survival_prob)
    assert torch.equal(got[1], x[1])


def test_loss_decreases_overfit(ref):
    """The port's twin of the JAX package's test_loss_decreases_overfit."""
    _, state, metrics = _run(ref, et.TrainConfig(), steps=10)
    losses = [m["loss"] for m in metrics]
    assert np.isfinite(losses).all() and state.step == 10
    assert losses[-1] < losses[0] * 0.8, losses


def test_device_augment_raises(ref, monkeypatch):
    """``device_augment`` raised before the data slice; it now trains. With
    identity matrices and no colour, the augmented step equals the plain one
    on the same uint8 batch: the augmenter's float32 [0, 255] images are
    normalised as uint8 ones are (not fed raw), and the boxes and labels
    pass unchanged."""
    import efficientdet_tpu_torch.ops.augment as augment

    rng = np.random.RandomState(5)
    batch = synth_batch(rng)
    batch["images"] = rng.randint(0, 256, batch["images"].shape).astype(np.uint8)
    batch["extents"] = np.full((2, 2), SIZE, np.float32)
    monkeypatch.setattr(augment, "sample_transform_matrices",
                        lambda generator, b, size, *a, **k: torch.eye(3).expand(b, 3, 3).clone())
    out = []
    for cfg in (et.TrainConfig(), et.TrainConfig(device_augment=True, device_augment_color=False)):
        port = _port_model(ref)
        state = et.create_train_state(port, cfg, device="cpu")
        state, metrics = et.make_train_step(port, cfg, device="cpu")(state, batch)
        out.append((metrics, state))
    (m0, s0), (m1, s1) = out
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in s0.params:
        assert torch.equal(s0.params[k], s1.params[k]), k
    # without the normalisation the loss would differ
    raw = dict(batch, images=batch["images"].astype(np.float32))
    port = _port_model(ref)
    state = et.create_train_state(port, et.TrainConfig(), device="cpu")
    _, m_raw = et.make_train_step(port, et.TrainConfig(), device="cpu")(state, raw)
    assert not torch.equal(m_raw["loss"], m0["loss"])


def test_entry_points_raise_without_gpu(ref, monkeypatch):
    port = _port_model(ref)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (et.create_train_state, et.make_train_step, et.make_eval_loss_fn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(port, et.TrainConfig())


def test_step_rejects_a_foreign_state(ref):
    a, b = _port_model(ref), _port_model(ref)
    state = et.create_train_state(a, et.TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="not this model's"):
        et.make_train_step(b, et.TrainConfig(), device="cpu")(state, ref["batches"][0])


# -- configuration, schedules and the optimizer against optax ------------------

def test_train_config_equals_jax():
    t, j = et.TrainConfig(), JTrainConfig()
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    assert tf == jf
    for saved in (None, {"train": {"batch_size": 4, "lr_schedule": "cosine"}},
                  {"train": {"fused_optimizer": True}}):
        assert dataclasses.asdict(train_config_from_snapshot(saved)) == dataclasses.asdict(
            j_from_snapshot(saved))


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=5),
                                dict(lr_schedule="cosine", warmup_steps=5, epochs=1, steps_per_epoch=20),
                                dict(lr_schedule="cosine", epochs=2, steps_per_epoch=7)],
                         ids=["constant", "warmup", "cosine", "cosine-no-warmup"])
def test_schedules_match_optax(kw):
    port = make_learning_rate_fn(et.TrainConfig(**kw))
    ref = j_lr_fn(JTrainConfig(**kw))
    for count in range(21):
        want = float(ref(jnp.asarray(count, jnp.int32)))
        assert abs(port(count) - want) <= OPT_TOL * max(abs(want), 1e-3 * LR), (count, port(count), want)
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        make_learning_rate_fn(et.TrainConfig(lr_schedule="step"))


OPT_CASES = {
    "adam": dict(),
    "fused": dict(fused_optimizer=True),
    "clip": dict(grad_clip_norm=0.5),
    "clip-untriggered": dict(grad_clip_norm=50.0),
    "decay": dict(weight_decay=1e-2),
    "clip-decay-fused": dict(grad_clip_norm=0.5, weight_decay=1e-2, fused_optimizer=True),
    "multisteps": dict(grad_accum_steps=2),
    "multisteps-fused-warmup": dict(grad_accum_steps=2, fused_optimizer=True, warmup_steps=2),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    """Clip, decay, Adam and MultiSteps on identical gradients, 6 calls."""
    kw = OPT_CASES[case]
    rng = np.random.RandomState(0)
    params = {"w": rng.normal(0, 1, (3, 2)).astype(np.float32),
              "b": rng.normal(0, 1, (2,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 0.5, v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(6)]
    grads[1]["w"][0, 0] = 0.0  # a zero gradient element
    jtx = j_make_optimizer(JTrainConfig(**kw))
    ttx = make_optimizer(et.TrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = ttx.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts, tp)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=0, atol=OPT_TOL * LR,
                                       err_msg=f"{case} {k}")
        jp = optax.apply_updates(jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=6 * OPT_TOL * LR)
    assert ts["count"] == (3 if kw.get("grad_accum_steps") else 6)


def test_fused_and_leafwise_are_the_same_arithmetic():
    """``fused_optimizer`` is kept for the JAX configuration's sake: both of
    its values take the same step, bit for bit."""
    rng = np.random.RandomState(1)
    params = {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)) for k, s in
              (("a", (4, 3)), ("b", (3,)), ("c", (2, 2, 3, 3)))}
    outs = []
    for fused in (False, True):
        tx = make_optimizer(et.TrainConfig(fused_optimizer=fused, weight_decay=1e-3, grad_clip_norm=1.0))
        state = tx.init(params)
        r = np.random.RandomState(2)
        for _ in range(3):
            g = {k: torch.from_numpy(r.normal(0, 1, v.shape).astype(np.float32)) for k, v in params.items()}
            upd, state = tx.update(g, state, params)
        outs.append(upd)
    for k in params:
        assert torch.equal(outs[0][k], outs[1][k]), k


# -- CheckpointManager -----------------------------------------------------------

def _trained(ref, steps=1, tc=None):
    tc = tc or et.TrainConfig(ema_decay=0.5)
    port = _port_model(ref)
    state = et.create_train_state(port, tc, device="cpu")
    step = et.make_train_step(port, tc, device="cpu")
    for _ in range(steps):
        state, _ = step(state, ref["batches"][0])
    return port, state, tc


def _assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        assert a == b


def test_checkpoint_round_trip(ref, tmp_path):
    port, state, tc = _trained(ref, steps=2)
    state = state.replace(lr_scale=0.5)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(2, state, {"loss": torch.tensor(1.5)})
    fresh = _port_model(ref)
    template = et.create_train_state(fresh, tc, device="cpu")
    restored = mgr.restore(template)
    assert restored.step == 2 and restored.lr_scale == 0.5
    for field in ("params", "batch_stats", "opt_state", "ema_params"):
        _assert_trees_equal(getattr(restored, field), getattr(state, field))
    # restored in place: the fresh model now holds the trained weights
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, port.state_dict()[k]), k
    assert mgr.metrics(2) == {"loss": 1.5}
    # and training goes on from there exactly as it would have
    a, _ = et.make_train_step(fresh, tc, device="cpu")(restored, ref["batches"][1])
    b, _ = et.make_train_step(port, tc, device="cpu")(state, ref["batches"][1])
    _assert_trees_equal(a.params, b.params)
    bad = _port_model(ref)
    with pytest.raises(ValueError, match="template"):
        mgr.restore(et.create_train_state(bad, et.TrainConfig(), device="cpu"))  # no EMA there


def test_checkpoint_keep_latest_and_missing(ref, tmp_path):
    _, state, _ = _trained(ref, steps=0)
    mgr = CheckpointManager(str(tmp_path / "keep"), keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    with pytest.raises(FileNotFoundError):
        mgr.restore_partial()
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, state)
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert sorted(os.listdir(mgr.directory)) == ["4", "5"]
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, step=3)


def test_checkpoint_best_only(ref, tmp_path):
    _, state, _ = _trained(ref, steps=0)
    mgr = CheckpointManager(str(tmp_path / "best"), keep=2, best_only=True)
    for s, m in ((1, 0.3), (2, 0.5), (3, 0.1), (4, 0.4), (5, None)):
        mgr.save(s, state, None if m is None else {"mAP": m})
    assert mgr.all_steps() == [2, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_restore_partial(ref, tmp_path):
    port, state, _ = _trained(ref)
    mgr = CheckpointManager(str(tmp_path / "partial"))
    mgr.save(1, state)
    got = mgr.restore_partial()
    assert set(got) == {"params", "batch_stats"}
    _assert_trees_equal(got["params"], {k: v.detach() for k, v in state.params.items()})
    _assert_trees_equal(got["batch_stats"], state.batch_stats)
    fresh = _port_model(ref)
    template = {"params": dict(fresh.named_parameters()), "batch_stats": dict(fresh.named_buffers())}
    mgr.restore_partial(template)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, port.state_dict()[k]), k


def test_predictor_from_a_manager_directory(tmp_path):
    """Predictor.from_checkpoint on a CheckpointManager directory answers
    as the model it was saved from."""
    trained = et.Predictor(phi=0, num_classes=NUM_CLASSES, image_size=SIZE, device="cpu", seed=1,
                           score_threshold=0.0)
    tc = et.TrainConfig()
    state = et.create_train_state(trained.model, tc, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(3, state)
    mgr.save(7, state)
    loaded = et.Predictor.from_checkpoint(str(tmp_path / "run"), phi=0, num_classes=NUM_CLASSES,
                                          image_size=SIZE, device="cpu", seed=0, score_threshold=0.0)
    img = np.random.RandomState(0).randint(0, 256, (96, 120, 3)).astype(np.uint8)
    want = trained(img)
    assert len(want[1]) > 0
    for got, w in zip(loaded(img), want):
        np.testing.assert_array_equal(got, w)
    other = et.Predictor(phi=0, num_classes=NUM_CLASSES, image_size=SIZE, device="cpu", seed=0,
                         score_threshold=0.0)
    assert not all(np.array_equal(a, b) for a, b in zip(other(img), want))
