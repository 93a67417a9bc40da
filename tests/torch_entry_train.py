"""One float32 training step at phi 4 and at phi 7 against the JAX package's, on the CPU.

Shared by ``tests/test_torch_entry_train_d4.py`` and ``..._d7.py``: each
star-imports the tests defined here and names its phi in ``stepped_for``.

Each phi keeps its own backbone (B4, B6), fusion (weighted, unweighted),
anchor scale (4, 5), head depth (4, 5) and BiFPN depth (7, 8). To fit the
tier-1 time budget the image is SIZE px (the phis' own are 1024 and 1536)
and the BiFPN WIDTH channels wide (224 and 384 at full width): the JAX
step's compile and both steps on the CPU grow with them, and neither
changes a branch the step takes. SIZE is 256, not 128: at 128 px P7 is one
pixel, and its training-mode BNs would see two values a channel. 90
classes, batch 2, stochastic depth off (``survival_prob`` 1.0: the two
packages draw different numbers), TrainConfig defaults (Adam 1e-3,
per-level loss).
Weights drawn with numpy over ``jax.eval_shape`` and bridged
(tests/torch_parallel_ref.py: the class head's final bias near the prior),
with the heads' final kernels N(0, FINAL_STD) as RetinaNet initialises
them (at the draw's fan-in scale the class logits reach 18 and the focal
loss is 30 times larger); the batch is tests/test_train.py's (one box an
image, painted in).

Tolerances (``efficientdet_tpu_torch/parallel/tolerances.py``). The loss,
its parts and the BN statistics: the port's float32 step against the JAX
package's by the training step's rules (1e-5). The gradients: at this
depth float32 cannot resolve them to that rule, in either package. A
max-pool window of the BiFPN that holds a near-tie routes its gradient to
the other pixel under another rounding: the port's float32 gradients lie
14 (phi 4) and 2,262 (phi 7) times the rule from its float64 step, 2.4 and
13 times with average pooling in max pooling's place. Such flips make the
rounding heavy-tailed: over the port at one and four threads, the JAX
package, and the JAX package on the batch in reverse order, the float32
gradients lie 5.1e-4 to 9.9e-2 (L2, relative) from the port's float64
step, while their norm stays within 1.3e-3 of it. So each float32 step's
gradient norm is held within 1e-2 relative of the port's float64 step
(``tolerances.deep_step_errors``), which a 1% fault in the fusion nodes'
backward pass exceeds by 9-11 times (``test_a_planted_gradient_fault_fails``:
the gradient of every fusion input but the first scaled by 1.01 in the
phi's kind of node, weighted at phi 4, unweighted at phi 7; the forward
unchanged). Every gradient leaf is held in float64, where no max-pool tie
flips, by the training step's rule: ``python tests/torch_entry_train.py
--float64 4 7`` runs the JAX package's step in float64 (its BN statistics,
SE squeeze and losses, which it computes in float32 whatever the model's
dtype, promoted to float64 in that process) against the port's float64
step: the rule reads 5.5e-4 (phi 4) and 8.4e-4 (phi 7) of the gradient
tolerance, and 1,608 and 1,944 with the planted fault. That takes 20-34
minutes a phi (XLA's float64 convolutions on the CPU), too long for
tier-1.

Then the port against itself at phi 4 with stochastic depth on (survival
0.8): remat up to ``remat_max_stage`` equals no remat after two steps,
bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from efficientdet_tpu.configs import ModelConfig as JModelConfig
from efficientdet_tpu.configs import TrainConfig as JTrainConfig
from efficientdet_tpu.models.detector import EfficientDet as JEfficientDet
from efficientdet_tpu.train_lib import TrainState as JTrainState
from efficientdet_tpu.train_lib import make_optimizer as j_make_optimizer
from efficientdet_tpu.train_lib import make_train_step as j_make_train_step
import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.models.bifpn import FusedNode
from efficientdet_tpu_torch.parallel import tolerances as T
from efficientdet_tpu_torch.utils.convert import load_flax_variables
import torch_parallel_ranks as R
import torch_parallel_ref as ref
from torch_family import one_torch_thread, port_config

SIZE = 256
REMAT_SIZE = 128  # the port against itself, bit for bit: the smallest size
NUM_CLASSES = 90
WIDTH = 64
BATCH = 2
FINAL_STD = 0.01
# the phis' own branches, which the reduced configs keep
KEEPS = {4: dict(backbone="efficientnet-b4", weighted_bifpn=True, anchor_scale=4.0,
                 head_depth=4, bifpn_depth=7),
         7: dict(backbone="efficientnet-b6", weighted_bifpn=False, anchor_scale=5.0,
                 head_depth=5, bifpn_depth=8)}


def jax_config(phi, size=SIZE, survival_prob=1.0):
    return dataclasses.replace(
        JModelConfig.for_phi(phi, num_classes=NUM_CLASSES, image_size=size), bifpn_width=WIDTH,
        survival_prob=survival_prob)


def port_model(cfg, variables, dtype=torch.float32, **changes):
    model = et.EfficientDet(dataclasses.replace(port_config(cfg), **changes), dtype)
    return load_flax_variables(model, variables).to(dtype)


def draw_variables(model, size, seed):
    """tests/torch_parallel_ref.py's draw, then the heads' final kernels
    N(0, FINAL_STD)."""
    variables = ref.draw_variables(model, size, seed)
    rng = np.random.RandomState(seed + 1000)

    def final(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        if "final" in keys and keys[-1] == "kernel":
            return rng.normal(0, FINAL_STD, leaf.shape).astype(np.float32)
        return leaf

    return {**variables, "params": jax.tree_util.tree_map_with_path(final, variables["params"])}


def _adam_mu(opt_state):
    return [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0].mu


def _result(new, metrics):
    """A JAX step's (state, metrics) as (metrics, mu, BN statistics,
    parameters) by the port's names, in float32."""
    return ({k: float(v) for k, v in metrics.items()},
            {k: torch.from_numpy(v) for k, v in ref.as_port(_adam_mu(new.opt_state)).items()},
            {k: torch.from_numpy(v) for k, v in ref.as_port(new.batch_stats, "batch_stats").items()},
            {k: torch.from_numpy(v) for k, v in ref.as_port(new.params).items()})


def jax_step(phi):
    """D``phi``'s reduced config, weights, batch, and one step of the JAX
    package's compiled train step from them."""
    cfg = jax_config(phi)
    variables = draw_variables(JEfficientDet(config=cfg), SIZE, phi)
    batch = ref.synth_batch(phi, BATCH, SIZE, NUM_CLASSES)
    tc = JTrainConfig(batch_size=BATCH, learning_rate=ref.LR)
    v = jax.tree.map(jnp.asarray, variables)
    b = {k: jnp.asarray(x) for k, x in batch.items()}
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=j_make_optimizer(tc).init(v["params"]),
                        ema_params=None, lr_scale=jnp.ones((), jnp.float32))
    step = jax.jit(j_make_train_step(JEfficientDet(config=cfg), tc))

    def result(batch):
        return _result(*step(state, batch, jax.random.PRNGKey(0)))

    return dict(phi=phi, cfg=cfg, variables=variables, batch=batch, result=result(b), step=result)


def port_step(stepped, dtype=torch.float32):
    """The port's step from the same weights on the same batch; float64:
    the model and its arithmetic, on the same float32 images and boxes (a
    step takes images of any other dtype for raw pixels and normalises
    them)."""
    model = port_model(stepped["cfg"], stepped["variables"], dtype).train()
    tc = et.TrainConfig(batch_size=BATCH, learning_rate=ref.LR)
    out = R.run_steps(model, tc, et.make_train_step(model, tc, "cpu"),
                      [ref.torch_batch(stepped["batch"])], seed=0)
    out["buffers"] = {k: v for k, v in out["buffers"].items() if not k.endswith("num_batches_tracked")}
    return out["metrics"][0], out["mu"], out["buffers"], out["params"]


def port_steps(stepped):
    """The port's float32 and float64 steps."""
    return port_step(stepped), port_step(stepped, torch.float64)


class _ScaledGrad(torch.autograd.Function):
    """The identity forward; the gradient times ``FAULT`` backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * FAULT


FAULT = 1.01


def planted_fault(monkeypatch, weighted):
    """Every fusion node of the kind ``weighted`` scales the gradient of
    each input but the first by FAULT; its forward is unchanged."""
    forward = FusedNode.forward

    def faulty(node, inputs):
        if node.weighted == weighted:
            inputs = [inputs[0]] + [_ScaledGrad.apply(t) for t in inputs[1:]]
        return forward(node, inputs)

    monkeypatch.setattr(FusedNode, "forward", faulty)


def stepped_for(phi):
    """The module's ``stepped`` fixture: the JAX step of D``phi``."""
    @pytest.fixture(scope="module")
    def stepped():
        return jax_step(phi)
    return stepped


# The tests: ``from torch_entry_train import *`` in a file that sets
# ``stepped = stepped_for(phi)``.
__all__ = ["one_torch_thread", "stepped_for", "port", "test_reduced_config_keeps_the_phis_branches",
           "test_one_step_matches_jax", "test_a_planted_gradient_fault_fails"]


@pytest.fixture(scope="module")
def port(stepped):
    """The port's float32 and float64 steps of the module's D``phi``."""
    return port_steps(stepped)


def test_reduced_config_keeps_the_phis_branches(stepped):
    cfg = stepped["cfg"]
    for key, value in KEEPS[stepped["phi"]].items():
        got = cfg.anchor.anchor_scale if key == "anchor_scale" else getattr(cfg, key)
        assert got == value, key
    port = port_model(cfg, stepped["variables"])
    fusion = [k for k in port.state_dict() if k.endswith("fusion_weights")]
    assert bool(fusion) == cfg.weighted_bifpn


def test_one_step_matches_jax(stepped, port):
    """The port's float32 step against the JAX package's from the same
    weights on the same batch: loss, its parts, the positives (the anchor
    scale reaches the targets) and the BN statistics by the training
    step's rules; both float32 steps' gradient norms against the port's
    float64 step (``deep_step_errors``)."""
    got, exact = port
    assert stepped["result"][0]["num_positives"] > 0
    plain = T.step_errors(got, stepped["result"], ref.LR)
    assert T.step_holds(plain, ("loss", "bn_stats")), plain
    for name, step in (("jax", stepped["result"]), ("port", got)):
        errors = T.deep_step_errors(step, exact, ref.LR)
        assert T.step_holds(errors, T.DEEP_HELD), (name, errors)


def test_a_planted_gradient_fault_fails(stepped, port):
    """The rule has the power to fail: a 1% fault in the backward pass of
    the phi's fusion nodes, in the port's float64 step, moves the JAX
    package's gradient norm past its tolerance; the forward, so the loss
    and the BN statistics, stay within theirs."""
    with pytest.MonkeyPatch.context() as mp:
        planted_fault(mp, stepped["cfg"].weighted_bifpn)
        exact = port_step(stepped, torch.float64)
    errors = T.deep_step_errors(stepped["result"], exact, ref.LR)
    assert errors["grad_norm"] > 1.0, errors
    assert errors["loss"] <= 1.0 and errors["bn_stats"] <= 1.0, errors


def test_remat_matches_no_remat_with_stochastic_depth():
    """Phi 4 at REMAT_SIZE, survival 0.8, one generator seed: remat of the
    backbone's stages up to 5 (``remat_max_stage``; the BiFPN and heads
    too) and no remat give equal losses, gradients, BN statistics and
    parameters after two steps (the keep masks are drawn outside the
    recomputed blocks)."""
    cfg = jax_config(4, REMAT_SIZE, survival_prob=0.8)
    variables = draw_variables(JEfficientDet(config=cfg), REMAT_SIZE, 4)
    batches = [ref.torch_batch(ref.synth_batch(s, BATCH, REMAT_SIZE, NUM_CLASSES)) for s in (4, 5)]
    tc = et.TrainConfig(batch_size=BATCH)
    out = []
    for remat in (False, True):
        model = port_model(cfg, variables, remat=remat, remat_max_stage=5).train()
        out.append(R.run_steps(model, tc, et.make_train_step(model, tc, "cpu"), batches, seed=7))
    remat_blocks = model.backbone.remat_blocks
    assert remat_blocks and all(int(n[5]) <= 5 for n in remat_blocks)
    assert len(remat_blocks) < len(model.backbone.block_names)
    assert model.bifpn.remat and model.class_net.remat and model.box_net.remat
    a, b = out
    assert a["metrics"] == b["metrics"]
    for key in ("mu", "buffers", "params"):
        for k, v in a[key].items():
            assert torch.equal(v, b[key][k]), (key, k)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: substituted into
    the JAX package's normalization, efficientnet and losses modules by
    :func:`jax_step_float64`, where they cast to float32 whatever the
    model's dtype."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def jax_step_float64(stepped):
    """The JAX package's step of ``stepped`` in float64 throughout: its
    variables and model in float64, the batch as it is (float32 images,
    which the step takes as normalised), under ``jax.enable_x64``, with the
    float32 casts of its BN, SE squeeze and losses promoted; the result
    rounded to float32, as :func:`jax_step`'s."""
    from efficientdet_tpu import losses as jlosses
    from efficientdet_tpu.models import efficientnet as jeffnet
    from efficientdet_tpu.models import normalization as jnorm

    cfg, tc = stepped["cfg"], JTrainConfig(batch_size=BATCH, learning_rate=ref.LR)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for module in (jnorm, jeffnet, jlosses):
            mp.setattr(module, "jnp", _Float64Numpy())
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stepped["variables"])
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                            batch_stats=v["batch_stats"], opt_state=j_make_optimizer(tc).init(v["params"]),
                            ema_params=None, lr_scale=jnp.ones((), jnp.float64))
        step = jax.jit(j_make_train_step(JEfficientDet(config=cfg, dtype=jnp.float64), tc))
        return _result(*step(state, {k: jnp.asarray(x) for k, x in stepped["batch"].items()},
                             jax.random.PRNGKey(0)))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_entry_train.py [--float64] [PHI ...]:
    # one JSON line a phi: deep_step_errors of both float32 steps, each
    # float32 step's relative L2 distance from the port's float64 step
    # (the whole gradient and by part), the same with average pooling in
    # place of the BiFPN's max pooling (the port only), and the planted
    # fault's; with --float64 also the JAX package's float64 step against
    # the port's by the training step's rule, true and with the fault
    import json
    import sys
    import time

    import torch.nn.functional as F

    from efficientdet_tpu_torch.models import bifpn as port_bifpn

    def distances(got, exact):
        out = {}
        for part in ("backbone", "bifpn", "class_net", "box_net", "all"):
            keys = [k for k in exact[1] if part == "all" or k.startswith(part + ".")]
            d = sum(float((got[1][k].double() - exact[1][k].double()).norm()) ** 2 for k in keys)
            n = sum(float(exact[1][k].double().norm()) ** 2 for k in keys)
            out[part] = (d / n) ** 0.5
        out["grad_norm"] = abs(got[0]["grad_norm"] / exact[0]["grad_norm"] - 1.0)
        return out

    def avg_pooled(x):
        return F.avg_pool2d(F.pad(x, (0, x.shape[-1] % 2, 0, x.shape[-2] % 2)), 2, 2)

    jax.config.update("jax_platforms", "cpu")
    float64 = "--float64" in sys.argv
    for phi in [int(a) for a in sys.argv[1:] if a != "--float64"] or [4, 7]:
        torch.set_num_threads(1)  # as the tests run
        want = jax_step(phi)
        got, exact = port_steps(want)
        reversed_jax = want["step"]({k: jnp.asarray(x[::-1]) for k, x in want["batch"].items()})
        torch.set_num_threads(4)
        got4 = port_step(want)
        torch.set_num_threads(1)
        with pytest.MonkeyPatch.context() as mp:
            planted_fault(mp, want["cfg"].weighted_bifpn)
            fault = port_step(want, torch.float64)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_bifpn, "downsample_maxpool", avg_pooled)
            avg32, avg64 = port_steps(want)
        rec = {"phi": phi, "size": SIZE,
               "deep_step_errors": {"jax_f32": T.deep_step_errors(want["result"], exact, ref.LR),
                                    "port_f32": T.deep_step_errors(got, exact, ref.LR),
                                    "jax_f32_against_the_fault": T.deep_step_errors(want["result"], fault, ref.LR)},
               "l2_from_port_f64": {"port_f32_1_thread": distances(got, exact),
                                    "port_f32_4_threads": distances(got4, exact),
                                    "jax_f32": distances(want["result"], exact),
                                    "jax_f32_batch_reversed": distances(reversed_jax, exact),
                                    "jax_f32_against_the_fault": distances(want["result"], fault)},
               "step_rule_grad": {"port_f32_max_pool": T.step_errors(got, exact, ref.LR)["grad"],
                                  "port_f32_avg_pool": T.step_errors(avg32, avg64, ref.LR)["grad"]},
               "plain_port_f32_vs_jax_f32": {k: v for k, v in T.step_errors(got, want["result"], ref.LR).items()
                                             if k != "small_share"}}
        if float64:
            t0 = time.perf_counter()
            jax64 = jax_step_float64(want)
            rec["float64"] = {"seconds": time.perf_counter() - t0,
                              "port_vs_jax": T.step_errors(exact, jax64, ref.LR),
                              "port_with_the_fault_vs_jax": T.step_errors(fault, jax64, ref.LR)}
        print(json.dumps(rec), flush=True)
