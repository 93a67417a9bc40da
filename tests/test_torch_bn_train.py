"""The port's BatchNorm in training mode against flax's ``TpuBatchNorm``.

Batch statistics in float32 (the biased variance ``max(E[x^2] - E[x]^2, 0)``),
the output, the gradients of the input, scale and bias (through both the mean
and the variance), and the running statistics after one update (momentum
0.99, on detached statistics) agree within 1e-5. A bfloat16 input keeps its
dtype while the statistics stay float32; ``freeze_bn`` keeps a training
model's BNs on their running statistics; remat's recompute leaves the
running statistics alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdet_tpu.models.normalization import TpuBatchNorm as JBatchNorm
import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.models.detector import init_weights
from efficientdet_tpu_torch.models.normalization import TpuBatchNorm
from efficientdet_tpu_torch.models.remat import remat

TOL = 1e-5
C = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test processes on the host's
    cores, and a team of threads in each stalls its parallel regions."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = (rng.normal(0.7, 2.0, (4, 5, 3, C))).astype(np.float32)  # NHWC
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                            "bias": rng.normal(0, 0.3, C).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.2, C).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}}
    w = rng.normal(0, 1, x.shape).astype(np.float32)  # a cotangent
    return x, variables, w


def _port(variables, momentum=0.99):
    bn = TpuBatchNorm(C, eps=1e-3, momentum=momentum)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    return bn


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_training_mode_matches_flax():
    x, variables, w = _inputs(0)
    jbn = JBatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)

    def loss(params, x):
        y, mutated = jbn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                               mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mutated["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], x)
    bn = _port(variables).train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    yt = bn(xt)
    (yt * torch.from_numpy(w.transpose(0, 3, 1, 2).copy())).sum().backward()
    _close(yt.permute(0, 2, 3, 1), y)
    _close(xt.grad.permute(0, 2, 3, 1), gx)
    _close(bn.weight.grad, gp["scale"])
    _close(bn.bias.grad, gp["bias"])
    _close(bn.running_mean, stats["mean"])
    _close(bn.running_var, stats["var"])


def test_eval_mode_uses_running_statistics():
    x, variables, _ = _inputs(1)
    y = JBatchNorm(use_running_average=True, epsilon=1e-3).apply(variables, x)
    bn = _port(variables).eval()
    before = bn.running_mean.clone()
    _close(bn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1), y)
    assert torch.equal(bn.running_mean, before)


def test_bf16_input_keeps_its_dtype_with_f32_statistics():
    x, variables, _ = _inputs(2)
    bn = _port(variables).train()
    xb = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(torch.bfloat16)
    y = bn(xb)
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == torch.float32 and bn.running_var.dtype == torch.float32
    # the statistics are those of the bf16 values, taken in float32
    ref = _port(variables).train()
    yr = ref(xb.float())
    assert torch.equal(bn.running_mean, ref.running_mean)
    assert torch.equal(bn.running_var, ref.running_var)
    assert torch.equal(y, yr.to(torch.bfloat16))


def test_freeze_bn_keeps_running_statistics():
    _, cfg = et.build_efficientdet(0, num_classes=4, image_size=128, freeze_bn=True,
                                   device="cpu")
    assert cfg.freeze_bn
    # stochastic depth off, so that training and eval mode differ only in BN
    model = init_weights(et.EfficientDet(dataclasses.replace(cfg, survival_prob=1.0)))
    model.train()
    bns = [m for m in model.modules() if isinstance(m, TpuBatchNorm)]
    assert model.training and bns and not any(bn.training for bn in bns)
    before = [bn.running_mean.clone() for bn in bns]
    x = torch.randn(1, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    train_out = model(x, raw_levels=True)
    assert all(torch.equal(b, bn.running_mean) for b, bn in zip(before, bns))
    model.eval()
    eval_out = model(x, raw_levels=True)
    for a, b in zip(train_out[0] + train_out[1], eval_out[0] + eval_out[1]):
        assert torch.equal(a, b)
    # without freeze_bn, training mode uses (and moves) the batch statistics
    free, _ = et.build_efficientdet(0, num_classes=4, image_size=128, device="cpu")
    free.train()
    assert all(m.training for m in free.modules() if isinstance(m, TpuBatchNorm))


@pytest.mark.parametrize("momentum", [0.99, 0.9])
def test_remat_recompute_updates_the_statistics_once(momentum):
    x, variables, w = _inputs(3)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    wt = torch.from_numpy(w.transpose(0, 3, 1, 2).copy())
    plain, checked = _port(variables, momentum).train(), _port(variables, momentum).train()
    xa, xb = xt.clone().requires_grad_(), xt.clone().requires_grad_()
    (plain(xa) * wt).sum().backward()
    (remat(checked, xb) * wt).sum().backward()
    assert checked.update_stats  # restored after the recompute
    assert torch.equal(plain.running_mean, checked.running_mean)
    assert torch.equal(plain.running_var, checked.running_var)
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(plain.weight.grad, checked.weight.grad)
