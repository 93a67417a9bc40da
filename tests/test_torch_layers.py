"""The port's layers against the JAX package's flax modules, in float32.

Weights and inputs are drawn with numpy from a seed and given to both; the
flax variables reach the port through utils/convert.py. Convolutions sum in
another order on the two sides, so conv outputs agree to rtol/atol 1e-5
relative to their scale; element-wise layers agree to float32 rounding.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdet_tpu.models.bifpn import FusedNode as JFusedNode
from efficientdet_tpu.models.efficientnet import SqueezeExcite as JSqueezeExcite
from efficientdet_tpu.models.normalization import TpuBatchNorm as JBatchNorm
from efficientdet_tpu.ops.resample import downsample_maxpool as j_maxpool
from efficientdet_tpu.ops.resample import upsample_to as j_upsample
from efficientdet_tpu_torch.models.bifpn import FusedNode
from efficientdet_tpu_torch.models.conv import Conv2d
from efficientdet_tpu_torch.models.efficientnet import SqueezeExcite
from efficientdet_tpu_torch.models.normalization import TpuBatchNorm
from efficientdet_tpu_torch.ops.resample import downsample_maxpool, upsample_to
from efficientdet_tpu_torch.utils.convert import load_flax_variables


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomize(variables, rng):
    """Replace every leaf of a flax tree with numpy draws of a useful scale."""
    def draw(path, v):
        name = path[-1].key
        shape = np.shape(v)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, (2.0 / fan_in) ** 0.5, shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "fusion_weights":
            return rng.uniform(-0.3, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)  # bias, mean
    return jax.tree_util.tree_map_with_path(draw, variables)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("seed", [0, 1])
def test_batchnorm_inference(seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 3, (2, 5, 7, 12)).astype(np.float32)
    jm = JBatchNorm(use_running_average=True)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_flax_variables(TpuBatchNorm(12, eps=1e-3), v).eval()  # running statistics
    _close(_nhwc(tm(_nchw(x))), want, 1e-6)


@pytest.mark.parametrize("size", [(8, 8), (7, 7), (6, 5), (1, 1), (2, 3)])
def test_maxpool_same(size):
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (2, *size, 3)).astype(np.float32) - 5.0  # all negative: -inf pad shows
    want = np.asarray(j_maxpool(jnp.asarray(x)))
    got = _nhwc(downsample_maxpool(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,out", [((4, 4), (8, 8)), ((3, 5), (6, 10)), ((3, 3), (5, 5))])
def test_upsample_nearest(size, out):
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (2, *size, 3)).astype(np.float32)
    want = np.asarray(j_upsample(jnp.asarray(x), *out))
    np.testing.assert_array_equal(_nhwc(upsample_to(_nchw(x), *out)), want)


@pytest.mark.parametrize("k,stride,size,groups", [
    (3, 2, 16, 1), (5, 2, 16, 1), (3, 2, 15, 1), (5, 2, 9, 1),
    (3, 2, 16, 8), (5, 2, 16, 8), (3, 1, 10, 8), (5, 1, 10, 1), (1, 1, 6, 1),
])
def test_conv_same(k, stride, size, groups):
    rng = np.random.RandomState(k * 100 + size)
    x = rng.normal(0, 1, (2, size, size, 8)).astype(np.float32)
    jm = nn.Conv(8, (k, k), strides=(stride, stride), padding="SAME", feature_group_count=groups)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_flax_variables(Conv2d(8, 8, k, stride=stride, groups=groups), v)
    got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("hw", [4, 70])  # the JAX SE takes two routes around 4096 pixels
def test_squeeze_excite(hw):
    rng = np.random.RandomState(hw)
    x = rng.normal(0, 1, (2, hw, hw, 16)).astype(np.float32)
    jm = JSqueezeExcite(num_reduced=4, num_filters=16)
    v = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_flax_variables(SqueezeExcite(16, 4), v)
    _close(_nhwc(tm(_nchw(x))), want)


@pytest.mark.parametrize("n,weighted", [(2, True), (3, True), (3, False)])
def test_fused_node(n, weighted):
    rng = np.random.RandomState(n)
    xs = [rng.normal(0, 1, (2, 6, 6, 16)).astype(np.float32) for _ in range(n)]
    jm = JFusedNode(features=16, num_inputs=n, weighted=weighted)
    v = _randomize(jm.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs]), rng)
    want = np.asarray(jm.apply(v, [jnp.asarray(x) for x in xs]))
    tm = load_flax_variables(FusedNode(16, n, weighted=weighted), v).eval()  # running statistics
    _close(_nhwc(tm([_nchw(x) for x in xs])), want)


def test_bridge_rejects_unknown_and_missing():
    v = {"params": {"weight": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="unknown params leaf"):
        load_flax_variables(TpuBatchNorm(3), v)
    v = {"params": {"scale": np.ones(3, np.float32), "bias": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="missing"):
        load_flax_variables(TpuBatchNorm(3), v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocess_batch_fixed(dtype):
    from efficientdet_tpu.ops.preprocess import preprocess_batch_fixed as j_pre
    from efficientdet_tpu_torch.ops.preprocess import preprocess_batch_fixed

    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    want = np.asarray(j_pre(jnp.asarray(images), dtype=getattr(jnp, dtype)).astype(jnp.float32))
    got = preprocess_batch_fixed(torch.from_numpy(images), dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    # divide by 255, then (x - mean) / std, in float32 on both sides
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6, atol=1e-6)
