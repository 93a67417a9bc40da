"""The head kernel's plain version against the JAX package's head kernel.

The CUDA kernel itself runs only on a GPU; chip_smoke.py holds it against
this plain version there. Here the plain version meets the JAX reference
(``head_pointwise_reference``) and the Pallas kernel in interpret mode, as
tests/test_head_pallas.py runs it. Both sides sum 64-128 float32 products
in another order, so they agree to rtol/atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdet_tpu.ops.head_pallas import (
    head_pointwise_anchor_major as j_kernel,
    head_pointwise_reference as j_reference,
)
from efficientdet_tpu_torch.ops.head_kernel import (
    ROW_TILE,
    head_pointwise_anchor_major,
    head_pointwise_reference,
)


def _inputs(seed, m, cin, a, out):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, cin).astype(np.float32)
    k = (rng.randn(cin, a * out) * 0.1).astype(np.float32)
    b = rng.randn(a * out).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("m,cin,a,out", [
    (1024, 64, 9, 10),   # whole row tiles
    (700, 32, 9, 4),     # padded rows
    (1000, 64, 9, 90),   # the class head's widths
    (777, 64, 1, 36),    # the box head's widths
])
def test_plain_matches_jax(m, cin, a, out):
    x, k, b = _inputs(m + out, m, cin, a, out)
    z, amax, n = head_pointwise_reference(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), a)
    mp = -(-m // ROW_TILE) * ROW_TILE
    assert n == m and z.shape == (a, mp, out) and amax.shape == (a, mp)
    zr, ar, _ = j_reference(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), a)
    np.testing.assert_allclose(z[:, :m].numpy(), np.asarray(zr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(amax[:, :m].numpy(), np.asarray(ar), rtol=1e-5, atol=1e-5)
    zi, ai, _ = j_kernel(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), a, interpret=True)
    # the Pallas kernel pads too: compare every row, padded ones included
    np.testing.assert_allclose(z.numpy(), np.asarray(zi), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(amax.numpy(), np.asarray(ai), rtol=1e-5, atol=1e-5)


def test_padded_rows_hold_bias():
    x, k, b = _inputs(3, 700, 32, 9, 4)
    z, amax, m = head_pointwise_reference(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), 9)
    want = torch.from_numpy(b).reshape(9, 1, 4).expand(9, z.shape[1] - m, 4)
    torch.testing.assert_close(z[:, m:], want, rtol=0, atol=0)
    torch.testing.assert_close(amax[:, m:], want.amax(-1), rtol=0, atol=0)


def test_bf16_rounds_like_jax():
    # bf16 in, f32 sums, bf16 out: both sides round the same float32 sum
    # unless the two summation orders straddle a rounding boundary, which
    # is at most one bf16 ulp
    x, k, b = _inputs(4, 512, 64, 9, 90)
    xb = torch.from_numpy(x).bfloat16()
    z, amax, _ = head_pointwise_reference(xb, torch.from_numpy(k), torch.from_numpy(b), 9)
    assert z.dtype == amax.dtype == torch.bfloat16
    zr, ar, _ = j_reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(b), 9)
    zr = np.asarray(zr.astype(jnp.float32))
    got = z.float().numpy()
    ulp = np.abs(zr) * 2.0 ** -7
    assert np.all(np.abs(got - zr) <= ulp + 1e-6)
    assert (got == zr).mean() > 0.99


def test_wrapper_takes_plain_version_on_cpu():
    x, k, b = _inputs(5, 600, 16, 9, 6)
    args = (torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), 9)
    before = head_pointwise_anchor_major.launches
    got = head_pointwise_anchor_major(*args)
    want = head_pointwise_reference(*args)
    assert head_pointwise_anchor_major.launches == before  # no kernel launched
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
