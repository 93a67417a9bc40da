"""The tap floor's plain version and arithmetic against the JAX experiment.

The floor kernel (csrc/tap_floor.cu) runs only on a GPU, where chip_smoke.py
holds it against this plain version. Here the plain version meets the JAX
``_floor_kernel`` run through ``pl.pallas_call(..., interpret=True)`` as
``measure_rate`` builds it, on one (8, 128) float32 block of seeded inputs:
both multiply then add in float32 in the same order, so they agree to 1e-6.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from efficientdet_tpu_torch.experiments import tap_floor as tf
from efficientdet_tpu_torch.ops.tap_floor_kernel import tap_floor, tap_floor_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "vpu_tap_floor", os.path.join(REPO, "experiments", "vpu_tap_floor.py"))
jtf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jtf)


def _jax_floor(x, op, taps, repeats, chains):
    kern = functools.partial(jtf._floor_kernel, taps=taps, repeats=repeats, op=op,
                             chains=chains)
    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), grid=(1,),
        in_specs=[pl.BlockSpec(x.shape, lambda i: (0, 0))],
        out_specs=pl.BlockSpec(x.shape, lambda i: (0, 0)), interpret=True,
    )(x)


@pytest.mark.parametrize("op", ["fma", "swish"])
@pytest.mark.parametrize("chains", [1, 4])
def test_plain_floor_matches_the_jax_kernel(op, chains):
    x = np.random.RandomState(chains).uniform(-1, 1, (8, 128)).astype(np.float32)
    want = np.asarray(_jax_floor(jnp.asarray(x), op, 3, 2, chains))
    got = tap_floor(torch.from_numpy(x), op, taps=3, repeats=2, chains=chains)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert tap_floor.launches == 0  # CPU: the plain version, no kernel


def test_bf16_plain_rounds_each_fma_once():
    x = torch.full((4,), 3.0, dtype=torch.bfloat16)
    got = tap_floor_reference(x, "fma", taps=3, repeats=1, chains=1)
    # taps 1.001, 1.002, 1.003 all round to 1.0 in bf16: 0*1+3, 3*1+3, 6*1+3
    assert got.dtype == torch.bfloat16 and torch.equal(got, torch.full((4,), 9.0, dtype=torch.bfloat16))


def test_measure_rate_on_the_cpu_when_asked():
    rate, ms = tf.measure_rate("fma", taps=3, repeats=2, steps=1, device="cpu")
    assert rate > 0 and ms > 0


def test_shape_tables_equal_the_jax_ones():
    assert tf.D0_STAGE123_DW == jtf.D0_STAGE123_DW
    assert tf.D0_STAGE123_MM == jtf.D0_STAGE123_MM
    assert tf.BATCH == jtf.BATCH


def test_ceiling_arithmetic_composes():
    out = tf.ceiling_from_rates(r_fma_gops=1000.0, r_swish_gops=1000.0, t_mm_ms=1.0,
                                hbm_bytes_s=3.35e12, chain_ms=10.0, d0_ms=50.0)
    want = jtf.ceiling_from_rates(r_fma_gops=1000.0, r_swish_gops=1000.0, t_mxu_ms=1.0)
    # the five stage-1..3 depthwise convs at D0 batch 128: 11.98 G tap FMAs
    assert out["tap_gfmas"] == pytest.approx(11.98, abs=0.01)
    assert out["act_gelems"] == pytest.approx(want["act_gelems"], abs=0.005)
    assert out["t_taps_ms"] == pytest.approx(want["t_taps_ms"], abs=0.005)
    assert out["floor_ms"] == pytest.approx(
        out["t_taps_ms"] + out["t_acts_ms"] + out["t_mm_ms"] + out["t_hbm_ms"], rel=1e-12)
    assert out["max_saving_ms"] == pytest.approx(out["chain_ms"] - out["floor_ms"], rel=1e-12)
    assert out["max_saving_pct_of_d0"] == pytest.approx(out["max_saving_ms"] / 50.0 * 100)
    # 579 MB of chain input and output at the card's 3.35 TB/s
    assert out["t_hbm_ms"] == pytest.approx(579.3e6 / 3.35e12 * 1e3, rel=1e-3)
