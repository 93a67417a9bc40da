"""The port's routed early-backbone chain against the JAX experiment's truth.

TINY_CHAIN runs every route (the packed kernel's plain version for 'pallas'
blocks, the plain-torch hybrid stride-2 block, the port's MBConvBlock for
'nhwc') and meets the flax MBConvBlock(fuse_bn=True) chain of
experiments/packed_chain.py on the same seeded weights and input, in
float32: 2e-4 of the output's scale, as the JAX test holds its routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments import packed_chain as jpc
from efficientdet_tpu_torch.experiments import packed_chain as pc


@pytest.mark.parametrize("name", ["d0", "d4", "tiny"])
def test_chain_specs_equal_the_jax_ones(name):
    got, want = pc.CHAINS[name], jpc.CHAINS[name]
    assert (got.name, got.batch, got.hw, got.cin) == (want.name, want.batch, want.hw, want.cin)
    assert got.routes == want.routes
    assert len(got.blocks) == len(want.blocks)
    for g, w in zip(got.blocks, want.blocks):
        assert tuple(g) == tuple(w)
        assert (g.has_expand, g.has_skip) == (w.has_expand, w.has_skip)


def _flax_chain_params(spec, mods):
    """``jpc.flax_chain``'s weights: one RandomState(1) over each block's
    param tree in jax.tree order. The tree comes from ``jax.eval_shape``, not
    from running flax's init (seconds a block on the CPU)."""
    rng = np.random.RandomState(1)
    params, hw = [], spec.hw
    for blk, mod in zip(spec.blocks, mods):
        x0 = jnp.zeros((1, hw, hw, blk.cin), jnp.float32)
        shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x0)["params"]
        params.append(jax.tree.map(
            lambda a: jnp.asarray(rng.normal(scale=0.1, size=a.shape), a.dtype), shapes))
        hw //= blk.stride
    return params


@pytest.fixture(scope="module")
def tiny():
    spec = pc.TINY_CHAIN
    mods = jpc.build_flax_blocks(spec, jnp.float32)
    jparams = _flax_chain_params(spec, mods)
    chain, trees = pc.torch_chain(spec, torch.float32, device="cpu")
    x = np.random.RandomState(0).normal(
        size=(spec.batch, spec.hw, spec.hw, spec.cin)).astype(np.float32)

    @jax.jit
    def fwd(params, y):
        for mod, p in zip(mods, params):
            y = mod.apply({"params": p}, y)
        return y

    want = np.asarray(fwd(jparams, jnp.asarray(x)))
    return spec, jparams, chain, trees, x, want


def test_tiny_weights_equal_the_jax_ones(tiny):
    _, jparams, _, trees, _, _ = tiny
    for jp, tree in zip(jparams, trees):
        flat_j = jax.tree_util.tree_leaves_with_path(jp)
        flat_t = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        for (p, a), (_, b) in zip(flat_j, flat_t):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


@pytest.mark.parametrize("route", pc.TINY_CHAIN.routes, ids="-".join)
def test_tiny_routes_match_the_flax_chain(tiny, route):
    spec, _, chain, _, x, want = tiny
    packed = pc.chain_pack_params(chain)
    with torch.inference_mode():
        got = pc.routed_chain(torch.from_numpy(x), packed, spec, route, chain).numpy()
        base = chain(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    tol = 2e-4 * max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=tol)
    np.testing.assert_allclose(base, want, rtol=2e-4, atol=tol)


def test_unknown_route_raises(tiny):
    spec, _, chain, _, x, _ = tiny
    with pytest.raises(ValueError, match="unknown route"):
        pc.routed_chain(torch.from_numpy(x), pc.chain_pack_params(chain), spec,
                        ("pallas", "hybrid", "xla", "hybrid", "pallas"), chain)
