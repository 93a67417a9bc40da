"""The fused stride-1 MBConv's plain versions against the JAX experiments.

The port's CUDA kernel (csrc/fused_mbconv.cu) runs only on a GPU, where
chip_smoke.py holds it against these plain versions. Here the plain versions
meet the JAX Pallas kernels in interpret mode (as tests/test_packed_mbconv.py
runs them) and the flax MBConvBlock(fuse_bn=True), on the same seeded
weights (the port draws the JAX experiment's numpy tree) and inputs. Both
sides sum in float32 in other orders: 2e-4, as the JAX tests hold their
kernels to the flax block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments import packed_mbconv_pallas as jpm
from experiments.mbconv_pallas import fused_mbconv_s1 as j_fused_mbconv_s1
from efficientdet_tpu_torch.experiments.mbconv import fused_mbconv_s1
from efficientdet_tpu_torch.experiments.packed_mbconv import (
    BLOCKS,
    BlockShape,
    block_bound,
    check_kernel,
    flax_tree,
    pack_params,
    torch_block,
)
from efficientdet_tpu_torch.ops import mbconv_kernel as mk

# the JAX tests' tiny power-of-two shapes: expand+skip (k3), no expand (k3), k5
CASES = [
    BlockShape("tiny_exp_skip", 2, 16, 8, 48, 8, 3, 2),
    BlockShape("tiny_noexp", 2, 16, 8, 8, 4, 3, 2),
    BlockShape("tiny_k5", 2, 8, 8, 24, 8, 5, 2),
]


def _x(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.normal(size=(shape.batch, shape.hw, shape.hw, shape.cin)).astype(np.float32)


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _flat(tree, path=()):
    """A nested dict of arrays (numpy or jax) -> {"a/b/c": numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = np.asarray(v)
    return out


def test_block_tables_match_the_jax_experiment():
    assert tuple(BLOCKS) == tuple(jpm.BLOCKS)
    for name, blk in BLOCKS.items():
        assert tuple(blk) == tuple(jpm.BLOCKS[name])
        assert (blk.has_expand, blk.has_skip) == (jpm.BLOCKS[name].has_expand,
                                                  jpm.BLOCKS[name].has_skip)


@pytest.mark.parametrize("shape", CASES, ids=lambda s: s.name)
def test_weights_equal_the_jax_experiments(shape):
    """The port's numpy tree is the JAX experiment's, leaf for leaf."""
    jparams, _ = jpm.flax_block(jpm.BlockShape(*shape), jnp.float32)
    _, tree = torch_block(shape, torch.float32, device="cpu")
    flat_j, flat_t = _flat(dict(jparams)), _flat(tree)
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)


@pytest.mark.parametrize("shape", CASES, ids=lambda s: s.name)
def test_packers_equal_the_jax_ones(shape):
    jparams, _ = jpm.flax_block(jpm.BlockShape(*shape), jnp.float32)
    block, _ = torch_block(shape, torch.float32, device="cpu")
    for got, want in zip(pack_params(block), jpm.pack_params(jparams, jpm.BlockShape(*shape),
                                                             jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = _x(shape)
    np.testing.assert_array_equal(mk.pack_x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpm.pack_x(jnp.asarray(x))))
    assert mk.pack_x(torch.from_numpy(x)).is_contiguous()
    xrp = mk.pack_rp(torch.from_numpy(x))
    assert xrp.is_contiguous()  # the kernels take contiguous activations only
    np.testing.assert_array_equal(xrp.numpy(), np.asarray(jpm.pack_rp(jnp.asarray(x))))
    np.testing.assert_array_equal(mk.unpack_rp(xrp, shape.hw).numpy(), x)
    np.testing.assert_array_equal(mk.rp_mask(shape.hw, torch.float32).numpy(),
                                  np.asarray(jpm.rp_mask(shape.hw, jnp.float32)))


@pytest.mark.parametrize("shape", CASES, ids=lambda s: s.name)
def test_packed_and_rp_match_jax_kernels_and_flax(shape):
    jshape = jpm.BlockShape(*shape)
    jparams, flax_fwd = jpm.flax_block(jshape, jnp.float32)
    jpacked = jpm.pack_params(jparams, jshape, jnp.float32)
    block, _ = torch_block(shape, torch.float32, device="cpu")
    packed = pack_params(block)
    x = _x(shape)
    want = np.asarray(flax_fwd(jparams, jnp.asarray(x)))

    xp = mk.pack_x(torch.from_numpy(x))
    got = mk.packed_mbconv(xp, packed, shape)
    _close(mk.unpack_x(got, shape.hw), want)
    j_got = jpm.packed_mbconv(jpm.pack_x(jnp.asarray(x)), jpacked, jshape, interpret=True)
    _close(got, j_got)

    xrp = mk.pack_rp(torch.from_numpy(x))
    mask = mk.rp_mask(shape.hw, torch.float32)
    got_rp = mk.packed_mbconv_rp(xrp, mask, packed, shape)
    _close(mk.unpack_rp(got_rp, shape.hw), want)
    j_rp = jpm.packed_mbconv_rp(jpm.pack_rp(jnp.asarray(x)), jpm.rp_mask(shape.hw, jnp.float32),
                                jpacked, jshape, interpret=True)
    _close(got_rp, j_rp)
    # the next block's taps rely on the gap lanes being exactly zero
    gaps = got_rp.numpy() * (1.0 - mask.numpy())
    np.testing.assert_array_equal(gaps, np.zeros_like(gaps))

    got_nhwc = mk.fused_mbconv_nhwc(torch.from_numpy(x), packed, shape.ksize, shape.has_skip)
    _close(got_nhwc, want)
    assert mk.packed_mbconv.launches == mk.packed_mbconv_rp.launches == 0  # CPU: no kernel


def _scaled_tree(shape, seed, zero_expand_bias=False):
    """A folded tree drawn normal(0, 0.5), biases included: flax's init gives
    zero biases, and with a zero expand bias the JAX kernel's fault vanishes."""
    tree = flax_tree(shape.cin, shape.cexp, shape.cout, shape.ksize, shape.se_reduced,
                     np.random.RandomState(seed))
    tree = jax.tree.map(lambda a: a * np.float32(5.0), tree)
    if zero_expand_bias and "expand_conv" in tree:
        tree["expand_conv"]["bias"] = np.zeros_like(tree["expand_conv"]["bias"])
    return tree


def _flax_truth(shape, tree, x):
    from efficientdet_tpu.configs import BlockConfig
    from efficientdet_tpu.models.efficientnet import MBConvBlock

    cfg = BlockConfig(shape.ksize, 1, shape.cin, shape.cout,
                      shape.cexp // shape.cin if shape.has_expand else 1, 1,
                      shape.se_reduced / shape.cin)
    mod = MBConvBlock(config=cfg, input_filters=shape.cin, output_filters=shape.cout,
                      strides=1, survival_prob=1.0, fuse_bn=True)
    params = jax.tree.map(jnp.asarray, tree)
    return np.asarray(mod.apply({"params": params}, jnp.asarray(x)))


NHWC_CASES = [
    BlockShape("k3_e6_skip", 2, 16, 8, 48, 8, 3, 2),
    BlockShape("k3_e1", 2, 16, 8, 8, 4, 3, 2),
    BlockShape("k5_e6_skip", 2, 16, 8, 48, 8, 5, 2),
]


@pytest.mark.parametrize("shape", NHWC_CASES, ids=lambda s: s.name)
def test_fused_s1_matches_flax_with_nonzero_biases(shape):
    tree = _scaled_tree(shape, seed=3)
    x = _x(shape, seed=4)
    want = _flax_truth(shape, tree, x)
    got = fused_mbconv_s1(torch.from_numpy(x), tree, shape.ksize, shape.has_skip, tile_h=8)
    _close(got.numpy(), want, tol=1e-4 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("shape", NHWC_CASES, ids=lambda s: s.name)
def test_fused_s1_matches_the_jax_kernel_without_expand_bias(shape):
    tree = _scaled_tree(shape, seed=5, zero_expand_bias=True)
    x = _x(shape, seed=6)
    want = np.asarray(j_fused_mbconv_s1(jnp.asarray(x), jax.tree.map(jnp.asarray, tree), shape.ksize,
                                        shape.has_skip, tile_h=8, interpret=True))
    got = fused_mbconv_s1(torch.from_numpy(x), tree, shape.ksize, shape.has_skip, tile_h=8)
    _close(got.numpy(), want)


def test_the_jax_nhwc_kernel_differs_from_flax_on_the_border():
    """The reference's fault, pinned: the JAX kernel pads x before its expand,
    so its halo holds swish(b_exp), not 0. The port pads the expanded
    activation, as the flax block does."""
    shape = NHWC_CASES[0]
    tree = _scaled_tree(shape, seed=7)
    x = _x(shape, seed=8)
    want = _flax_truth(shape, tree, x)
    j_got = np.asarray(j_fused_mbconv_s1(jnp.asarray(x), jax.tree.map(jnp.asarray, tree), shape.ksize,
                                         shape.has_skip, tile_h=8, interpret=True))
    got = fused_mbconv_s1(torch.from_numpy(x), tree, shape.ksize, shape.has_skip, tile_h=8).numpy()
    scale = np.abs(want).max()
    border = np.zeros(want.shape[1:3], bool)
    border[[0, -1], :] = border[:, [0, -1]] = True
    assert np.abs(j_got - want)[:, border].max() > 0.05 * scale
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("name,layout,want_ms,want_by", [
    # 48 channels x 128 x 256^2 pixels of bf16 read or written at 3.35 TB/s
    ("d0s1", "packed", 48 * 128 * 256 ** 2 * 2 / 3.35e12 * 1e3, "bytes"),
    # the row-padded layout moves its 260^2 lanes and reads its mask
    ("d0s1", "rp", (48 * 128 * 260 ** 2 * 2 + 260 ** 2 * 2) / 3.35e12 * 1e3, "bytes"),
    # taps 2*9*144 per pixel at 67 TFLOP/s + products 2*(24*144 + 144*24) at 989
    ("d0s2b1", "nhwc", 128 * 128 ** 2 * (2 * 9 * 144 / 67e12 + 2 * 6912 / 989e12) * 1e3,
     "operations"),
])
def test_block_bound_is_the_larger_of_bytes_and_operations(name, layout, want_ms, want_by):
    ms, by = block_bound(BLOCKS[name], layout)
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=1e-12)


@pytest.mark.parametrize("dtype,inside,outside", [
    (torch.float32, 3e-4, 5e-4),    # 1e-4 of scale 4 (the larger of scale and 1)
    (torch.bfloat16, 0.03, 0.08),   # 2^-7 |ref| + 1e-2 * 4: 0.04 to 0.071
])
def test_check_kernel_holds_the_stated_rule(dtype, inside, outside):
    ref = torch.linspace(-4, 4, 1001).to(dtype)
    assert check_kernel(ref.clone(), ref, dtype)["ok"]
    assert check_kernel((ref.float() + inside).to(dtype), ref, dtype)["ok"]
    one_off = ref.clone()
    one_off[500] += outside
    res = check_kernel(one_off, ref, dtype)
    assert not res["ok"] and res["scale"] == 4.0


def test_fused_s1_keeps_the_tile_contract():
    shape = NHWC_CASES[0]
    tree = _scaled_tree(shape, seed=3)
    with pytest.raises(ValueError, match="tile_h"):
        fused_mbconv_s1(torch.from_numpy(_x(shape)), tree, 3, True, tile_h=5)
