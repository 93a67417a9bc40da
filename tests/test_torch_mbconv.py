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
    # + two swishes per expanded channel at 16 a clock on 132 SMs at 1.98 GHz
    ("d0s2b1", "nhwc", 128 * 128 ** 2 * (2 * 9 * 144 / 67e12 + 2 * 6912 / 989e12
                                         + 2 * 144 / (16 * 132 * 1.98e9)) * 1e3,
     "operations"),
    # k5, 240 expanded channels: 2*25*240 taps, 2*(40*240 + 240*40) products, 2*240 swishes
    ("d0s3b1", "packed", 128 * 64 ** 2 * (2 * 25 * 240 / 67e12 + 2 * 19200 / 989e12
                                          + 2 * 240 / (16 * 132 * 1.98e9)) * 1e3,
     "operations"),
    # no expand: one swish per channel and pixel; the bytes still bound it
    ("d4s1b1", "packed", 48 * 16 * 512 ** 2 * 2 / 3.35e12 * 1e3, "bytes"),
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


# ---------------------------------------------- the CUDA kernel's plan, mirrored


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_smem_plan_fits_a_block_at_every_recorded_shape(name, dtype):
    """Both passes of a block stay within the 232,448 bytes a block may have
    (chip_smoke.py holds this count against the kernel's own on the card)."""
    b = BLOCKS[name]
    pool = mk.smem_bytes(b.cin, b.cexp, b.cout, b.ksize, b.has_expand, dtype, project=False)
    proj = mk.smem_bytes(b.cin, b.cexp, b.cout, b.ksize, b.has_expand, dtype, project=True)
    assert 0 < pool < proj <= mk.SMEM_MAX
    for other_k in (3, 5):
        assert mk.smem_bytes(b.cin, b.cexp, b.cout, other_k, b.has_expand, dtype,
                             project=True) <= mk.SMEM_MAX


def test_smem_plan_counts_the_largest_block_by_hand():
    """d4s3b1, bf16, k5: x tile 64 x 728 x 2 (Cin 56 padded to 64, a 20 x 36
    halo at pitch 728), es 32 x 728 x 2, sd 32 x 520 x 2, mask 720 x 4, two
    weight buffers of 5120 + 64 + 1600 + 64 + 128 + 4608 (wexp, its bias, the
    taps, their bias, the float32 SE scales, wproj). d0s1 (no expand, k3,
    Cout 16): x 32 x 648 x 2, sd, mask 648 x 4, weights 2 x (64 + 576 + 64 +
    128 + 1536)."""
    b = BLOCKS["d4s3b1"]
    want = 93184 + 46592 + 33280 + 2880 + 2 * 11584
    assert mk.smem_bytes(b.cin, b.cexp, b.cout, 5, True, torch.bfloat16, project=True) == want
    b = BLOCKS["d0s1"]
    want = 41472 + 33280 + 2592 + 2 * 2368
    assert mk.smem_bytes(b.cin, b.cexp, b.cout, 3, False, torch.bfloat16, project=True) == want
    assert mk.tile_config(torch.bfloat16) == (16, 32) and mk.tile_config(torch.float32) == (8, 16)
    with pytest.raises(ValueError, match="shared memory"):
        mk._check("packed", torch.zeros((1, 512, 64), dtype=torch.bfloat16),
                  tuple(torch.zeros(s) for s in ((1, 1), (1, 1), (512, 9), (512, 1), (512, 4), (4, 1),
                                                 (4, 512), (512, 1), (512, 16), (16, 1))),
                  512, 3, False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hw", [8, 20, 64, 128, 256])
def test_rp_walk_writes_every_lane_exactly_once(hw, dtype):
    """The tiles produce the real lanes, the gap launch the gap lanes, each
    lane once; the tile count is the packed layout's."""
    tiles, ring = mk.rp_tile_lanes(hw, dtype), mk.rp_ring_lanes(hw)
    n = mk.rp_dims(hw) ** 2
    assert tiles.numel() == hw * hw and ring.numel() == n - hw * hw
    count = torch.bincount(torch.cat([tiles, ring]), minlength=n)
    assert count.numel() == n and bool((count == 1).all())
    mask = mk.rp_mask(hw, torch.float32).reshape(-1)
    assert bool((mask[tiles] == 1).all()) and bool((mask[ring] == 0).all())
    # the gap launch's value: zero, or x's own gap lane under a skip
    out = torch.full((n,), float("nan"))
    out[tiles] = 1.0
    out[ring] = 0.0
    torch.testing.assert_close(out, mask, rtol=0, atol=0)
    th, _ = mk.tile_config(dtype)
    assert mk.tiles_of(hw, hw, dtype) == -(-hw // 32) * -(-hw // th)


@pytest.mark.parametrize("k,step", [(24, 16), (40, 16), (56, 16), (24, 32), (144, 32), (336, 32)])
def test_padded_product_operands_contribute_exact_zeros(k, step):
    """Cin 24/40/56 padded to the bf16 K step of 16, Ce 24/144/336 padded to
    the chunk of 32: the padding is zero in both operands, so its products
    are exact zeros and the sums are those of the real rows."""
    rng = np.random.RandomState(k + step)
    act = torch.from_numpy(rng.normal(size=(2, k, 50)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(k, 24)).astype(np.float32)).bfloat16()
    actp, wp = mk.zero_padded_k(act, w, step)
    kp = actp.shape[1]
    assert kp % step == 0 and kp - k < step and wp.shape[0] == kp
    assert torch.equal(actp[:, :k], act) and torch.equal(wp[:k], w)
    tail = torch.einsum("km,bkn->bmn", wp[k:].float(), actp[:, k:].float())
    assert tail.numel() == 0 or bool((tail == 0).all())
    # each product is exact in float32 (two bf16 factors), so the padded sum
    # in float64 is the unpadded one
    full = torch.einsum("km,bkn->bmn", wp.double(), actp.double())
    assert torch.equal(full, torch.einsum("km,bkn->bmn", w.double(), act.double()))
    if step == 16:
        assert kp == mk.x_tile_rows(k, 6 * k, True, torch.bfloat16)
        assert mk.x_tile_rows(k, 6 * k, True, torch.float32) == k


def test_tanh_swish_error_against_silu():
    """The bf16 kernels' swish, 0.5 v (1 + tanh(0.5 v)), over [-20, 20]: the
    form itself is silu to float32 rounding; with tanh.approx's relative
    error of 2^-11 the absolute error is at most |v| / 2 * 2^-11 (4.9e-3 at
    |v| = 20, 1e-3 inside |v| <= 4), below half a bf16 ulp of v from |v| = 0."""
    v = torch.linspace(-20, 20, 400001, dtype=torch.float64)
    want = torch.nn.functional.silu(v)
    assert (mk.tanh_swish(v) - want).abs().max().item() < 1e-12
    v32 = v.float()
    want32 = torch.nn.functional.silu(v32.double())
    assert (mk.tanh_swish(v32).double() - want32).abs().max().item() < 2e-6
    for rel in (2.0 ** -11, -2.0 ** -11):
        err = (mk.tanh_swish(v, rel) - want).abs()
        assert bool((err <= v.abs() / 2 * 2.0 ** -11 + 1e-12).all())
        assert err.max().item() <= 4.9e-3
        assert err[v.abs() <= 4].max().item() <= 1e-3
