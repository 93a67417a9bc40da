"""Per-block harness of the fused stride-1 MBConv kernels, at D0/D4 shapes.

Counterpart of the JAX package's ``experiments/packed_mbconv_pallas.py``.
For each recorded block shape it builds the port's own unfused
``MBConvBlock(fuse_bn=True)`` with seeded random weights, packs them, and
times, on the card: the unfused block, the three layouts of the fused kernel
(``ops/mbconv_kernel.py``: packed, row-padded, NHWC), their plain versions,
and the layout conversions around them. Each kernel is held against its
plain version at the block's own shape first, then against the unfused
block; each record carries the kernels' bounds (``block_bound``).

    python -m efficientdet_tpu_torch.experiments.packed_mbconv [--blocks d0s1,...] [--steps 20]

prints one JSON line per block.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..configs import BlockConfig
from ..models.detector import resolve_device
from ..models.efficientnet import MBConvBlock
from ..ops.mbconv_kernel import (
    fused_mbconv_nhwc,
    fused_mbconv_nhwc_reference,
    pack_rp,
    pack_x,
    packed_mbconv,
    packed_mbconv_reference,
    packed_mbconv_rp,
    packed_mbconv_rp_reference,
    rp_dims,
    rp_mask,
    unpack_rp,
    unpack_x,
)
from ..utils.convert import load_flax_variables
from .timing import HBM_BYTES_S, PEAK_BF16, PEAK_F32_CUDA_CORES, cuda_ms, kernel_ms


class BlockShape(NamedTuple):
    name: str
    batch: int
    hw: int          # square feature-map side (stride-1 block: in == out)
    cin: int
    cexp: int        # == cin when expand_ratio == 1
    cout: int
    ksize: int
    se_reduced: int

    @property
    def has_expand(self):
        return self.cexp != self.cin

    @property
    def has_skip(self):
        return self.cin == self.cout


# The stride-1 early blocks of D0 (batch 128 @512) and D4 (batch 16 @1024).
# The repeat-position blocks (d0s2b1, d0s3b1, d4s1b1) carry the stage-FIRST
# block's SE width (se_ratio * the stage's input filters): the model builds
# its repeats with input == output filters, so their true widths are 6/10/6,
# not 4/6/12. The JAX experiment recorded its measurements at these shapes
# and builds its truth block from the same se_ratio, so the port keeps them:
# parity holds and the numbers stay comparable.
BLOCKS = {
    "d0s1": BlockShape("d0s1", 128, 256, 32, 32, 16, 3, 8),
    "d0s2b1": BlockShape("d0s2b1", 128, 128, 24, 144, 24, 3, 4),
    "d0s3b1": BlockShape("d0s3b1", 128, 64, 40, 240, 40, 5, 6),
    "d4s1b1": BlockShape("d4s1b1", 16, 512, 24, 24, 24, 3, 12),
    "d4s2b1": BlockShape("d4s2b1", 16, 256, 32, 192, 32, 3, 8),
    "d4s3b1": BlockShape("d4s3b1", 16, 128, 56, 336, 56, 5, 14),
}


def block_config(cin: int, cexp: int, cout: int, ksize: int, stride: int,
                 se_reduced: int) -> BlockConfig:
    return BlockConfig(
        kernel_size=ksize, num_repeat=1, input_filters=cin, output_filters=cout,
        expand_ratio=cexp // cin if cexp != cin else 1, strides=stride,
        se_ratio=se_reduced / cin,
    )


def flax_tree(cin: int, cexp: int, cout: int, ksize: int, se_reduced: int,
              rng: np.random.RandomState) -> Dict:
    """The folded MBConv's flax params, drawn normal(0, 0.1) from ``rng``.

    Leaves are drawn in the order ``jax.tree.map`` visits a flax tree
    (sorted keys), so the same seed gives the JAX experiment's weights.
    """
    shapes = {
        "depthwise_conv": {"bias": (cexp,), "kernel": (ksize, ksize, 1, cexp)},
        "project_conv": {"bias": (cout,), "kernel": (1, 1, cexp, cout)},
        "se": {
            "expand": {"bias": (cexp,), "kernel": (1, 1, se_reduced, cexp)},
            "reduce": {"bias": (se_reduced,), "kernel": (1, 1, cexp, se_reduced)},
        },
    }
    if cexp != cin:
        shapes["expand_conv"] = {"bias": (cexp,), "kernel": (1, 1, cin, cexp)}

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        return rng.normal(scale=0.1, size=node).astype(np.float32)

    return draw(shapes)


def torch_block(shape: BlockShape, dtype=torch.bfloat16, seed: int = 1,
                device=None) -> Tuple[MBConvBlock, Dict]:
    """The port's folded MBConvBlock with the JAX experiment's weights.

    Returns the block (weights in ``dtype`` on ``device``, the GPU unless
    told otherwise) and the numpy flax tree it was loaded from.
    """
    cfg = block_config(shape.cin, shape.cexp, shape.cout, shape.ksize, 1,
                       shape.se_reduced)
    block = MBConvBlock(cfg, shape.cin, shape.cout, 1, fuse_bn=True)
    tree = flax_tree(shape.cin, shape.cexp, shape.cout, shape.ksize,
                     shape.se_reduced, np.random.RandomState(seed))
    load_flax_variables(block, {"params": tree})
    return block.to(device=resolve_device(device), dtype=dtype).eval(), tree


def pack_params(block: MBConvBlock, dtype=None) -> Tuple[torch.Tensor, ...]:
    """A folded MBConvBlock's weights -> the kernels' packed tuple.

    Vectors become (C, 1) columns, the depthwise kernel (Ce, k*k) with tap
    ``dy*k + dx`` in column t; without an expand, (1, 1) zero placeholders.
    """
    dw = block.depthwise_conv.weight
    dtype = dtype or dw.dtype

    def a(t):
        return t.detach().to(dtype)

    def mat(conv):  # 1x1 conv (out, in, 1, 1) -> (in, out)
        return a(conv.weight[:, :, 0, 0].t())

    def col(conv):
        return a(conv.bias.reshape(-1, 1))

    if block.has_expand:
        wexp, bexp = mat(block.expand_conv), col(block.expand_conv)
    else:
        wexp = bexp = torch.zeros((1, 1), dtype=dtype, device=dw.device)
    se = block.se
    return (wexp, bexp, a(dw.reshape(dw.shape[0], -1)), col(block.depthwise_conv),
            mat(se.reduce), col(se.reduce), mat(se.expand), col(se.expand),
            mat(block.project_conv), col(block.project_conv))


def block_bound(shape: BlockShape, layout: str) -> Tuple[float, str]:
    """Least time of one fused block at ``shape``, bf16, as (ms, bound by):
    bytes (x read and y written once, the row-padded layout's gap lanes and
    mask included) or operations (taps on the CUDA cores, the 1x1 products
    on the tensor cores)."""
    px = shape.batch * shape.hw ** 2
    side = rp_dims(shape.hw)
    lanes = shape.batch * side ** 2 if layout == "rp" else px
    nbytes = (shape.cin + shape.cout) * lanes * 2 + (side ** 2 * 2 if layout == "rp" else 0)
    taps = 2.0 * shape.ksize ** 2 * shape.cexp * px
    products = 2.0 * ((shape.cin * shape.cexp if shape.has_expand else 0)
                      + shape.cexp * shape.cout) * px
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = (taps / PEAK_F32_CUDA_CORES + products / PEAK_BF16) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_tolerance(ref: torch.Tensor, scale: float, dtype) -> Tuple[object, str]:
    """(tolerance, its rule) of a fused kernel against its plain version."""
    if dtype == torch.float32:
        # float32 sums over up to 336 expanded channels in another order
        return 1e-4 * max(scale, 1.0), "|d| <= 1e-4 max(scale, 1)"
    # bf16 with the shared rounding points: one bf16 ulp of the output, plus 1%
    # of the scale for the intermediate roundings (e, the scaled activation)
    # that land on the other side after a float32 sum in another order
    return 2.0 ** -7 * ref.abs() + 1e-2 * max(scale, 1.0), "|d| <= 2^-7 |ref| + 1e-2 max(scale, 1)"


def check_kernel(got: torch.Tensor, ref: torch.Tensor, dtype) -> Dict:
    """A kernel's output against its plain version's, by ``kernel_tolerance``."""
    ref = ref.float()
    scale = ref.abs().max().item()
    d = (got.float() - ref).abs()
    tol, rule = kernel_tolerance(ref, scale, dtype)
    return {"max_abs_err": d.max().item(), "scale": scale, "tolerance": rule,
            "ok": bool((d <= tol).all())}


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def run_block(shape: BlockShape, steps: int = 20, device=None) -> Dict:
    """Check and time one block shape in bf16 on the card; one JSON-able dict.

    Each kernel is held against its plain version at this shape (and the
    row-padded output's gap lanes against exact zero), then against the
    unfused block; any disagreement raises.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("run_block times the kernels on the GPU")
    dtype = torch.bfloat16
    block, _ = torch_block(shape, dtype, device=dev)
    packed = pack_params(block)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((shape.batch, shape.hw, shape.hw, shape.cin), generator=gen,
                    device=dev).to(dtype)
    xp = pack_x(x)
    xrp = pack_rp(x)
    mask = rp_mask(shape.hw, dtype, dev)

    with torch.inference_mode():
        out_p = packed_mbconv(xp, packed, shape)
        out_rp = packed_mbconv_rp(xrp, mask, packed, shape)
        out_n = fused_mbconv_nhwc(x, packed, shape.ksize, shape.has_skip)
        vs_plain = {
            "packed": check_kernel(out_p, packed_mbconv_reference(xp, packed, shape), dtype),
            "rp": check_kernel(out_rp, packed_mbconv_rp_reference(xrp, mask, packed, shape), dtype),
            "nhwc": check_kernel(out_n, fused_mbconv_nhwc_reference(
                x, packed, shape.ksize, shape.has_skip), dtype),
        }
        rp_gap = (out_rp * (1 - mask)).abs().max().item()
        if rp_gap != 0.0 or not all(c["ok"] for c in vs_plain.values()):
            raise AssertionError(f"{shape.name}: fused kernel vs its plain version "
                                 f"{vs_plain}, rp gap max {rp_gap}")

        want = block(xp.view(shape.batch, shape.cin, shape.hw, shape.hw))
        want = want.permute(0, 2, 3, 1)
        mag = want.float().abs().max().item()
        errs = {
            "packed": _max_err(unpack_x(out_p, shape.hw), want),
            "rp": _max_err(unpack_rp(out_rp, shape.hw), want),
            "nhwc": _max_err(out_n, want),
        }
        # the unfused bf16 block rounds at more points than the fused one
        for name, err in errs.items():
            if not err <= 0.06 * max(mag, 1.0):
                raise AssertionError(f"{shape.name} {name}: |kernel - block| {err}, scale {mag}")
        del want, out_rp, out_n
        xnchw = xp.view(shape.batch, shape.cin, shape.hw, shape.hw)
        plain_steps = max(steps // 5, 1)
        ms = {
            "module_ms": cuda_ms(lambda: block(xnchw), steps),
            "packed_ms": cuda_ms(lambda: packed_mbconv(xp, packed, shape), steps),
            "rp_ms": cuda_ms(lambda: packed_mbconv_rp(xrp, mask, packed, shape), steps),
            "nhwc_ms": cuda_ms(lambda: fused_mbconv_nhwc(x, packed, shape.ksize,
                                                         shape.has_skip), steps),
            "packed_plain_ms": cuda_ms(lambda: packed_mbconv_reference(xp, packed, shape),
                                       plain_steps, warmup=1),
            "rp_plain_ms": cuda_ms(lambda: packed_mbconv_rp_reference(xrp, mask, packed, shape),
                                   plain_steps, warmup=1),
            "nhwc_plain_ms": cuda_ms(lambda: fused_mbconv_nhwc_reference(
                x, packed, shape.ksize, shape.has_skip), plain_steps, warmup=1),
            "packed_kernels_ms": kernel_ms(lambda: packed_mbconv(xp, packed, shape)),
            "pack_ms": cuda_ms(lambda: pack_x(x), steps),
            "unpack_ms": cuda_ms(lambda: unpack_x(out_p, shape.hw).contiguous(), steps),
        }
    bounds = {}
    for layout in ("packed", "rp", "nhwc"):
        bounds[f"{layout}_bound_ms"], bounds[f"{layout}_bound_by"] = block_bound(shape, layout)
    return {"block": shape.name, "batch": shape.batch, **ms, **bounds,
            "speedup_packed": ms["module_ms"] / ms["packed_ms"],
            "vs_plain": vs_plain, "rp_gap_max": rp_gap,
            "max_err_vs_module": errs, "scale": mag}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", default=",".join(BLOCKS))
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    for name in args.blocks.split(","):
        print(json.dumps(run_block(BLOCKS[name], args.steps)), flush=True)


if __name__ == "__main__":
    main()
