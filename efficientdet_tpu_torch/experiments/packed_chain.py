"""The early backbone (stages 1-3) as one routed chain of MBConv blocks.

Counterpart of the JAX package's ``experiments/packed_chain.py``. Each block
of a chain takes one of three routes:

  'pallas'  the fused stride-1 kernel on the packed (B, C, H*W) layout
            (``ops/mbconv_kernel.packed_mbconv``; the name is the JAX
            experiment's and is kept so that routes stay data);
  'hybrid'  plain torch with packed or NHWC input and output: the expand
            and project products carry the layout change, the depthwise
            conv (stride 2 too) runs with the port's SAME rule;
  'nhwc'    the port's own ``MBConvBlock``.

``pack_x``/``unpack_x`` sit only where a 'pallas' block meets an 'nhwc' one.
In torch ``unpack_x`` is a view and ``pack_x`` of such a view is free, so a
layout change costs a copy only where memory really is NHWC.

The baseline is the same blocks as the port runs them: ``torch_chain``'s
``nn.Sequential`` on a contiguous NCHW input.

    python -m efficientdet_tpu_torch.experiments.packed_chain [--chains d0,d4] [--steps 20]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.detector import resolve_device
from ..models.efficientnet import MBConvBlock
from ..ops.mbconv_kernel import pack_x, packed_mbconv, unpack_x
from ..ops.resample import same_pads
from ..utils.convert import load_flax_variables
from .packed_mbconv import BlockShape, block_config, flax_tree, pack_params
from .timing import cuda_ms


class ChainBlock(NamedTuple):
    name: str
    cin: int
    cexp: int
    cout: int
    ksize: int
    stride: int
    se_reduced: int

    @property
    def has_expand(self):
        return self.cexp != self.cin

    @property
    def has_skip(self):
        return self.stride == 1 and self.cin == self.cout


class ChainSpec(NamedTuple):
    name: str
    batch: int
    hw: int  # stem-output side
    cin: int
    blocks: tuple
    routes: tuple  # routes to measure, each len(blocks) of nhwc|pallas|hybrid


# B0 stages 1-3, batch 128 @512. s2b1/s3b1 carry the stage-first block's SE
# width (4/6) where the model's repeat blocks have 6/10, as in
# packed_mbconv.BLOCKS: the shapes the JAX experiment measured.
D0_CHAIN = ChainSpec(
    "d0", 128, 256, 32,
    (
        ChainBlock("s1b0", 32, 32, 16, 3, 1, 8),
        ChainBlock("s2b0", 16, 96, 24, 3, 2, 4),
        ChainBlock("s2b1", 24, 144, 24, 3, 1, 4),
        ChainBlock("s3b0", 24, 144, 40, 5, 2, 6),
        ChainBlock("s3b1", 40, 240, 40, 5, 1, 6),
    ),
    (
        ("pallas", "hybrid", "nhwc", "nhwc", "nhwc"),
        ("pallas", "hybrid", "pallas", "hybrid", "nhwc"),
        ("pallas", "hybrid", "pallas", "hybrid", "pallas"),
    ),
)

# B4 (width 1.4, depth 1.8): stem 48; s1 48->24 x2 e1k3; s2 24->32 x4 e6k3;
# s3 32->56 x4 e6k5. Batch 16 @1024.
D4_CHAIN = ChainSpec(
    "d4", 16, 512, 48,
    (
        ChainBlock("s1b0", 48, 48, 24, 3, 1, 12),
        ChainBlock("s1b1", 24, 24, 24, 3, 1, 6),
        ChainBlock("s2b0", 24, 144, 32, 3, 2, 6),
        ChainBlock("s2b1", 32, 192, 32, 3, 1, 8),
        ChainBlock("s2b2", 32, 192, 32, 3, 1, 8),
        ChainBlock("s2b3", 32, 192, 32, 3, 1, 8),
        ChainBlock("s3b0", 32, 192, 56, 5, 2, 8),
        ChainBlock("s3b1", 56, 336, 56, 5, 1, 14),
        ChainBlock("s3b2", 56, 336, 56, 5, 1, 14),
        ChainBlock("s3b3", 56, 336, 56, 5, 1, 14),
    ),
    (
        ("nhwc", "nhwc", "hybrid", "pallas", "pallas", "pallas", "hybrid",
         "nhwc", "nhwc", "nhwc"),
        ("nhwc", "nhwc", "hybrid", "pallas", "pallas", "pallas", "hybrid",
         "pallas", "pallas", "pallas"),
    ),
)

# Every route at toy sizes: stride-1 kernel blocks with and without expand
# and skip, hybrid stride-2 blocks packed->packed, nhwc->packed and
# packed->nhwc, k5, an nhwc block mid-chain.
TINY_CHAIN = ChainSpec(
    "tiny", 2, 16, 8,
    (
        ChainBlock("s1b0", 8, 8, 4, 3, 1, 2),
        ChainBlock("s2b0", 4, 24, 8, 3, 2, 1),
        ChainBlock("s2b1", 8, 48, 8, 3, 1, 2),
        ChainBlock("s3b0", 8, 48, 8, 5, 2, 2),
        ChainBlock("s3b1", 8, 48, 8, 5, 1, 2),
    ),
    (
        ("pallas", "hybrid", "nhwc", "hybrid", "pallas"),
        ("pallas", "hybrid", "pallas", "hybrid", "nhwc"),
        ("nhwc", "hybrid", "pallas", "hybrid", "pallas"),
    ),
)

CHAINS = {"d0": D0_CHAIN, "d4": D4_CHAIN, "tiny": TINY_CHAIN}


def torch_chain(spec: ChainSpec, dtype=torch.bfloat16, seed: int = 1,
                device=None) -> Tuple[nn.Sequential, List[Dict]]:
    """The port's folded MBConvBlocks of ``spec``, with the JAX experiment's
    weights: one ``RandomState(seed)`` draws every block's flax tree in turn.

    Returns the blocks as an ``nn.Sequential`` (NCHW in, NCHW out; weights in
    ``dtype`` on ``device``, the GPU unless told otherwise) and the trees.
    """
    rng = np.random.RandomState(seed)
    blocks, trees = [], []
    for blk in spec.blocks:
        cfg = block_config(blk.cin, blk.cexp, blk.cout, blk.ksize, blk.stride, blk.se_reduced)
        mod = MBConvBlock(cfg, blk.cin, blk.cout, blk.stride, fuse_bn=True)
        tree = flax_tree(blk.cin, blk.cexp, blk.cout, blk.ksize, blk.se_reduced, rng)
        load_flax_variables(mod, {"params": tree})
        blocks.append(mod)
        trees.append(tree)
    chain = nn.Sequential(*blocks).to(device=resolve_device(device), dtype=dtype)
    return chain.eval(), trees


def chain_pack_params(chain: nn.Sequential) -> List[Tuple[torch.Tensor, ...]]:
    return [pack_params(mod) for mod in chain]


def hybrid_block(x: torch.Tensor, packed, blk: ChainBlock, W: int,
                 in_layout: str, out_layout: str) -> torch.Tensor:
    """One MBConv with packed or NHWC input and output, in plain torch."""
    wexp, bexp, wdw, bdw, wser, bser, wsee, bsee, wproj, bproj = packed
    if not blk.has_expand:
        raise ValueError("a hybrid block's layout change rides its expand and project")
    if blk.has_skip and not in_layout == out_layout == "nhwc":
        raise ValueError("a hybrid block with a skip must run NHWC in and out")
    b, ce, k, s = x.shape[0], blk.cexp, blk.ksize, blk.stride
    if in_layout == "packed":
        e = torch.einsum("ie,bin->bne", wexp, x)
    else:
        e = torch.einsum("bhwi,ie->bhwe", x, wexp)
    e = F.silu(e.float() + bexp.float().reshape(ce)).to(x.dtype)
    e = e.reshape(b, W, W, ce).permute(0, 3, 1, 2)
    pads = same_pads(W, k, s)
    e = F.pad(e, (pads[0], pads[1], pads[0], pads[1]))
    dw = F.conv2d(e, wdw.reshape(ce, 1, k, k), stride=s, groups=ce)
    dw = F.silu(dw.float() + bdw.float().reshape(1, ce, 1, 1))
    pool = dw.mean(dim=(2, 3))
    r = F.silu(pool @ wser.float() + bser.float()[:, 0])
    scale = torch.sigmoid(r @ wsee.float() + bsee.float()[:, 0])
    sdw = (dw * scale[:, :, None, None]).to(x.dtype)
    if out_layout == "packed":
        y = torch.einsum("behw,eo->bohw", sdw, wproj).float()
        y = y + bproj.float().reshape(1, blk.cout, 1, 1)
        return y.to(x.dtype).reshape(b, blk.cout, -1).contiguous()
    y = torch.einsum("behw,eo->bhwo", sdw, wproj).float() + bproj.float()[:, 0]
    if blk.has_skip:
        y = y + x.float()
    return y.to(x.dtype)


def routed_chain(x_nhwc: torch.Tensor, packed_list, spec: ChainSpec, route,
                 chain: nn.Sequential) -> torch.Tensor:
    """Apply the blocks of ``spec`` by ``route``, NHWC in and out."""
    W = spec.hw
    x = x_nhwc
    layout = "nhwc"
    for i, (blk, mode, packed, mod) in enumerate(zip(spec.blocks, route, packed_list, chain)):
        nxt = route[i + 1] if i + 1 < len(route) else "nhwc"
        if mode == "nhwc":
            if layout == "packed":
                x = unpack_x(x, W)
                layout = "nhwc"
            x = mod(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        elif mode == "pallas":
            if layout == "nhwc":
                x = pack_x(x)
                layout = "packed"
            shape = BlockShape(blk.name, x.shape[0], W, blk.cin, blk.cexp, blk.cout,
                               blk.ksize, blk.se_reduced)
            x = packed_mbconv(x, packed, shape)
        elif mode == "hybrid":
            out_layout = "nhwc" if nxt == "nhwc" else "packed"
            x = hybrid_block(x, packed, blk, W, layout, out_layout)
            layout = out_layout
        else:
            raise ValueError(f"unknown route {mode!r}")
        W //= blk.stride
    if layout == "packed":
        x = unpack_x(x, W)
    return x


def run_chain(spec: ChainSpec, steps: int = 20, device=None) -> Dict:
    """Each route against the block chain on the card, bf16: ms, speedup, error.

    Checks that each call launched the packed kernel once per 'pallas' block.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("run_chain times the routes on the GPU")
    dtype = torch.bfloat16
    chain, _ = torch_chain(spec, dtype, device=dev)
    packed_list = chain_pack_params(chain)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((spec.batch, spec.hw, spec.hw, spec.cin), generator=gen,
                    device=dev).to(dtype)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    routes = []
    with torch.inference_mode():
        want = chain(x_nchw).permute(0, 2, 3, 1)
        mag = want.float().abs().max().item()
        ms_ref = cuda_ms(lambda: chain(x_nchw), steps)
        for route in spec.routes:
            before = packed_mbconv.launches
            got = routed_chain(x, packed_list, spec, route, chain)
            launched = packed_mbconv.launches - before
            if launched != route.count("pallas"):
                raise AssertionError(f"{spec.name} {route}: {launched} packed launches, "
                                     f"not {route.count('pallas')}")
            err = (got.float() - want.float()).abs().max().item()
            if not err <= 0.08 * max(mag, 1.0):  # bf16, other rounding points
                raise AssertionError(f"{spec.name} {route}: error {err}, scale {mag}")
            ms = cuda_ms(lambda: routed_chain(x, packed_list, spec, route, chain), steps)
            routes.append({"route": list(route), "ms": ms, "speedup": ms_ref / ms,
                           "max_err": err, "packed_launches_per_call": launched})
    return {"chain": spec.name, "batch": spec.batch, "baseline_ms": ms_ref, "scale": mag,
            "routes": routes}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", default="d0,d4")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    for name in args.chains.split(","):
        print(json.dumps(run_chain(CHAINS[name], args.steps)), flush=True)


if __name__ == "__main__":
    main()
