"""The arithmetic floor of a single kernel spanning D0's backbone stages 1-3.

Counterpart of the JAX package's ``experiments/vpu_tap_floor.py``. Every
implementation of the early backbone must do its depthwise taps (k*k
multiply-adds per expanded channel and output pixel) and its swishes on
the CUDA cores, its 1x1 products somewhere, and read the chain's input and
write its output once. This measures the card's rate for the first two with
a kernel that does nothing else (``ops/tap_floor_kernel.py``), times the
products as ``torch.matmul`` at their shapes, and composes

  floor = taps / R_fma + activations / R_swish + t_products + bytes / HBM

for the D0 batch of 128 at 512, beside the measured chain and model times.
The floor prices the SE, the skips, the halos and all scheduling at zero,
so the saving it implies is an upper bound.

    python -m efficientdet_tpu_torch.experiments.tap_floor --chain-ms MS --d0-ms MS

(``--chain-ms``: ``packed_chain``'s D0 baseline; ``--d0-ms``: ``chip_smoke.py``'s
pipeline ms per call, both from the same card.)
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Tuple

import torch

from ..models.detector import resolve_device
from ..ops.tap_floor_kernel import tap_floor
from .timing import HBM_BYTES_S, cuda_ms

# D0 @512, per image: the five depthwise convs of stages 1-3 (name, k,
# C_expanded, input side, output side, has_expand). Stride-2 taps count at
# the output positions; the expand's swish lives at the input resolution.
D0_STAGE123_DW = [
    ("s1   k3 c32", 3, 32, 256, 256, False),
    ("s2b0 k3 c96", 3, 96, 256, 128, True),
    ("s2b1 k3 c144", 3, 144, 128, 128, True),
    ("s3b0 k5 c144", 5, 144, 128, 64, True),
    ("s3b1 k5 c240", 5, 240, 64, 64, True),
]

# the same region's 1x1 products: (name, M = pixels, K = cin, N = cout) per image
D0_STAGE123_MM = [
    ("s1 proj", 256 * 256, 32, 16),
    ("s2b0 exp", 256 * 256, 16, 96),
    ("s2b0 proj", 128 * 128, 96, 24),
    ("s2b1 exp", 128 * 128, 24, 144),
    ("s2b1 proj", 128 * 128, 144, 24),
    ("s3b0 exp", 128 * 128, 24, 144),
    ("s3b0 proj", 64 * 64, 144, 40),
    ("s3b1 exp", 64 * 64, 40, 240),
    ("s3b1 proj", 64 * 64, 240, 40),
]

BATCH = 128  # the D0 inference batch
ROWS, COLS = 512 * 8, 1024  # the floor's 4 Mi elements


def measure_rate(op: str, taps: int, repeats: int, steps: int, dtype=torch.float32,
                 chains: int = 1, device=None) -> Tuple[float, float]:
    """(G element-ops/s, ms per call) of the floor kernel: FMAs/s for
    ``"fma"``, swishes/s for ``"swish"``. On the CPU (only when asked) the
    plain version runs on one (8, 128) block."""
    dev = resolve_device(device)
    shape = (ROWS, COLS) if dev.type == "cuda" else (8, 128)
    x = torch.ones(shape, dtype=dtype, device=dev)
    if dev.type == "cuda":
        ms = cuda_ms(lambda: tap_floor(x, op, taps, repeats, chains), steps, warmup=1)
    else:
        t0 = time.perf_counter()
        for _ in range(steps):
            tap_floor(x, op, taps, repeats, chains)
        ms = (time.perf_counter() - t0) / steps * 1e3
    elems = x.numel() * repeats * (taps if op == "fma" else chains)
    return elems / (ms * 1e-3) / 1e9, ms


def measure_mm_ms(steps: int, device=None) -> Dict[str, float]:
    """Device ms of each of the region's 1x1 products at batch 128, bf16,
    as ``torch.matmul`` into a preallocated output."""
    dev = resolve_device(device)
    out = {}
    for name, m, k, n in D0_STAGE123_MM:
        a = torch.ones((BATCH, m, k), dtype=torch.bfloat16, device=dev)
        b = torch.ones((k, n), dtype=torch.bfloat16, device=dev)
        y = torch.empty((BATCH, m, n), dtype=torch.bfloat16, device=dev)
        out[name] = cuda_ms(lambda: torch.matmul(a, b, out=y), steps)
        del a, b, y
    return out


def ceiling_from_rates(r_fma_gops: float, r_swish_gops: float, t_mm_ms: float,
                       hbm_bytes_s: float, chain_ms: float, d0_ms: float) -> Dict:
    """The stages-1-3 single-kernel floor at D0 batch 128 from measured rates."""
    tap_fmas = sum(BATCH * k * k * c * so * so for _, k, c, si, so, _e in D0_STAGE123_DW)
    # swishes: after each expand (input resolution) and each depthwise (output)
    act_elems = sum(
        BATCH * c * ((si * si if has_expand else 0) + so * so)
        for _, k, c, si, so, has_expand in D0_STAGE123_DW
    )
    t_taps = tap_fmas / (r_fma_gops * 1e9) * 1e3
    t_acts = act_elems / (r_swish_gops * 1e9) * 1e3
    # the chain reads the stem's output and writes stage 3's, bf16
    hbm_bytes = BATCH * (256 * 256 * 32 + 64 * 64 * 40) * 2
    t_hbm = hbm_bytes / hbm_bytes_s * 1e3
    floor = t_taps + t_acts + t_mm_ms + t_hbm
    return {
        "tap_gfmas": tap_fmas / 1e9,
        "act_gelems": act_elems / 1e9,
        "t_taps_ms": t_taps,
        "t_acts_ms": t_acts,
        "t_mm_ms": t_mm_ms,
        "t_hbm_ms": t_hbm,
        "floor_ms": floor,
        "chain_ms": chain_ms,
        "max_saving_ms": chain_ms - floor,
        "max_saving_pct_of_d0": (chain_ms - floor) / d0_ms * 100,
    }


def measure_floor(repeats: int = 512, steps: int = 10, device=None) -> Dict:
    """The rates over float32/bf16 x chains 1/4 (taps 9), the float32 swish
    rate, and the products' ms. The floor prices the taps at the float32
    rate with 4 chains: the fused block takes its taps in float32."""
    rates = []
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for chains in (1, 4):
            r, ms = measure_rate("fma", 9, repeats, steps, dtype, chains, device)
            rates.append({"op": "fma", "dtype": dname, "chains": chains,
                          "rate_g_s": r, "kernel_ms": ms})
    r, ms = measure_rate("swish", 1, repeats, steps, torch.float32, 1, device)
    rates.append({"op": "swish", "dtype": "f32", "chains": 1, "rate_g_s": r, "kernel_ms": ms})
    mm = measure_mm_ms(steps, device)
    tap_rate = next(x["rate_g_s"] for x in rates
                    if (x["op"], x["dtype"], x["chains"]) == ("fma", "f32", 4))
    return {"rates": rates, "mm_ms": mm, "tap_fma_g_s": tap_rate,
            "swish_g_s": r, "t_mm_ms": sum(mm.values())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--chain-ms", type=float, required=True,
                    help="the D0 chain's block-chain baseline on this card (packed_chain)")
    ap.add_argument("--d0-ms", type=float, required=True,
                    help="D0 batch-128 ms per call on this card (chip_smoke.py pipeline)")
    args = ap.parse_args(argv)
    floor = measure_floor(args.repeats, args.steps)
    print(json.dumps(floor), flush=True)
    print(json.dumps(ceiling_from_rates(floor["tap_fma_g_s"], floor["swish_g_s"],
                                        floor["t_mm_ms"], HBM_BYTES_S, args.chain_ms,
                                        args.d0_ms)), flush=True)


if __name__ == "__main__":
    main()
