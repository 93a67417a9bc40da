"""Four formulations of the stage-1 MBConv block's depthwise + project, timed.

Counterpart of the JAX package's ``experiments/stage1_packing_bench.py``,
which asked whether a TPU's 128 lanes are better filled by packing a 2 x 2
cell of pixels into the channels. The same block (depthwise 3x3 stride 1 on
48 channels at 512 x 512, swish, project 1x1 48 -> 24) in the same four
formulations, each an exact rearrangement of the same function:

  ref          the block on channels-last (NHWC) memory, as the JAX model
               runs it;
  s2d_grouped  2 x 2 space-to-depth, channel-minor (``s2d_cm``: packed
               channel c*4 + p*2 + q); the depthwise as a grouped conv of
               C groups, 4 -> 4 each, whose 3x3 packed kernel places the
               original taps; the project as an einsum over C; then
               ``d2s_cm``;
  s2d_taps     the same packing, the depthwise as 9 shifted multiply-adds
               a sub-pixel;
  nchw         the block in NCHW, with the transposes at its edges counted.

Inputs and outputs are (B, H, W, C) tensors, as in the JAX script; the
weights are ``dwk`` (3, 3, C) and ``pw`` (Cin, Cout). The forward and the
backward with respect to the weights (the gradient of sum(o^2)) are timed
together, as the JAX script times ``value_and_grad``; each variant is held
against ``ref`` at rtol/atol 3e-2 first. Library calls only (cuDNN and ATen):
no kernel is written here.

    python -m efficientdet_tpu_torch.experiments.stage1_packing   # on the GPU
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

BATCH, SIZE, CIN, COUT = 16, 512, 48, 24
STEPS = 20
TOL = 3e-2  # the JAX script's check against ref (bf16)


def dw_conv(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 stride 1 SAME, (B, H, W, C) channels-last; dwk (3, 3, C)."""
    xn = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
    k = dwk.permute(2, 0, 1)[:, None]  # (C, 1, 3, 3)
    return F.conv2d(xn, k, padding=1, groups=x.shape[-1]).permute(0, 2, 3, 1)


def pw_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pointwise 1x1, (B, H, W, Cin) channels-last; w (Cin, Cout)."""
    xn = x.permute(0, 3, 1, 2)
    return F.conv2d(xn, w.t()[:, :, None, None]).permute(0, 2, 3, 1)


def block_ref(x, dwk, pw):
    return pw_conv(F.silu(dw_conv(x, dwk)), pw)


def s2d_cm(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), packed channel c*4 + p*2 + q."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def d2s_cm(x: torch.Tensor, c: int) -> torch.Tensor:
    b, hh, ww, _ = x.shape
    x = x.reshape(b, hh, ww, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, hh * 2, ww * 2, c)


def _shifts():
    """(p, q, dy, dx, ry, rx, pp, qq): sub-pixel (p, q)'s tap (dy, dx) reads
    sub-pixel (pp, qq) of the cell (ry, rx) away."""
    for p in range(2):
        for q in range(2):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ry, pp = divmod(p + dy, 2)
                    rx, qq = divmod(q + dx, 2)
                    yield p, q, dy, dx, ry, rx, pp, qq


def packed_dw_kernel(dwk: torch.Tensor) -> torch.Tensor:
    """The grouped conv's kernel, OIHW (4C, 4, 3, 3): output channel
    c*4 + p*2 + q reads input sub-pixel pp*2 + qq of its group at cell
    offset (ry, rx) with the original tap (dy, dx)."""
    c = dwk.shape[-1]
    kj = dwk.new_zeros((4 * c, 4, 3, 3))
    idx = torch.arange(c, device=dwk.device) * 4
    for p, q, dy, dx, ry, rx, pp, qq in _shifts():
        kj[idx + (p * 2 + q), pp * 2 + qq, ry + 1, rx + 1] = dwk[dy + 1, dx + 1]
    return kj


def dw_packed_g(xp: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 on the packed layout as a grouped conv, C groups of 4 -> 4."""
    c = dwk.shape[-1]
    out = F.conv2d(xp.permute(0, 3, 1, 2), packed_dw_kernel(dwk), padding=1, groups=c)
    return out.permute(0, 2, 3, 1)


def pw_packed_cm(xp: torch.Tensor, w: torch.Tensor, c: int) -> torch.Tensor:
    """1x1 conv on the packed layout: an einsum over C."""
    b, hh, ww, _ = xp.shape
    out = torch.einsum("bhwcp,co->bhwop", xp.reshape(b, hh, ww, c, 4), w)
    return out.reshape(b, hh, ww, w.shape[1] * 4)


def block_s2d(x, dwk, pw):
    c = x.shape[-1]
    h = F.silu(dw_packed_g(s2d_cm(x), dwk))
    return d2s_cm(pw_packed_cm(h, pw, c), pw.shape[1])


def dw_tap(xp: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """Depthwise as 9 shifted multiply-adds a sub-pixel on the packed layout
    (one packed cell of zeros on each side covers the 1-pixel halo)."""
    c = dwk.shape[-1]
    b, hh, ww, _ = xp.shape
    x5 = xp.reshape(b, hh, ww, c, 2, 2)
    xpad = F.pad(x5, (0, 0, 0, 0, 0, 0, 1, 1, 1, 1))
    acc = {}
    for p, q, dy, dx, ry, rx, pp, qq in _shifts():
        src = xpad[:, 1 + ry:1 + ry + hh, 1 + rx:1 + rx + ww, :, pp, qq]
        term = src * dwk[dy + 1, dx + 1]
        acc[p, q] = term if (p, q) not in acc else acc[p, q] + term
    out = torch.stack([acc[p, q] for p in range(2) for q in range(2)], dim=-1)
    return out.reshape(b, hh, ww, c * 4)


def block_tap(x, dwk, pw):
    c = x.shape[-1]
    h = F.silu(dw_tap(s2d_cm(x), dwk))
    return d2s_cm(pw_packed_cm(h, pw, c), pw.shape[1])


def block_nchw(x, dwk, pw):
    """The block in NCHW, the transposes at its edges included."""
    c = x.shape[-1]
    xn = x.permute(0, 3, 1, 2).contiguous()
    h = F.silu(F.conv2d(xn, dwk.permute(2, 0, 1)[:, None], padding=1, groups=c))
    o = F.conv2d(h, pw.t()[:, :, None, None])
    return o.permute(0, 2, 3, 1).contiguous()


VARIANTS = {"ref_nhwc": block_ref, "s2d_grouped": block_s2d, "s2d_taps": block_tap,
            "nchw": block_nchw}


def forward_backward(block, x, dwk, pw):
    """(sum(o^2), o, (d/d dwk, d/d pw)) of one call, as the JAX script's
    ``value_and_grad`` with ``has_aux``."""
    dwk = dwk.detach().requires_grad_(True)
    pw = pw.detach().requires_grad_(True)
    o = block(x, dwk, pw)
    val = (o * o).sum()
    grads = torch.autograd.grad(val, (dwk, pw))
    return val.detach(), o.detach(), grads


def inputs(batch=BATCH, size=SIZE, cin=CIN, cout=COUT, dtype=torch.bfloat16, device="cuda",
           seed=0):
    """The JAX script's draws: numpy ``RandomState(seed)``, N(0, 0.1) each;
    x on channels-last memory, (B, H, W, C)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, size, size, cin) * 0.1
    dwk = rng.randn(3, 3, cin) * 0.1
    pw = rng.randn(cin, cout) * 0.1
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)
                 for a in (x, dwk, pw))


def run(batch=BATCH, size=SIZE, cin=CIN, cout=COUT, steps=STEPS, dtype=torch.bfloat16,
        device="cuda") -> list:
    """One record a variant: ms of a forward + weight-gradient call (CUDA
    events over ``steps`` calls after a warm-up) and its largest distance
    from ``ref`` over the check's tolerance."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    from .timing import cuda_ms

    x, dwk, pw = inputs(batch, size, cin, cout, dtype, device)
    _, ref, _ = forward_backward(block_ref, x, dwk, pw)
    ref = ref.float()
    out = []
    for name, block in VARIANTS.items():
        _, o, _ = forward_backward(block, x, dwk, pw)
        excess = ((o.float() - ref).abs() / (TOL + TOL * ref.abs())).max().item()
        if not excess <= 1.0:
            raise AssertionError(f"stage1 {name} disagrees with ref: {excess} of rtol/atol {TOL}")
        ms = (cuda_ms(lambda: forward_backward(block, x, dwk, pw), iters=steps)
              if device.type == "cuda" else None)
        out.append({"variant": name, "ms": ms, "err_over_tol": excess})
        del o
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--cin", type=int, default=CIN)
    ap.add_argument("--cout", type=int, default=COUT)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    args = ap.parse_args()
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    for rec in run(args.batch, args.size, args.cin, args.cout, args.steps, dtype):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
