"""Fused stride-1 inference MBConv: one CUDA kernel family, three layouts, plain twins.

Counterpart of the JAX package's experiments ``packed_mbconv_pallas.py``
(``packed_mbconv``, ``packed_mbconv_rp``) and ``mbconv_pallas.py``
(``fused_mbconv_s1``). All three compute, for one stride-1 block with its BN
folded into the convs' biases,

    y = proj(SE(swish(dw(swish(expand(x)))))) [+ x]

and differ only in the activations' layout:

  packed  (B, C, H*W)                   the port's NCHW memory;
  rp      (B, C, (H+2RP)*(W+2RP))       rows and columns padded by RP = 2,
                                        gap lanes zero, with a 0/1 mask of the
                                        real lanes (``rp_mask``);
  nhwc    (B, H, W, C).

Parameters travel as the JAX experiments' packed tuple (``pack_params``):
``(wexp (Cin, Ce), bexp (Ce, 1), wdw (Ce, k*k), bdw (Ce, 1), wser (Ce, Cr),
bser (Cr, 1), wsee (Cr, Ce), bsee (Ce, 1), wproj (Ce, Cout), bproj (Cout,
1))`` in the activations' dtype; without an expand, ``wexp`` and ``bexp`` are
(1, 1) placeholders.

Rounding points, shared by the kernel and the plain versions: the expanded
activation is rounded to the input dtype after its swish; the taps, their
swish and the SE run in float32; the SE-scaled activation is rounded to the
input dtype before the project, whose sums are float32. The zero padding of
the depthwise conv belongs to the expanded activation.

The wrappers launch ``csrc/fused_mbconv.cu`` for CUDA tensors (one count on
each wrapper's ``launches`` per call; a call is three launches: the SE pool,
the SE scale, the project; the row-padded layout adds a fourth that writes
its gap lanes) and take the plain version only for CPU tensors.

The kernel's plan is mirrored here in plain Python, where the CPU tests can
reach it: its tile and chunk (``tile_config``), its shared memory
(``smem_bytes``), its walk of the row-padded layout (``rp_tile_lanes``,
``rp_ring_lanes``), the zero padding of its products' operands
(``zero_padded_k``) and its bf16 swish (``tanh_swish``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

RP = 2  # the row-padded layout's pad: covers the taps of k3 and k5

Packed = Tuple[torch.Tensor, ...]


# ------------------------------------------------------------ layout helpers


def pack_x(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> contiguous (B, C, H*W): a copy of NHWC memory, free for a
    channels-first tensor seen as NHWC (``unpack_x``'s output)."""
    b, h, w, c = x.shape
    return x.permute(0, 3, 1, 2).contiguous().view(b, c, h * w)


def unpack_x(xp: torch.Tensor, hw: int) -> torch.Tensor:
    """(B, C, H*W) -> NHWC (B, H, W, C), a view."""
    b, c, _ = xp.shape
    return xp.reshape(b, c, hw, hw).permute(0, 2, 3, 1)


def rp_dims(hw: int) -> int:
    return hw + 2 * RP


def pack_rp(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> row-padded (B, C, Hp*Wp), gaps zero."""
    b, h, w, c = x.shape
    xt = F.pad(x.permute(0, 3, 1, 2).contiguous(), (RP, RP, RP, RP))
    return xt.view(b, c, rp_dims(h) * rp_dims(w))


def unpack_rp(xp: torch.Tensor, hw: int) -> torch.Tensor:
    """Row-padded (B, C, Hp*Wp) -> NHWC (B, H, W, C) of the real lanes."""
    b, c, _ = xp.shape
    hp = rp_dims(hw)
    return xp.reshape(b, c, hp, hp)[:, :, RP:RP + hw, RP:RP + hw].permute(0, 2, 3, 1)


def rp_mask(hw: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """(1, Hp*Wp) 0/1 mask of the real lanes."""
    hp = rp_dims(hw)
    m = torch.zeros((hp, hp), dtype=dtype, device=device)
    m[RP:RP + hw, RP:RP + hw] = 1
    return m.reshape(1, hp * hp)


def _taps(ksize: int):
    p = (ksize - 1) // 2
    return [(dy, dx) for dy in range(-p, p + 1) for dx in range(-p, p + 1)]


# ------------------------------------------------------------- plain versions


def _expand(x3: torch.Tensor, wexp, bexp) -> torch.Tensor:
    """(B, Cin, N) -> swish(Wexp^T x + b) rounded to x's dtype, sums in float32."""
    e = torch.einsum("ie,bin->ben", wexp.float(), x3.float())
    return F.silu(e + bexp.float()).to(x3.dtype)


def _se_project(dwo: torch.Tensor, pool: torch.Tensor, packed: Packed, dtype) -> torch.Tensor:
    """SE scale from the (B, Ce, 1) mean, scaled and rounded, then projected."""
    _, _, _, _, wser, bser, wsee, bsee, wproj, bproj = packed
    r = F.silu(torch.einsum("er,ben->brn", wser.float(), pool) + bser.float())
    scale = torch.sigmoid(torch.einsum("re,brn->ben", wsee.float(), r) + bsee.float())
    sdw = (dwo * scale).to(dtype)
    return torch.einsum("eo,ben->bon", wproj.float(), sdw.float()) + bproj.float()


def packed_mbconv_reference(xp: torch.Tensor, packed: Packed, shape) -> torch.Tensor:
    """Plain twin on (B, Cin, H*W): the JAX ``xla_packed_mbconv``."""
    wexp, bexp, wdw, bdw = packed[:4]
    b, _, n = xp.shape
    w = shape.hw
    if n != w * w:
        raise ValueError(f"packed x has {n} lanes, not {w}x{w}")
    p = (shape.ksize - 1) // 2
    pad = p * w + p
    e = _expand(xp, wexp, bexp) if shape.has_expand else xp
    epad = F.pad(e, (pad, pad))
    col = torch.arange(n, device=xp.device) % w
    acc = torch.zeros((b, e.shape[1], n), dtype=torch.float32, device=xp.device)
    for t, (dy, dx) in enumerate(_taps(shape.ksize)):
        off = pad + dy * w + dx
        v = epad[:, :, off:off + n].float()
        if dx > 0:
            v = torch.where(col < w - dx, v, 0.0)
        elif dx < 0:
            v = torch.where(col >= -dx, v, 0.0)
        acc = acc + v * wdw[:, t:t + 1].float()
    dwo = F.silu(acc + bdw.float())
    y = _se_project(dwo, dwo.mean(dim=2, keepdim=True), packed, xp.dtype)
    if shape.has_skip:
        y = y + xp.float()
    return y.to(xp.dtype)


def packed_mbconv_rp_reference(xp: torch.Tensor, mask: torch.Tensor, packed: Packed,
                               shape) -> torch.Tensor:
    """Plain twin on the row-padded layout: the JAX ``_rp_kernel``'s math."""
    wexp, bexp, wdw, bdw = packed[:4]
    b, _, n_p = xp.shape
    wp = rp_dims(shape.hw)
    if n_p != wp * wp:
        raise ValueError(f"row-padded x has {n_p} lanes, not {wp}x{wp}")
    m = mask.reshape(1, 1, n_p).float()
    halo = RP * wp + RP
    if shape.has_expand:
        e = torch.einsum("ie,bin->ben", wexp.float(), xp.float())
        e = (F.silu(e + bexp.float()) * m).to(xp.dtype)
    else:
        e = xp
    epad = F.pad(e, (halo, halo))
    p = (shape.ksize - 1) // 2
    acc = torch.zeros((b, e.shape[1], n_p), dtype=torch.float32, device=xp.device)
    for dy in range(-p, p + 1):
        for dx in range(-p, p + 1):
            off = halo + dy * wp + dx
            t = (dy + p) * shape.ksize + (dx + p)
            acc = acc + epad[:, :, off:off + n_p].float() * wdw[:, t:t + 1].float()
    dwo = F.silu(acc + bdw.float())
    pool = (dwo * m).sum(dim=2, keepdim=True) * (1.0 / (shape.hw * shape.hw))
    y = _se_project(dwo, pool, packed, xp.dtype) * m
    if shape.has_skip:
        y = y + xp.float()
    return y.to(xp.dtype)


def fused_mbconv_nhwc_reference(x: torch.Tensor, packed: Packed, ksize: int,
                                has_skip: bool) -> torch.Tensor:
    """Plain twin on NHWC (B, H, W, Cin), the same math on (B, C, H, W) inside."""
    wexp, bexp, wdw, bdw = packed[:4]
    b, h, w, cin = x.shape
    cexp = wdw.shape[0]
    e = x.permute(0, 3, 1, 2).reshape(b, cin, h * w)
    if tuple(wexp.shape) != (1, 1):
        e = _expand(e, wexp, bexp)
    p = ksize // 2
    epad = F.pad(e.reshape(b, cexp, h, w), (p, p, p, p))
    acc = torch.zeros((b, cexp, h, w), dtype=torch.float32, device=x.device)
    for t, (dy, dx) in enumerate(_taps(ksize)):
        v = epad[:, :, p + dy:p + dy + h, p + dx:p + dx + w].float()
        acc = acc + v * wdw[:, t].float().reshape(1, cexp, 1, 1)
    dwo = F.silu(acc + bdw.float().reshape(1, cexp, 1, 1)).reshape(b, cexp, h * w)
    y = _se_project(dwo, dwo.mean(dim=2, keepdim=True), packed, x.dtype)
    y = y.reshape(b, -1, h, w).permute(0, 2, 3, 1)
    if has_skip:
        y = y + x.float()
    return y.to(x.dtype)


# ------------------------------------------------- the kernel's plan, mirrored

SMEM_MAX = 232448   # dynamic shared memory a block may ask for on an H100
TILE_W = 32         # tile width in pixels
HALO_COLS = 36      # pitch of a halo row: TILE_W + 2 * 2, for k3 too
MAX_COUT = 64       # eight column tiles of 8 in the project
MAX_CIN_BF16 = 64   # four K steps of 16 in the bf16 expand


def tile_config(dtype) -> Tuple[int, int]:
    """(tile rows, channels a chunk) of the kernel for ``dtype``; a block has
    32 threads a tile row."""
    return (16, 32) if dtype == torch.bfloat16 else (8, 16)


def tiles_of(h: int, w: int, dtype) -> int:
    """Spatial tiles of an h x w grid of real pixels (the row-padded layout
    walks its real lanes, so its count is the packed layout's)."""
    th, _ = tile_config(dtype)
    return -(-w // TILE_W) * -(-h // th)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _odd8(n: int) -> int:
    """The least odd multiple of 8 that holds n (a shared-memory row pitch)."""
    return 8 * (-(-n // 8) | 1)


def x_tile_rows(cin: int, cexp: int, has_expand: bool, dtype) -> int:
    """Channel rows of the x halo tile: Cin padded to the bf16 products' K
    step of 16; without an expand the taps read x itself, Ce rows."""
    if not has_expand:
        return cexp
    return -(-cin // 16) * 16 if dtype == torch.bfloat16 else cin


def column_tiles(cout: int, dtype) -> int:
    """Column tiles of 8 of the project: ceil(Cout / 8) in bf16; float32
    rounds them up to 1, 2, 4 or 8."""
    nt = -(-cout // 8)
    return nt if dtype == torch.bfloat16 or nt <= 2 else 4 if nt <= 4 else 8


def smem_bytes(cin: int, cexp: int, cout: int, ksize: int, has_expand: bool, dtype,
               project: bool) -> int:
    """Dynamic shared memory of one block of the pool pass or the project
    pass: ``smem_plan`` of csrc/fused_mbconv.cu, byte for byte."""
    th, cc = tile_config(dtype)
    sz = 2 if dtype == torch.bfloat16 else 4
    pixp = (th + 2 * (ksize // 2)) * HALO_COLS
    s, sds, wes = _odd8(pixp), _odd8(th * TILE_W), cc + 8
    xrows = x_tile_rows(cin, cexp, has_expand, dtype)
    nt = column_tiles(cout, dtype) if project else 0
    o = _align16(xrows * s * sz)
    es = o
    if has_expand:
        o += _align16(cc * s * sz)
    if project:
        o += _align16(cc * sds * sz)
        o = max(o, es + _align16(cout * sds * sz))   # the output tile aliases es and sd
    o += _align16(pixp * 4)
    w = _align16(xrows * wes * sz) if has_expand else 0
    w += _align16(cc * sz) + _align16(cc * ksize * ksize * sz) + _align16(cc * sz) + cc * 4
    if project:
        w += _align16(cc * 8 * ((nt + 1) | 1) * sz)
    return o + 2 * w


def rp_tile_lanes(hw: int, dtype) -> torch.Tensor:
    """Lanes of the row-padded layout that the tiles' blocks write, in the
    kernel's order (tile by tile, row by row): the real lanes."""
    th, _ = tile_config(dtype)
    wp = rp_dims(hw)
    lanes = []
    for y0 in range(0, hw, th):
        for x0 in range(0, hw, TILE_W):
            ys = torch.arange(y0, min(y0 + th, hw))
            xs = torch.arange(x0, min(x0 + TILE_W, hw))
            lanes.append(((ys[:, None] + RP) * wp + xs[None, :] + RP).reshape(-1))
    return torch.cat(lanes)


def rp_ring_lanes(hw: int) -> torch.Tensor:
    """Lanes the gap launch writes, by its thread index: RP rows above the
    grid, the 2 RP lanes beside each of its rows, the rows below."""
    wp = rp_dims(hw)
    top, side = RP * wp, wp - hw
    mid = hw * side
    idx = torch.arange(wp * wp - hw * hw)
    row, j = (idx - top) // side, (idx - top) % side
    middle = (RP + row) * wp + torch.where(j < RP, j, hw + j)
    below = (RP + hw) * wp + idx - top - mid
    return torch.where(idx < top, idx, torch.where(idx < top + mid, middle, below))


def zero_padded_k(act: torch.Tensor, w: torch.Tensor, step: int):
    """A product's operands as the kernel pads its K: ``act`` (B, K, N) and
    ``w`` (K, M) with zero rows from K up to the next multiple of ``step``
    (the bf16 expand pads Cin to 16, the project Ce to the chunk)."""
    pad = -act.shape[1] % step
    return F.pad(act, (0, 0, 0, pad)), F.pad(w, (0, 0, 0, pad))


def tanh_swish(v: torch.Tensor, rel_err: float = 0.0) -> torch.Tensor:
    """The bf16 kernels' swish, 0.5 v (1 + tanh(0.5 v)): one special-function
    instruction (``tanh.approx.f32``, relative error at most 2^-11, which
    ``rel_err`` models as a factor on the tanh)."""
    h = 0.5 * v
    return h + h * (torch.tanh(h) * (1.0 + rel_err))


# ------------------------------------------------------------------- kernels


def _check(name: str, x: torch.Tensor, packed: Packed, cin: int, ksize: int,
           has_expand: bool) -> Tuple[list, int, int, int]:
    """Validate a CUDA call; returns (params in x's dtype, Ce, Cout, Cr)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if len(packed) != 10:
        raise ValueError(f"{name}: packed holds {len(packed)} tensors, not 10")
    if ksize not in (3, 5):
        raise ValueError(f"{name}: kernel size {ksize} is not 3 or 5")
    params = [p.to(device=x.device, dtype=x.dtype).contiguous() for p in packed]
    wexp, bexp, wdw, bdw, wser, bser, wsee, bsee, wproj, bproj = params
    cexp, cr, cout = wdw.shape[0], wser.shape[1], wproj.shape[1]
    want = {
        "wexp": ((cin, cexp) if has_expand else (1, 1), wexp),
        "bexp": ((cexp, 1) if has_expand else (1, 1), bexp),
        "wdw": ((cexp, ksize * ksize), wdw), "bdw": ((cexp, 1), bdw),
        "wser": ((cexp, cr), wser), "bser": ((cr, 1), bser),
        "wsee": ((cr, cexp), wsee), "bsee": ((cexp, 1), bsee),
        "wproj": ((cexp, cout), wproj), "bproj": ((cout, 1), bproj),
    }
    bad = {k: tuple(t.shape) for k, (s, t) in want.items() if tuple(t.shape) != s}
    if bad or (not has_expand and cexp != cin):
        raise ValueError(f"{name}: packed shapes {bad} do not fit Cin={cin}, Ce={cexp}")
    if cout > MAX_COUT:
        raise ValueError(f"{name}: at most {MAX_COUT} output channels, got {cout}")
    if x.dtype == torch.bfloat16 and has_expand and cin > MAX_CIN_BF16:
        raise ValueError(f"{name}: at most {MAX_CIN_BF16} input channels in bf16, got {cin}")
    need = smem_bytes(cin, cexp, cout, ksize, has_expand, x.dtype, project=True)
    if need > SMEM_MAX:
        raise ValueError(f"{name}: a block needs {need} bytes of shared memory, "
                         f"more than {SMEM_MAX}")
    return params, cexp, cout, cr


def _run(name: str, x: torch.Tensor, mask, packed: Packed, out_shape, grid_hw,
         cin: int, ksize: int, has_expand: bool, has_skip: bool) -> torch.Tensor:
    """Launch ``fused_mbconv_<name>_launch`` on the ``grid_hw`` real pixels."""
    from . import cuda_build

    params, cexp, cout, cr = _check(name, x, packed, cin, ksize, has_expand)
    if has_skip and cout != cin:
        raise ValueError(f"{name}: a skip needs Cout == Cin, got {cout} and {cin}")
    lib = cuda_build.load("fused_mbconv")
    b = x.shape[0]
    h, w = grid_hw
    tiles = tiles_of(h, w, x.dtype)
    partial = torch.empty((b, tiles, cexp), dtype=torch.float32, device=x.device)
    scale = torch.empty((b, cexp), dtype=torch.float32, device=x.device)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    ptrs = (ctypes.c_void_p * 10)(*[p.data_ptr() for p in params])
    fn = getattr(lib, f"fused_mbconv_{name}_launch")
    fn.restype = ctypes.c_int
    sizes = [b, h, w] + ([RP] if mask is not None else []) + [
        cin, cexp, cout, cr, ksize, int(has_expand), int(has_skip),
        int(x.dtype == torch.bfloat16)]
    ptr_args = [x.data_ptr()] + ([mask.data_ptr()] if mask is not None else [])
    fn.argtypes = ([ctypes.c_void_p] * len(ptr_args) + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * len(sizes) + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*ptr_args, ctypes.cast(ptrs, ctypes.c_void_p), out.data_ptr(),
                 partial.data_ptr(), scale.data_ptr(), *sizes, stream)
    cuda_build.check(lib, "fused_mbconv", err)
    return out


def _device_of(name: str, x: torch.Tensor, *tensors: torch.Tensor) -> str:
    """The one device type of a call's tensors; x must be contiguous on any."""
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    kinds = {t.device.type for t in (x, *tensors)}
    if len(kinds) != 1:
        raise ValueError(f"{name}: tensors lie on {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {kind}")
    return kind


def packed_mbconv(xp: torch.Tensor, packed: Packed, shape) -> torch.Tensor:
    """Fused stride-1 MBConv on (B, Cin, H*W) -> (B, Cout, H*W).

    ``shape`` gives ``hw`` (the square side), ``ksize``, ``has_expand`` and
    ``has_skip`` (an ``experiments.packed_mbconv.BlockShape``).
    """
    if _device_of("packed_mbconv", xp, *packed) == "cpu":
        return packed_mbconv_reference(xp, packed, shape)
    b, cin, n = xp.shape
    if n != shape.hw * shape.hw:
        raise ValueError(f"packed x has {n} lanes, not {shape.hw}x{shape.hw}")
    cout = packed[8].shape[1]
    out = _run("packed", xp, None, packed, (b, cout, n), (shape.hw, shape.hw),
               cin, shape.ksize, shape.has_expand, shape.has_skip)
    packed_mbconv.launches += 1
    return out


def packed_mbconv_rp(xp: torch.Tensor, mask: torch.Tensor, packed: Packed,
                     shape) -> torch.Tensor:
    """Fused stride-1 MBConv on the row-padded layout; output gap lanes exactly 0."""
    if _device_of("packed_mbconv_rp", xp, mask, *packed) == "cpu":
        return packed_mbconv_rp_reference(xp, mask, packed, shape)
    b, cin, n_p = xp.shape
    wp = rp_dims(shape.hw)
    if n_p != wp * wp or mask.numel() != n_p:
        raise ValueError(f"row-padded x has {n_p} lanes and the mask {mask.numel()}, "
                         f"not {wp}x{wp}")
    cout = packed[8].shape[1]
    m = mask.to(xp.dtype).contiguous()
    out = _run("rp", xp, m, packed, (b, cout, n_p), (shape.hw, shape.hw),
               cin, shape.ksize, shape.has_expand, shape.has_skip)
    packed_mbconv_rp.launches += 1
    return out


def fused_mbconv_nhwc(x: torch.Tensor, packed: Packed, ksize: int,
                      has_skip: bool) -> torch.Tensor:
    """Fused stride-1 MBConv on NHWC (B, H, W, Cin) -> (B, H, W, Cout)."""
    if _device_of("fused_mbconv_nhwc", x, *packed) == "cpu":
        return fused_mbconv_nhwc_reference(x, packed, ksize, has_skip)
    b, h, w, cin = x.shape
    cout = packed[8].shape[1]
    has_expand = tuple(packed[0].shape) != (1, 1)
    out = _run("nhwc", x, None, packed, (b, h, w, cout), (h, w), cin, ksize,
               has_expand, has_skip)
    fused_mbconv_nhwc.launches += 1
    return out


packed_mbconv.launches = 0
packed_mbconv_rp.launches = 0
fused_mbconv_nhwc.launches = 0

