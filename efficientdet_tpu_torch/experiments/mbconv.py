"""The fused stride-1 inference MBConv on NHWC, from a folded flax param dict.

Counterpart of the JAX package's ``experiments/mbconv_pallas.py``
(``fused_mbconv_s1``), on the port's NHWC launcher of
``csrc/fused_mbconv.cu`` (``ops/mbconv_kernel.fused_mbconv_nhwc``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.mbconv_kernel import fused_mbconv_nhwc


def packed_from_flax(params: Dict, ksize: int, dtype: torch.dtype,
                     device) -> Tuple[torch.Tensor, ...]:
    """A folded flax MBConv param dict (numpy or tensors) -> the packed tuple."""

    def t(v, *shape):
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v, np.float32))
        return v.to(device=device, dtype=dtype).reshape(*shape)

    dw = params["depthwise_conv"]["kernel"]  # (k, k, 1, Ce)
    cexp = dw.shape[-1]
    cr = params["se"]["reduce"]["kernel"].shape[-1]
    cout = params["project_conv"]["kernel"].shape[-1]
    if "expand_conv" in params:
        cin = params["expand_conv"]["kernel"].shape[-2]
        wexp = t(params["expand_conv"]["kernel"], cin, cexp)
        bexp = t(params["expand_conv"]["bias"], cexp, 1)
    else:
        wexp = bexp = torch.zeros((1, 1), dtype=dtype, device=device)
    return (
        wexp, bexp,
        t(dw, ksize * ksize, cexp).t(), t(params["depthwise_conv"]["bias"], cexp, 1),
        t(params["se"]["reduce"]["kernel"], cexp, cr), t(params["se"]["reduce"]["bias"], cr, 1),
        t(params["se"]["expand"]["kernel"], cr, cexp), t(params["se"]["expand"]["bias"], cexp, 1),
        t(params["project_conv"]["kernel"], cexp, cout),
        t(params["project_conv"]["bias"], cout, 1),
    )


def fused_mbconv_s1(x: torch.Tensor, params: Dict, ksize: int, has_skip: bool,
                    tile_h: Optional[int] = None) -> torch.Tensor:
    """Fused stride-1 inference MBConv, (B, H, W, Cin) -> (B, H, W, Cout).

    ``params`` is the folded param dict of ``MBConvBlock(fuse_bn=True)`` in
    flax layout: optional ``expand_conv{kernel (1,1,Cin,Ce), bias}``,
    ``depthwise_conv{kernel (k,k,1,Ce), bias}``,
    ``se/{reduce,expand}{kernel (1,1,i,o), bias}``,
    ``project_conv{kernel (1,1,Ce,Cout), bias}``; weights are cast to x's
    dtype. ``tile_h`` keeps the JAX function's contract (H % tile_h == 0,
    default 32 rows from H >= 64); the kernel picks its own 8 x 32 tiles.

    This computes the block's own function: the depthwise conv's zero
    padding belongs to the expanded activation. The JAX kernel pads x before
    its expand (``experiments/mbconv_pallas.py:182``), so its halo holds
    ``swish(b_exp)`` instead of zeros and its border rows, and through the SE
    mean every row, differ from the flax block when the expand bias is not 0.
    """
    h = x.shape[1]
    if tile_h is None:
        tile_h = 32 if h >= 64 else h
    if h % tile_h:
        raise ValueError(f"tile_h {tile_h} does not divide H = {h}")
    packed = packed_from_flax(params, ksize, x.dtype, x.device)
    return fused_mbconv_nhwc(x, packed, ksize, has_skip)
