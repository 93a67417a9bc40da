"""Inference-time BatchNorm folding on the port's state dict.

Counterpart of the JAX package's ``utils/fold_bn.py``. At inference a BN is
the affine ``y = s*x + t`` with ``s = scale/sqrt(var+eps)`` and
``t = bias - s*mean``; folding scales the preceding conv's kernel by ``s``
per output channel (dim 0 in torch's layout) and makes ``old_bias*s + t``
the conv's bias, in float32.

Folded are every backbone conv+BN pair, every BiFPN conv/sepconv+BN pair,
and the heads. Head BNs are per level while the head convs are shared, so
each folds into a per-level copy of the pointwise (``pw_l{lvl}_d{i}``) and
the depthwise stays shared (``conv{i}_dw``). The result loads into an
``EfficientDet(..., fuse_bn=True)``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _is_bn(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == set(_BN_LEAVES)


def _fold_pair(conv: Dict[str, torch.Tensor], bn: Dict[str, torch.Tensor],
               eps: float) -> Dict[str, torch.Tensor]:
    """Fold one BN into a conv {'weight'[, 'bias']} (weight out-channel first)."""
    s = bn["weight"].float() / torch.sqrt(bn["running_var"].float() + eps)
    t = bn["bias"].float() - s * bn["running_mean"].float()
    w = conv["weight"]
    new_w = w.float() * s.view(-1, *([1] * (w.dim() - 1)))
    old_b = conv.get("bias")
    old_b = torch.zeros_like(s) if old_b is None else old_b.float()
    return {"weight": new_w.to(w.dtype), "bias": (old_b * s + t).to(w.dtype)}


def _bn_partner(key: str) -> str | None:
    """BN module name -> sibling conv name, for foldable BNs only."""
    if key == "bn":
        return "conv"  # FusedNode: SeparableConv named 'conv'
    if key.endswith("_bn"):
        return key[:-3] + "_conv"
    return None


def _walk(node: Dict[str, Any], eps: float) -> None:
    """In place: fold foldable (conv, bn) sibling pairs, recurse elsewhere."""
    for k in [k for k in node if _is_bn(node[k]) and _bn_partner(k) in node]:
        conv_key = _bn_partner(k)
        conv = node[conv_key]
        if "weight" in conv:
            node[conv_key] = _fold_pair(conv, node[k], eps)
        elif "pointwise" in conv:  # SeparableConv: fold into the 1x1
            conv["pointwise"] = _fold_pair(conv["pointwise"], node[k], eps)
        else:
            raise ValueError(f"cannot fold BN {k!r} into {conv_key!r}")
        del node[k]
    for v in node.values():
        if isinstance(v, dict):
            _walk(v, eps)


def _fold_head(net: Dict[str, Any], eps: float) -> None:
    """conv{i}/{depthwise,pointwise} + bn_l{lvl}_d{i} -> conv{i}_dw + pw_l{lvl}_d{i}."""
    bn_keys = [k for k in net if re.fullmatch(r"bn_l\d+_d\d+", k)]
    if not bn_keys:
        return
    depth = 1 + max(int(re.search(r"_d(\d+)$", k).group(1)) for k in bn_keys)
    levels = 1 + max(int(re.search(r"bn_l(\d+)_", k).group(1)) for k in bn_keys)
    for i in range(depth):
        conv = net.pop(f"conv{i}")
        net[f"conv{i}_dw"] = {"weight": conv["depthwise"]["weight"]}
        for lvl in range(levels):
            net[f"pw_l{lvl}_d{i}"] = _fold_pair(
                conv["pointwise"], net.pop(f"bn_l{lvl}_d{i}"), eps
            )


def fold_bn_state_dict(state_dict: Dict[str, torch.Tensor], eps: float = 1e-3) -> Dict[str, torch.Tensor]:
    """Unfused ``EfficientDet`` state dict -> state dict of the fused model."""
    tree = _unflatten({tuple(k.split(".")): v.detach().clone() for k, v in state_dict.items()})
    for top in ("backbone", "bifpn"):
        if top in tree:
            _walk(tree[top], eps)
    for top in ("class_net", "box_net"):
        if top in tree and "net" in tree[top]:
            _fold_head(tree[top]["net"], eps)
    return {".".join(k): v for k, v in _flatten(tree).items()}
