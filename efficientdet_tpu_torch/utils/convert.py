"""Weight bridge: a flax variables tree (as numpy) -> the port's state dict.

The port's modules carry the flax module names, so a flax path maps onto a
torch key by joining with ``.`` and renaming the leaf:

  params/.../kernel          -> ....weight   4-D: HWIO -> OIHW (a depthwise
                                              (kh, kw, 1, C) becomes (C, 1, kh, kw))
  params/.../scale           -> ....weight   (BatchNorm)
  params/.../bias            -> ....bias
  params/.../fusion_weights  -> ....fusion_weights
  batch_stats/.../mean       -> ....running_mean
  batch_stats/.../var        -> ....running_var

It takes the unfused tree and the output of the JAX package's
``fold_bn_variables`` alike. An unknown leaf name raises here; keys the
model lacks or leaves it without raise in :func:`load_flax_variables`.

:func:`adam_state_from_optax` bridges a training state's optimizer: optax's
Adam moments (``mu``, ``nu``: trees shaped like ``params``) and its count
become the port's ``train_lib.Optimizer`` state, so a step can start from a
JAX step's state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .fold_bn import _flatten

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "fusion_weights": "fusion_weights"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def from_flax_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': ..., ['batch_stats': ...]} of numpy arrays -> state dict."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unknown variable collections: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for coll, names in (("params", _PARAM_LEAVES), ("batch_stats", _STAT_LEAVES)):
        for path, value in _flatten(dict(variables.get(coll, {}))).items():
            leaf = path[-1]
            if leaf not in names:
                raise ValueError(f"unknown {coll} leaf {'/'.join(path)!r}")
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if leaf == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            key = ".".join(path[:-1] + (names[leaf],))
            if key in out:
                raise ValueError(f"two flax leaves map onto {key!r}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_variables(model: torch.nn.Module, variables: Dict[str, Any]) -> torch.nn.Module:
    """Load a flax tree into ``model``; missing, left-over or misshapen keys raise."""
    sd = from_flax_variables(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    bad = sorted(k for k in set(sd) & set(own) if sd[k].shape != own[k].shape)
    if missing or extra or bad:
        raise ValueError(
            f"flax variables do not fit the model: missing {missing[:5]}, "
            f"left over {extra[:5]}, shape mismatch {bad[:5]}"
        )
    model.load_state_dict(sd)
    return model


def adam_state_from_optax(mu: Dict[str, Any], nu: Dict[str, Any], count: int,
                          device=None) -> Dict[str, Any]:
    """optax ``ScaleByAdamState`` leaves (numpy trees shaped like ``params``,
    and the count) -> the port's optimizer state, on ``device`` (None = the
    GPU, raising without one, as the training entry points resolve it). The
    moments take the parameters' layout, as the kernels do."""
    from ..models.detector import resolve_device

    device = resolve_device(device)

    def moments(tree):
        return {k: v.to(device) for k, v in from_flax_variables({"params": tree}).items()}

    return {"count": int(count), "mu": moments(mu), "nu": moments(nu)}
