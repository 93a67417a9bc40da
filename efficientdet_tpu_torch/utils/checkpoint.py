"""Checkpoints in the port's own format: params-only files and training snapshots.

Counterpart of the JAX package's ``utils/checkpoint.py`` (orbax there).
Everything is written by ``torch.save`` with its tensors on the CPU and read
back with ``torch.load(weights_only=True)`` (tensors, numbers and dicts only,
no pickled code).

* ``save_params`` / ``load_params``: one model ``state_dict``, loaded
  strictly (a missing, left-over or misshapen key raises).
* :class:`CheckpointManager`: one directory per step, ``<dir>/<step>/``,
  holding ``params.pt`` (the state's ``params`` and ``batch_stats``),
  ``train.pt`` (``step``, ``opt_state``, ``ema_params``, ``lr_scale``) and
  ``metrics.json``. A snapshot is written to a temporary directory and
  renamed into place.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """Write a state dict (its tensors moved to the CPU) to ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path)


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the state dict at ``path`` into ``model``, strictly; returns ``model``."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _copy_into(dst: Any, src: Any, path: str) -> Any:
    """``src``'s values in ``dst``'s tensors (same keys and shapes, on
    ``dst``'s device); numbers and None are taken from ``src``."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape:
            raise ValueError(f"checkpoint {path}: expected a tensor of shape {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if not isinstance(src, dict) or src.keys() != dst.keys():
            missing = sorted(set(dst) - set(src)) if isinstance(src, dict) else "all"
            raise ValueError(f"checkpoint {path}: keys differ from the template's (missing {missing})")
        return {k: _copy_into(dst[k], src[k], f"{path}/{k}") for k in dst}
    if dst is None and src is not None:
        raise ValueError(f"checkpoint {path}: the template has no place for it")
    return src


class CheckpointManager:
    """Training snapshots under ``directory``, one subdirectory a step.

    ``keep``: how many snapshots stay, the newest; with ``best_only`` the
    ``keep`` with the highest ``metrics["mAP"]`` (0 without one; the newer
    of equals). The JAX package's retry for snapshots written before
    ``TrainState`` had ``lr_scale`` is orbax's: every snapshot of the port
    has the field, so there is no such retry here.
    """

    def __init__(self, directory: str, keep: int = 3, best_only: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.best_only = best_only

    def all_steps(self) -> List[int]:
        return sorted(int(s) for s in os.listdir(self.directory)
                      if s.isdigit() and os.path.isfile(os.path.join(self.directory, s, "train.pt")))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Dict[str, float]:
        with open(os.path.join(self.directory, str(step), "metrics.json")) as f:
            return json.load(f)

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> None:
        """Write ``state`` (a ``train_lib.TrainState``) as snapshot ``step``,
        then drop what ``keep`` and ``best_only`` do not keep."""
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".tmp-{int(step)}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"params": _to_cpu(state.params), "batch_stats": _to_cpu(state.batch_stats)},
                   os.path.join(tmp, "params.pt"))
        torch.save({"step": int(state.step), "opt_state": _to_cpu(state.opt_state),
                    "ema_params": _to_cpu(state.ema_params), "lr_scale": float(state.lr_scale)},
                   os.path.join(tmp, "train.pt"))
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        if self.best_only:
            steps.sort(key=lambda s: (self.metrics(s).get("mAP", 0.0), s))
        for s in steps[:max(len(steps) - self.keep, 0)]:
            shutil.rmtree(os.path.join(self.directory, str(s)))

    def _step(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return step

    def _load(self, step: int, name: str) -> Dict[str, Any]:
        path = os.path.join(self.directory, str(step), name)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint {path}")
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Snapshot ``step`` (the latest when None) in ``state_template``'s
        tensors, copied in place (a state made by ``create_train_state``
        restores into its model); returns the state with the snapshot's
        step, optimizer counts and ``lr_scale``."""
        step = self._step(step)
        tensors = self._load(step, "params.pt")
        train = self._load(step, "train.pt")
        return state_template.replace(
            step=train["step"],
            params=_copy_into(state_template.params, tensors["params"], "params"),
            batch_stats=_copy_into(state_template.batch_stats, tensors["batch_stats"], "batch_stats"),
            opt_state=_copy_into(state_template.opt_state, train["opt_state"], "opt_state"),
            ema_params=_copy_into(state_template.ema_params, train["ema_params"], "ema_params"),
            lr_scale=train["lr_scale"],
        )

    def restore_partial(self, sub_template: Optional[Dict[str, Any]] = None,
                        step: Optional[int] = None) -> Dict[str, Any]:
        """``{"params": ..., "batch_stats": ...}`` of snapshot ``step`` (the
        latest when None), without the optimizer's state: on the CPU, or
        copied into ``sub_template``'s tensors."""
        tensors = self._load(self._step(step), "params.pt")
        if sub_template is None:
            return tensors
        return {k: _copy_into(sub_template[k], tensors[k], k) for k in sub_template}
