"""Params-only checkpoints in the port's own format.

Counterpart of ``save_params`` / ``load_params`` in the JAX package's
``utils/checkpoint.py`` (orbax there). Here a checkpoint is a model's
``state_dict`` written by ``torch.save``, read back with
``torch.load(weights_only=True)`` (tensors only, no pickled code) and loaded
strictly: a missing, left-over or misshapen key raises. Training snapshots
(``CheckpointManager``) wait for the training slice.
"""

from __future__ import annotations

import os
from typing import Dict

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
