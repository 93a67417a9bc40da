"""The process group as a mesh: one process per card, ranks along ``data``.

Counterpart of the mesh half of the JAX package's ``parallel/sharding.py``.
JAX runs one process over all its devices and lays them out as a
``(model, data)`` mesh; the port runs one process per card (``torchrun``,
``python -m torch.distributed.run``, ``parallel/launch.py``, or an explicit
``tcp://`` rendezvous) and its :class:`Mesh` is the ``torch.distributed``
process group with the same ``shape`` (``{"model": 1, "data": N}``), this
process's rank and its device.

``make_mesh()`` takes the world from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) when it is
set, from ``init_method``/``world_size``/``rank`` when they are given, and
otherwise gives a world of one process with no process group, where every
collective is the identity. On the GPU the backend is NCCL (``backend=
"gloo"`` on request: NCCL refuses two ranks on one card); on the CPU gloo.
A backend that cannot start, or a rank that does not arrive within
``timeout_s``, raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def split_rows(n: int, parts: int) -> List[Tuple[int, int]]:
    """``n`` rows dealt into ``parts`` contiguous ranges, the first ``n %
    parts`` one row longer (some empty when ``n < parts``)."""
    per, extra = divmod(n, parts)
    starts = [r * per + min(r, extra) for r in range(parts + 1)]
    return list(zip(starts[:-1], starts[1:]))


@dataclasses.dataclass
class Mesh:
    """This process's place in the world: ``rank`` of ``world_size`` along
    ``data``, its ``device``, and the process group the collectives take
    (None in a world of one process that started none)."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[Any] = None
    backend: Optional[str] = None
    owns_group: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return {MODEL_AXIS: 1, DATA_AXIS: self.world_size}

    def rows(self, n: int) -> Tuple[int, int]:
        """This rank's contiguous share of ``n`` rows (``split_rows``)."""
        return split_rows(n, self.world_size)[self.rank]

    def close(self) -> None:
        """Destroy the process group if :func:`make_mesh` started it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.group = None
        self.owns_group = False


def _env_world() -> Optional[Tuple[int, int, int]]:
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
        return rank, int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", rank))
    return None


def make_mesh(
    model_parallelism: int = 1,
    *,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 300.0,
) -> Mesh:
    """The world's mesh, ``{"model": 1, "data": world_size}``.

    ``device``: None means the GPU (raising without one); on the GPU each
    rank calls ``torch.cuda.set_device(local_rank)`` (modulo the cards it
    sees), so ``resolve_device(None)`` is its own card. A process group that
    is already initialised is used as it is.
    """
    from ..models.detector import resolve_device

    if model_parallelism != 1:
        raise NotImplementedError(
            f"model={model_parallelism}: the port has no tensor-parallel layer; "
            "its mesh is data parallel only")
    dev = resolve_device(device)
    env = _env_world()
    if dist.is_available() and dist.is_initialized():
        r, n = dist.get_rank(), dist.get_world_size()
        return Mesh(r, n, _rank_device(dev, env[2] if env else r), dist.group.WORLD,
                    dist.get_backend())
    if init_method is None and env is None:
        if world_size not in (None, 1) or rank not in (None, 0):
            raise ValueError("world_size and rank need an init_method (or the torchrun environment)")
        return Mesh(0, 1, _rank_device(dev, 0))
    if env is not None and init_method is None:
        rank, world_size, local = env
        init_method = "env://"
    else:
        if world_size is None or rank is None:
            raise ValueError("an init_method needs world_size and rank")
        local = env[2] if env else rank
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} not in [0, {world_size})")
    dev = _rank_device(dev, local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return Mesh(rank, world_size, dev, dist.group.WORLD, backend, owns_group=True)


def _rank_device(dev: torch.device, local_rank: int) -> torch.device:
    if dev.type != "cuda":
        return dev
    index = local_rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on the mesh: ``axis`` None is replicated (every
    rank holds all of it), ``DATA_AXIS`` split by rows, each rank its
    :meth:`Mesh.rows` share."""

    mesh: Mesh
    axis: Optional[str] = None

    def rows(self, n: int) -> Tuple[int, int]:
        """The rows of an ``n``-row global tensor this rank holds."""
        return (0, n) if self.axis is None else self.mesh.rows(n)


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def data_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, DATA_AXIS)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This process's LOCAL batch (its rows of the global batch, e.g. from
    ``batch_iterator(shard_index=rank, shard_count=world)``) as tensors on
    the rank's device, as JAX's multi-process ``shard_batch`` takes each
    process's local data: the global batch is the ranks' batches in rank
    order."""
    return {k: torch.as_tensor(v).to(mesh.device, non_blocking=True) for k, v in batch.items()}
