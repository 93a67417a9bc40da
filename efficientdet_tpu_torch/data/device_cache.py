"""A letterboxed dataset resident in the card's memory, gathered by index.

Counterpart of the JAX package's ``data/device_cache.py``. The host letterboxes every image
once, with the same ``letterbox_hostside`` as ``batch_iterator`` (so the
pool's canvases are bit for bit the iterator's), and uploads them as a uint8
pool with their boxes, labels, extents and scales. Each step then gathers
its batch with ``index_select`` on the device: only the indices travel from
the host. Per-epoch randomness comes from the training step's device
augmenter (``TrainConfig.device_augment``), so cached epochs are not literal
repeats. Data echoing (re-using a batch E times, each a new augmented view)
is the training loop's ``--data-echo``.

With ``mesh=`` (parallel/mesh.py) the pool is wrap-padded to a multiple of
the world size and split along the image axis: rank r keeps pool rows
``[r*P, (r+1)*P)`` (P = padded / world), so each card holds 1/N of it.
``get_batch`` takes the global batch's dataset indices and returns this
rank's rows of it (``Mesh.rows``), each fetched from the rank that owns it:
every rank writes the rows it owns into a zeroed batch, one all-reduce per
dtype sums them (parallel/collectives.py), and each keeps its share.
Sampling only ever draws real indices; the wrapped duplicates fill the last
rank's slack.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..models.detector import resolve_device
from ..parallel import collectives
from .common import DetectionDataset, _extent, letterbox_hostside


class DeviceDataCache:
    """``len(dataset)`` (or ``limit``) letterboxed images on ``device``.

    The pool holds ``images`` (N, S, S, 3) uint8, ``gt_boxes`` (N, max_gt, 4)
    float32 in canvas pixels, ``gt_labels`` (N, max_gt) int32 (-1 padding),
    ``extents`` (N, 2) and ``scales`` (N,) float32. It is built in chunks of
    ``upload_chunk`` images, so the host never holds all of it.
    ``device``: None means the GPU (raising without one); with ``mesh`` the
    mesh's device, and the pool is this rank's share (module docstring).
    """

    def __init__(
        self,
        dataset: DetectionDataset,
        target_size: int,
        max_gt: int = 100,
        limit: Optional[int] = None,
        upload_chunk: int = 256,
        device=None,
        mesh=None,
    ):
        n = len(dataset) if limit is None else min(limit, len(dataset))
        if n == 0:
            raise ValueError("empty dataset")
        self.target_size = int(target_size)
        self.max_gt = int(max_gt)
        self.n = n
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self._world, self._rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
        self._per_rank = -(-n // self._world)
        first = self._rank * self._per_rank
        s = self.target_size
        chunks: Dict[str, list] = {k: [] for k in ("images", "gt_boxes", "gt_labels", "extents", "scales")}
        for start in range(first, first + self._per_rank, upload_chunk):
            count = min(upload_chunk, first + self._per_rank - start)
            images = np.zeros((count, s, s, 3), np.uint8)
            gt_boxes = np.zeros((count, max_gt, 4), np.float32)
            gt_labels = np.full((count, max_gt), -1, np.int32)
            extents = np.zeros((count, 2), np.float32)
            scales = np.zeros((count,), np.float32)
            for i in range(count):
                di = (start + i) % n  # wrap-pad
                img = dataset.load_image(di)
                boxes, labels = dataset.load_annotations(di)
                boxes, labels = dataset.filter_annotations(boxes, labels, img.shape[:2])
                images[i], scale = letterbox_hostside(img, s)
                scales[i] = scale
                extents[i] = _extent(img.shape[:2], scale)
                k = min(len(boxes), max_gt)
                if k:
                    gt_boxes[i, :k] = boxes[:k] * scale
                    gt_labels[i, :k] = labels[:k]
            for key, val in (("images", images), ("gt_boxes", gt_boxes), ("gt_labels", gt_labels),
                             ("extents", extents), ("scales", scales)):
                chunks[key].append(torch.from_numpy(val).to(self.device))
        self._pool = {k: torch.cat(v) for k, v in chunks.items()}

    def __len__(self) -> int:
        return self.n

    def local_nbytes(self) -> int:
        """This rank's share of the pool, in bytes on its device."""
        return sum(v.numel() * v.element_size() for v in self._pool.values())

    def nbytes(self) -> int:
        """The whole pool's bytes, over every rank's device."""
        return self.local_nbytes() * self._world

    def get_batch(self, indices) -> Dict[str, torch.Tensor]:
        """The pool's rows at ``indices`` (dataset indices), on the device;
        the host sends only the indices. With a mesh, ``indices`` is the
        global batch and the result this rank's rows of it."""
        idx = np.asarray(indices, np.int64)
        if self._world == 1:
            sel = torch.as_tensor(idx).to(self.device, non_blocking=True)
            return {k: v.index_select(0, sel) for k, v in self._pool.items()}
        own = idx // self._per_rank == self._rank
        slots = torch.as_tensor(np.nonzero(own)[0]).to(self.device)
        rows = torch.as_tensor(idx[own] - self._rank * self._per_rank).to(self.device)
        full = []
        for v in self._pool.values():
            t = v.new_zeros((len(idx),) + v.shape[1:])
            t.index_copy_(0, slots, v.index_select(0, rows))
            full.append(t)
        lo, hi = self.mesh.rows(len(idx))
        summed = collectives.sum_over_ranks(full, self.mesh.group)
        return {k: t[lo:hi] for k, t in zip(self._pool, summed)}

    def batches(
        self,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        repeat: bool = True,
        drop_last: bool = True,
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """Epochs of device batches in ``batch_iterator``'s order: a
        ``RandomState(seed)`` shuffle an epoch, a short last batch dropped
        with ``drop_last`` or else tiled to full size. With a mesh,
        ``batch_size`` is the global batch and each batch this rank's rows."""
        if batch_size > self.n and drop_last:
            raise ValueError(
                f"batch_size {batch_size} > cached images {self.n} with "
                "drop_last=True would yield no batches (use "
                "drop_last=False to wrap-pad)"
            )
        for chunk in cache_order(self.n, batch_size, seed, shuffle, repeat, drop_last):
            yield self.get_batch(chunk)


def cache_order(n: int, batch_size: int, seed: int = 0, shuffle: bool = True,
                repeat: bool = True, drop_last: bool = True) -> Iterator[np.ndarray]:
    """The index batches of ``DeviceDataCache.batches`` (host numpy)."""
    rng = np.random.RandomState(seed)
    while True:
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
        for start in range(0, n, batch_size):
            chunk = order[start:start + batch_size]
            if len(chunk) < batch_size:
                if drop_last or len(chunk) == 0:
                    continue
                reps = -(-batch_size // len(chunk))
                chunk = np.tile(chunk, reps)[:batch_size]
            yield chunk
        if not repeat:
            break
