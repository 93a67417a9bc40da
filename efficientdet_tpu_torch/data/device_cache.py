"""A letterboxed dataset resident in the card's memory, gathered by index.

Counterpart of the JAX package's ``data/device_cache.py`` on one device (no
mesh: data parallelism is not ported yet). The host letterboxes every image
once, with the same ``letterbox_hostside`` as ``batch_iterator`` (so the
pool's canvases are bit for bit the iterator's), and uploads them as a uint8
pool with their boxes, labels, extents and scales. Each step then gathers
its batch with ``index_select`` on the device: only the indices travel from
the host. Per-epoch randomness comes from the training step's device
augmenter (``TrainConfig.device_augment``), so cached epochs are not literal
repeats. Data echoing (re-using a batch E times, each a new augmented view)
is the training loop's ``--data-echo``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..models.detector import resolve_device
from .common import DetectionDataset, _extent, letterbox_hostside


class DeviceDataCache:
    """``len(dataset)`` (or ``limit``) letterboxed images on ``device``.

    The pool holds ``images`` (N, S, S, 3) uint8, ``gt_boxes`` (N, max_gt, 4)
    float32 in canvas pixels, ``gt_labels`` (N, max_gt) int32 (-1 padding),
    ``extents`` (N, 2) and ``scales`` (N,) float32. It is built in chunks of
    ``upload_chunk`` images, so the host never holds all of it.
    ``device``: None means the GPU (raising without one).
    """

    def __init__(
        self,
        dataset: DetectionDataset,
        target_size: int,
        max_gt: int = 100,
        limit: Optional[int] = None,
        upload_chunk: int = 256,
        device=None,
    ):
        n = len(dataset) if limit is None else min(limit, len(dataset))
        if n == 0:
            raise ValueError("empty dataset")
        self.target_size = int(target_size)
        self.max_gt = int(max_gt)
        self.n = n
        self.device = resolve_device(device)
        s = self.target_size
        chunks: Dict[str, list] = {k: [] for k in ("images", "gt_boxes", "gt_labels", "extents", "scales")}
        for start in range(0, n, upload_chunk):
            count = min(upload_chunk, n - start)
            images = np.zeros((count, s, s, 3), np.uint8)
            gt_boxes = np.zeros((count, max_gt, 4), np.float32)
            gt_labels = np.full((count, max_gt), -1, np.int32)
            extents = np.zeros((count, 2), np.float32)
            scales = np.zeros((count,), np.float32)
            for i in range(count):
                img = dataset.load_image(start + i)
                boxes, labels = dataset.load_annotations(start + i)
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

    def nbytes(self) -> int:
        """The pool's bytes on the device."""
        return sum(v.numel() * v.element_size() for v in self._pool.values())

    def get_batch(self, indices) -> Dict[str, torch.Tensor]:
        """The pool's rows at ``indices`` (dataset indices), on the device;
        the host sends only the indices."""
        idx = torch.as_tensor(np.asarray(indices, np.int64)).to(self.device, non_blocking=True)
        return {k: v.index_select(0, idx) for k, v in self._pool.items()}

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
        with ``drop_last`` or else tiled to full size."""
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
