"""Datasets and the host batch pipeline: the dataset base class,
``letterbox_hostside``, ``batch_iterator`` and ``prefetch``.

Counterpart of the JAX package's ``data/common.py``, with the same batches
for the same seed: the epoch order, the aspect grouping, the shards, the
wrap-pad of a short last batch and the per-image seeds of ``workers > 0``
are the same ``numpy.random.RandomState`` draws in the same order. The host
reads files, augments (optionally) and letterboxes into fixed-shape uint8
batches; normalisation and anchor matching run inside the training step on
the device.

The JAX version letterboxes with ``cv2.resize(INTER_LINEAR)``; the machine
that runs the port on the card need not have cv2 or PIL, so this one
resizes with torch on CPU tensors: bilinear with half-pixel centres and no
antialiasing, as INTER_LINEAR. It agrees with cv2 to one grey level (both
sum in fixed point, with other weights' precision).
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class DetectionDataset(abc.ABC):
    """Abstract dataset: images and xyxy box annotations with integer labels."""

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    @abc.abstractmethod
    def load_image(self, index: int) -> np.ndarray:
        """(H, W, 3) RGB uint8."""

    @abc.abstractmethod
    def load_annotations(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """((N, 4) float32 xyxy, (N,) int32 labels)."""

    @abc.abstractmethod
    def num_classes(self) -> int:
        ...

    def label_to_name(self, label: int) -> str:
        return str(label)

    def image_id(self, index: int) -> int:
        """Stable id for evaluation (the COCO image id where there is one)."""
        return index

    def image_aspect_ratio(self, index: int) -> float:
        img = self.load_image(index)
        h, w = img.shape[:2]
        return w / h

    def filter_annotations(
        self, boxes: np.ndarray, labels: np.ndarray, hw: Tuple[int, int]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Clip to the image and drop degenerate boxes."""
        h, w = hw
        if len(boxes) == 0:
            return boxes.reshape(0, 4).astype(np.float32), labels.astype(np.int32)
        boxes = boxes.astype(np.float32).copy()
        boxes[:, 0] = np.clip(boxes[:, 0], 0, w - 1)
        boxes[:, 1] = np.clip(boxes[:, 1], 0, h - 1)
        boxes[:, 2] = np.clip(boxes[:, 2], 0, w - 1)
        boxes[:, 3] = np.clip(boxes[:, 3], 0, h - 1)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        return boxes[keep], labels[keep].astype(np.int32)


def letterbox_hostside(image: np.ndarray, target_size: int) -> Tuple[np.ndarray, float]:
    """(H, W, 3) RGB uint8 -> a (target_size, target_size, 3) uint8 canvas, and the scale.

    The long side is resized to ``target_size`` (the short one to
    round(side * scale)); the bottom and right are zero padded. Batches of
    these canvases have one shape whatever the source shapes.
    """
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise TypeError(f"expected an (H, W, 3) uint8 image, got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    scale = target_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if not image.flags.writeable:  # a decoded request; torch.from_numpy wants writable
        image = image.copy()
    # torch's uint8 bilinear sums in fixed point, as cv2 does, on the
    # channels-last view (no copy in or out): a third of the time of float
    # planes on one core
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    resized = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    canvas = np.zeros((target_size, target_size, 3), np.uint8)
    canvas[:nh, :nw] = resized[0].permute(1, 2, 0).numpy()
    return canvas, scale


def _extent(hw: Tuple[int, int], scale: float) -> Tuple[int, int]:
    """(scaled_h, scaled_w): the visible image inside a letterboxed canvas."""
    return int(round(hw[0] * scale)), int(round(hw[1] * scale))


def batch_iterator(
    dataset: DetectionDataset,
    batch_size: int,
    target_size: int,
    max_gt: int = 100,
    shuffle: bool = True,
    repeat: bool = False,
    augment: Optional[Callable] = None,
    seed: int = 0,
    group_by_aspect: bool = False,
    drop_last: bool = True,
    workers: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape batches of numpy arrays.

    Each batch has ``images`` (B, S, S, 3) uint8 letterboxed canvases
    (normalised on the device), ``gt_boxes`` (B, max_gt, 4) float32 in
    canvas pixels, ``gt_labels`` (B, max_gt) int32 with -1 padding,
    ``scales`` (B,) the letterbox scales, ``extents`` (B, 2) the visible
    (scaled_h, scaled_w) of each canvas, and ``indices`` (B,) int32 dataset
    indices.

    ``workers > 0`` loads, augments and letterboxes a batch's images in a
    thread pool; the augmenter then draws from per-image seeds (drawn from
    the iterator's RandomState) instead of the one shared stream, so its
    pixels differ from ``workers=0`` but stay fixed by the seed.
    ``shard_count > 1`` gives process ``shard_index`` its strided share of
    each epoch's order (equal lengths on every process; with
    ``group_by_aspect`` whole batches are dealt). A final batch shorter than
    ``batch_size`` is dropped with ``drop_last``, else tiled to full size.
    """
    if batch_size > len(dataset) // shard_count and drop_last and repeat:
        raise ValueError(
            f"batch_size {batch_size} > per-shard dataset size "
            f"{len(dataset) // shard_count} with drop_last=True: the "
            "repeat loop would spin forever yielding nothing (use "
            "drop_last=False to wrap-pad small datasets)"
        )
    if not (0 <= shard_index < shard_count):
        raise ValueError(f"shard_index {shard_index} not in [0, {shard_count})")
    rng = np.random.RandomState(seed)
    n = len(dataset)
    pool = None
    if workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=workers)

    # the sorted base order is fixed by the dataset: computed once
    aspect_base_order = None
    if group_by_aspect:
        ratios = np.asarray([dataset.image_aspect_ratio(i) for i in range(n)])
        aspect_base_order = np.argsort(ratios, kind="stable")

    def shard_evenly(arr):
        # trimmed to a multiple of shard_count, so every process yields the
        # same number of batches
        usable = (len(arr) // shard_count) * shard_count
        return arr[:usable][shard_index::shard_count]

    def order():
        idx = np.arange(n)
        if group_by_aspect:
            idx = aspect_base_order.copy()
        if shuffle:
            if group_by_aspect:
                # shuffle whole batches to keep the aspect groups
                nb = len(idx) // batch_size
                groups = idx[: nb * batch_size].reshape(nb, batch_size)
                rng.shuffle(groups)
                idx = np.concatenate([groups.reshape(-1), idx[nb * batch_size:]])
            else:
                rng.shuffle(idx)
        if shard_count > 1:
            if group_by_aspect:
                nb = len(idx) // batch_size
                groups = idx[: nb * batch_size].reshape(nb, batch_size)
                tail = idx[nb * batch_size:]
                idx = np.concatenate([shard_evenly(groups).reshape(-1), shard_evenly(tail)])
            else:
                idx = shard_evenly(idx)
        return idx

    try:
        while True:
            idx = order()
            for start in range(0, len(idx), batch_size):
                chunk = idx[start: start + batch_size]
                if len(chunk) < batch_size:
                    if drop_last or len(chunk) == 0:
                        continue
                    reps = -(-batch_size // len(chunk))
                    chunk = np.tile(chunk, reps)[:batch_size]
                images = np.zeros((batch_size, target_size, target_size, 3), np.uint8)
                gt_boxes = np.zeros((batch_size, max_gt, 4), np.float32)
                gt_labels = np.full((batch_size, max_gt), -1, np.int32)
                scales = np.zeros((batch_size,), np.float32)
                extents = np.zeros((batch_size, 2), np.float32)

                def load_one(bi, di, aug_seed):
                    img = dataset.load_image(int(di))
                    boxes, labels = dataset.load_annotations(int(di))
                    boxes, labels = dataset.filter_annotations(boxes, labels, img.shape[:2])
                    box_scale = None
                    if augment is not None:
                        aug_rng = rng if aug_seed is None else np.random.RandomState(aug_seed)
                        if getattr(augment, "supports_fused_letterbox", False):
                            # one warp straight into the canvas; the boxes
                            # come back in canvas pixels, clipped to the
                            # visible image, not the padded canvas
                            canvas, boxes, scale = augment(aug_rng, img, boxes, target_size=target_size)
                            extent = _extent(img.shape[:2], scale)
                            boxes, labels = dataset.filter_annotations(boxes, labels, extent)
                            box_scale = 1.0
                        else:
                            img, boxes = augment(aug_rng, img, boxes)
                            boxes, labels = dataset.filter_annotations(boxes, labels, img.shape[:2])
                    if box_scale is None:
                        canvas, scale = letterbox_hostside(img, target_size)
                        extent = _extent(img.shape[:2], scale)
                        box_scale = scale
                    images[bi] = canvas
                    scales[bi] = scale
                    extents[bi] = extent
                    k = min(len(boxes), max_gt)
                    if k:
                        gt_boxes[bi, :k] = boxes[:k] * box_scale
                        gt_labels[bi, :k] = labels[:k]

                if pool is not None:
                    seeds = rng.randint(0, 2**31 - 1, size=len(chunk))
                    list(pool.map(load_one, range(len(chunk)), chunk, seeds))
                else:
                    for bi, di in enumerate(chunk):
                        load_one(bi, di, None)
                yield {
                    "images": images,
                    "gt_boxes": gt_boxes,
                    "gt_labels": gt_labels,
                    "scales": scales,
                    "extents": extents,
                    "indices": chunk.astype(np.int32),
                }
            if not repeat:
                break
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread, ``size`` items ahead.

    An exception in the worker is raised again in the consumer (a bad file
    mid-epoch must stop the run, not end the stream early).
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()

    class _Raise:
        def __init__(self, exc):
            self.exc = exc

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
            q.put(_Raise(e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            break
        if isinstance(item, _Raise):
            raise item.exc
        yield item
