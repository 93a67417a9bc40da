"""The port's DeviceDataCache against batch_iterator and the JAX package's cache.

On the CPU (``device="cpu"``): the pool equals ``batch_iterator``'s canvases,
boxes, labels, extents and scales bit for bit (the same letterbox); the
``batches`` order equals the JAX ``DeviceDataCache.batches`` index stream
for the same seed exactly; ``drop_last`` raises as JAX does; a short last
batch wrap-pads by tiling.
"""

import numpy as np
import pytest
import torch

from efficientdet_tpu.data.device_cache import DeviceDataCache as JCache
from efficientdet_tpu_torch.data import DetectionDataset, DeviceDataCache, batch_iterator
from efficientdet_tpu_torch.data.device_cache import cache_order


class ArrayDataset(DetectionDataset):
    """Images of several shapes made with numpy, 1-4 boxes each."""

    SHAPES = [(48, 64), (64, 40), (32, 32), (70, 20), (25, 60)]

    def __init__(self, n=11, seed=0):
        rng = np.random.RandomState(seed)
        self.images, self.anns = [], []
        for i in range(n):
            h, w = self.SHAPES[i % len(self.SHAPES)]
            self.images.append(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            k = 1 + i % 4
            xy = rng.uniform(0, [w * 0.6, h * 0.6], (k, 2))
            boxes = np.concatenate([xy, xy + rng.uniform(2, [w * 0.5, h * 0.5], (k, 2))], 1)
            self.anns.append((boxes.astype(np.float32), rng.randint(0, 3, k).astype(np.int32)))

    def __len__(self):
        return len(self.images)

    def load_image(self, index):
        return self.images[index]

    def load_annotations(self, index):
        return self.anns[index]

    def num_classes(self):
        return 3


@pytest.fixture(scope="module")
def cache():
    return DeviceDataCache(ArrayDataset(), target_size=64, max_gt=5, upload_chunk=4, device="cpu")


def test_pool_equals_the_iterators_canvases(cache):
    ds = ArrayDataset()
    (batch,) = list(batch_iterator(ds, len(ds), target_size=64, max_gt=5, shuffle=False))
    got = cache.get_batch(np.arange(len(ds)))
    for k in ("images", "gt_boxes", "gt_labels", "extents", "scales"):
        np.testing.assert_array_equal(got[k].numpy(), batch[k], err_msg=k)
        assert got[k].dtype == torch.from_numpy(batch[k]).dtype, k
    assert len(cache) == 11 and cache.nbytes() == 11 * (64 * 64 * 3 + 5 * 4 * 4 + 5 * 4 + 2 * 4 + 4)
    order = np.array([3, 3, 10, 0])
    np.testing.assert_array_equal(cache.get_batch(order)["images"].numpy(), batch["images"][order])


def test_limit_caches_a_window():
    small = DeviceDataCache(ArrayDataset(), target_size=32, max_gt=5, limit=4, device="cpu")
    assert len(small) == 4 and small.get_batch([3])["images"].shape == (1, 32, 32, 3)


@pytest.mark.parametrize("batch_size, shuffle, drop_last", [(4, True, True), (4, True, False),
                                                            (3, False, False), (11, True, False)])
def test_batches_order_matches_jax(cache, monkeypatch, batch_size, shuffle, drop_last):
    # JAX's cache over the same dataset, its gather replaced by the indices
    monkeypatch.setattr(JCache, "get_batch", lambda self, idx: np.asarray(idx))
    jcache = JCache(ArrayDataset(), target_size=32, max_gt=5)
    jit = jcache.batches(batch_size, seed=7, shuffle=shuffle, drop_last=drop_last)
    pit = cache_order(len(cache), batch_size, seed=7, shuffle=shuffle, drop_last=drop_last)
    per_epoch = len(cache) // batch_size + (0 if drop_last or len(cache) % batch_size == 0 else 1)
    for _ in range(2 * per_epoch + 1):
        np.testing.assert_array_equal(next(pit), next(jit))
    # the device batches follow that order
    want = list(cache_order(len(cache), batch_size, seed=7, shuffle=shuffle, repeat=False, drop_last=drop_last))
    got = list(cache.batches(batch_size, seed=7, shuffle=shuffle, repeat=False, drop_last=drop_last))
    assert len(got) == len(want) == per_epoch
    for g, idx in zip(got, want):
        np.testing.assert_array_equal(g["scales"].numpy(), cache.get_batch(idx)["scales"].numpy())
        np.testing.assert_array_equal(g["images"].numpy(), cache.get_batch(idx)["images"].numpy())


def test_drop_last_raises_and_wrap_pad(cache):
    with pytest.raises(ValueError, match="batch_size 12 > cached images 11 with drop_last=True"):
        next(cache.batches(12))
    (only,) = list(cache_order(len(cache), 8, shuffle=False, repeat=False, drop_last=True))
    assert only.tolist() == list(range(8))
    batches = list(cache_order(len(cache), 8, shuffle=False, repeat=False, drop_last=False))
    assert [b.tolist() for b in batches] == [list(range(8)), [8, 9, 10, 8, 9, 10, 8, 9]]
    (tiled,) = list(cache_order(3, 8, shuffle=False, repeat=False, drop_last=False))
    assert tiled.tolist() == [0, 1, 2, 0, 1, 2, 0, 1]


def test_empty_and_device():
    with pytest.raises(ValueError, match="empty dataset"):
        DeviceDataCache(ArrayDataset(n=0), 32, device="cpu")
