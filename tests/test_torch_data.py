"""The port's dataset readers and batch pipeline against the JAX package's.

Synthetic files in tmp_path (PNG/JPEG written with PIL, CSV, COCO JSON, VOC
XML). Readers: boxes, labels, names, image ids and category maps exactly
equal. ``batch_iterator``: the index streams exactly equal (shuffle,
aspect grouping, shards, wrap-pad, drop_last, worker seeds), ``gt_boxes``,
``gt_labels``, ``scales`` and ``extents`` exactly equal, and the images
within one grey level (the port letterboxes with torch, JAX with cv2;
PERF.md and ROADMAP record that tolerance). With the host augmenter, the
same per-image draws: boxes within 1e-4 px, labels exact, the images within
the warp's recorded tolerance (tests/test_torch_augment.py).
"""

import json

import numpy as np
import pytest
from PIL import Image

from efficientdet_tpu.data import CocoDataset as JCoco
from efficientdet_tpu.data import CsvDataset as JCsv
from efficientdet_tpu.data import PascalVocDataset as JVoc
from efficientdet_tpu.data.augment import make_augmenter as j_make_augmenter
from efficientdet_tpu.data.common import batch_iterator as j_batch_iterator
from efficientdet_tpu_torch.data import CocoDataset, CsvDataset, PascalVocDataset, batch_iterator, prefetch
from efficientdet_tpu_torch.data.augment import make_augmenter

SIZES = [(120, 80), (60, 100), (90, 90), (200, 64), (33, 47), (150, 151), (64, 128), (101, 77),
         (80, 120), (45, 45), (128, 96)]  # (w, h)


@pytest.fixture(scope="module")
def csv_files(tmp_path_factory):
    """Eleven PNG images of noise with two to four boxes each (some crossing
    the border, one degenerate after the clip, one image with none)."""
    root = tmp_path_factory.mktemp("csv")
    rng = np.random.RandomState(0)
    rows = []
    for i, (w, h) in enumerate(SIZES):
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(root / f"img{i}.png")
        if i == 4:
            rows.append(f"img{i}.png,,,,,")
            continue
        for k in range(2 + i % 3):
            x1, y1 = rng.uniform(-5, w * 0.6), rng.uniform(-5, h * 0.6)
            x2, y2 = x1 + rng.uniform(3, w * 0.6), y1 + rng.uniform(3, h * 0.6)
            rows.append(f"img{i}.png,{x1:.2f},{y1:.2f},{x2:.2f},{y2:.2f},{('thing', 'widget', 'gadget')[k % 3]}")
    rows.append(f"img0.png,{SIZES[0][0] + 1},10,{SIZES[0][0] + 9},20,thing")  # gone after the clip
    (root / "annots.csv").write_text("\n".join(rows) + "\n")
    (root / "classes.csv").write_text("thing,0\nwidget,1\ngadget,2\n")
    return str(root / "annots.csv"), str(root / "classes.csv")


@pytest.fixture(scope="module")
def pair(csv_files):
    return JCsv(*csv_files), CsvDataset(*csv_files)


def _same_annotations(j, p, n, **kw):
    for i in range(n):
        jb, jl = j.load_annotations(i, **kw)
        pb, pl = p.load_annotations(i, **kw)
        np.testing.assert_array_equal(pb, jb)
        np.testing.assert_array_equal(pl, jl)
        assert pb.dtype == jb.dtype and pl.dtype == jl.dtype
        assert p.image_id(i) == j.image_id(i)
        np.testing.assert_array_equal(p.load_image(i), j.load_image(i))


def test_csv_reader_matches_jax(pair):
    j, p = pair
    assert len(p) == len(j) == len(SIZES)
    assert p.num_classes() == j.num_classes() == 3
    assert p.classes == j.classes and p.labels == j.labels
    assert [p.label_to_name(k) for k in range(-1, 4)] == [j.label_to_name(k) for k in range(-1, 4)]
    assert [p.image_path(i) for i in range(len(p))] == [j.image_path(i) for i in range(len(j))]
    _same_annotations(j, p, len(p))


@pytest.mark.parametrize("text, message", [
    ("x.png,1,1,5,5,nope\n", "unknown class"),
    ("x.png,5,1,5,5,thing\n", "degenerate box"),
])
def test_csv_errors_match_jax(tmp_path, text, message):
    (tmp_path / "a.csv").write_text(text)
    (tmp_path / "c.csv").write_text("thing,0\n")
    msgs = []
    for cls in (JCsv, CsvDataset):
        with pytest.raises(ValueError, match=message) as err:
            cls(str(tmp_path / "a.csv"), str(tmp_path / "c.csv"))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    (tmp_path / "c.csv").write_text("thing,0\nthing,1\n")
    for cls in (JCsv, CsvDataset):
        with pytest.raises(ValueError, match="duplicate class name 'thing'"):
            cls(str(tmp_path / "a.csv"), str(tmp_path / "c.csv"))


@pytest.fixture
def coco_dir(tmp_path):
    """Three images, non-contiguous category ids, a crowd box, a box under
    one pixel wide, and an image without annotations."""
    (tmp_path / "val2017").mkdir()
    (tmp_path / "annotations").mkdir()
    images = []
    for i, (w, h) in enumerate([(64, 48), (32, 32), (40, 56)], start=1):
        Image.fromarray(np.full((h, w, 3), 9 * i, np.uint8)).save(tmp_path / "val2017" / f"{i:012d}.jpg")
        images.append({"id": 10 * i, "width": w, "height": h, "file_name": f"{i:012d}.jpg"})
    cats = [{"id": 17, "name": "cat"}, {"id": 3, "name": "car"}, {"id": 44, "name": "bottle"}]
    anns = [
        {"id": 1, "image_id": 10, "category_id": 17, "bbox": [5, 5, 20, 20], "area": 400, "iscrowd": 0},
        {"id": 2, "image_id": 10, "category_id": 3, "bbox": [1, 1, 10, 10], "area": 100, "iscrowd": 1},
        {"id": 3, "image_id": 10, "category_id": 44, "bbox": [30, 2, 0.5, 9], "area": 4.5},
        {"id": 4, "image_id": 20, "category_id": 44, "bbox": [2.5, 3.25, 11, 7], "area": 77},
    ]
    with open(tmp_path / "annotations" / "instances_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return str(tmp_path)


def test_coco_reader_matches_jax(coco_dir):
    j, p = JCoco(coco_dir, "val2017"), CocoDataset(coco_dir, "val2017")
    assert len(p) == len(j) == 3 and p.num_classes() == j.num_classes() == 3
    assert p.cat_ids == j.cat_ids == [3, 17, 44]
    assert p.label_to_coco_label == j.label_to_coco_label
    assert p.coco_label_to_label == j.coco_label_to_label
    assert p.image_ids == j.image_ids == [10, 20, 30]
    assert [p.label_to_name(k) for k in range(-1, 4)] == [j.label_to_name(k) for k in range(-1, 4)]
    assert [p.image_aspect_ratio(i) for i in range(3)] == [j.image_aspect_ratio(i) for i in range(3)]
    assert p.coco.dataset == j.coco.dataset and p.coco.img_to_anns == j.coco.img_to_anns
    _same_annotations(j, p, 3)
    _same_annotations(j, p, 3, include_crowd=True)


@pytest.fixture
def voc_dir(tmp_path):
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (tmp_path / d).mkdir(parents=True)
    for name, (w, h) in (("000001", (60, 40)), ("000002", (30, 50))):
        Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(tmp_path / "JPEGImages" / f"{name}.jpg")
    (tmp_path / "Annotations" / "000001.xml").write_text(
        """<annotation><object><name>dog</name><difficult>0</difficult>
        <bndbox><xmin>11</xmin><ymin>12</ymin><xmax>31</xmax><ymax>32</ymax></bndbox></object>
        <object><name>person</name><difficult>1</difficult>
        <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>5</xmax><ymax>5</ymax></bndbox></object>
        <object><name>unicorn</name><bndbox><xmin>1</xmin><ymin>1</ymin><xmax>5</xmax><ymax>5</ymax>
        </bndbox></object></annotation>""")
    (tmp_path / "Annotations" / "000002.xml").write_text("<annotation></annotation>")
    (tmp_path / "ImageSets" / "Main" / "trainval.txt").write_text("000001\n000002\n\n")
    return str(tmp_path)


@pytest.mark.parametrize("skip_difficult", [False, True])
def test_voc_reader_matches_jax(voc_dir, skip_difficult):
    j = JVoc(voc_dir, "trainval", skip_difficult=skip_difficult)
    p = PascalVocDataset(voc_dir, "trainval", skip_difficult=skip_difficult)
    assert p.image_names == j.image_names and p.num_classes() == j.num_classes() == 20
    assert [p.label_to_name(k) for k in (-1, 0, 11, 19, 20)] == [j.label_to_name(k) for k in (-1, 0, 11, 19, 20)]
    _same_annotations(j, p, 2)
    assert len(p.load_annotations(0)[0]) == (1 if skip_difficult else 2)


def _both(pair, epochs_of, **kw):
    """The first ``epochs_of`` batches of both iterators."""
    j, p = pair
    jit = j_batch_iterator(j, **kw)
    pit = batch_iterator(p, **kw)
    return [next(jit) for _ in range(epochs_of)], [next(pit) for _ in range(epochs_of)]


# (keyword arguments, batches taken: two epochs' worth where the stream repeats)
CONFIGS = {
    "shuffle_drop_last": (dict(shuffle=True, repeat=True, drop_last=True, seed=3), 6),
    "shuffle_wrap_pad": (dict(shuffle=True, repeat=True, drop_last=False, seed=4), 6),
    "group_by_aspect": (dict(shuffle=True, repeat=True, group_by_aspect=True, drop_last=False, seed=5), 6),
    "shard0_of_2": (dict(shuffle=True, repeat=True, shard_index=0, shard_count=2, drop_last=False, seed=6), 4),
    "shard1_of_2_aspect": (dict(shuffle=True, repeat=True, shard_index=1, shard_count=2,
                                group_by_aspect=True, drop_last=False, seed=7), 4),
    "workers2": (dict(shuffle=True, repeat=True, workers=2, drop_last=False, seed=8), 6),
    "no_shuffle_once": (dict(shuffle=False, repeat=False, drop_last=False), 3),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batch_iterator_matches_jax(pair, name):
    kw, count = CONFIGS[name]
    jb, pb = _both(pair, count, batch_size=4, target_size=64, max_gt=5, **kw)
    for j, p in zip(jb, pb):
        assert p.keys() == j.keys()
        for k in ("indices", "gt_boxes", "gt_labels", "scales", "extents"):
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
            assert p[k].dtype == j[k].dtype, k
        assert p["images"].dtype == np.uint8 and p["images"].shape == j["images"].shape
        assert np.abs(p["images"].astype(int) - j["images"]).max() <= 1


@pytest.mark.parametrize("workers", [0, 2])
def test_batch_iterator_with_the_augmenter_matches_jax(pair, workers):
    """The fused warp + letterbox from the same draws: the per-image seeds
    (workers > 0) or the shared stream (workers 0)."""
    j, p = pair
    kw = dict(batch_size=4, target_size=64, max_gt=5, shuffle=True, repeat=True, seed=9,
              drop_last=False, workers=workers)
    jit = j_batch_iterator(j, augment=j_make_augmenter(), **kw)
    pit = batch_iterator(p, augment=make_augmenter(), **kw)
    for _ in range(4):
        jb, pb = next(jit), next(pit)
        for k in ("indices", "gt_labels", "scales", "extents"):
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        np.testing.assert_allclose(pb["gt_boxes"], jb["gt_boxes"], rtol=0, atol=1e-4)
        diff = np.abs(pb["images"].astype(int) - jb["images"])
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_repeat_with_drop_last_raises_as_jax(pair):
    j, p = pair
    for fn, ds in ((j_batch_iterator, j), (batch_iterator, p)):
        with pytest.raises(ValueError, match="repeat loop would spin forever") as err:
            next(fn(ds, 8, 32, repeat=True, drop_last=True, shard_count=2))
        assert "per-shard dataset size 5" in str(err.value)
        with pytest.raises(ValueError, match=r"shard_index 2 not in \[0, 2\)"):
            next(fn(ds, 2, 32, shard_index=2, shard_count=2))


def test_wrap_pad_tiles_the_last_batch(pair):
    _, p = pair
    batches = list(batch_iterator(p, 8, 32, shuffle=False, drop_last=False))
    assert [b["indices"].tolist() for b in batches] == [list(range(8)), [8, 9, 10, 8, 9, 10, 8, 9]]


def test_prefetch_keeps_the_order(pair):
    _, p = pair
    direct = list(batch_iterator(p, 3, 32, shuffle=True, seed=1, drop_last=False))
    fetched = list(prefetch(batch_iterator(p, 3, 32, shuffle=True, seed=1, drop_last=False), size=2))
    assert len(direct) == len(fetched) == 4
    for a, b in zip(direct, fetched):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_raises_the_workers_error():
    def stream():
        yield 1
        yield 2
        raise OSError("corrupt image")

    got = []
    with pytest.raises(OSError, match="corrupt image"):
        for item in prefetch(stream(), size=1):
            got.append(item)
    assert got == [1, 2]
