"""COCO dataset from the annotation JSON: counterpart of the JAX package's
``data/coco.py``, with the same label map, image ids and crowd handling.

No pycocotools: the JSON is read directly. The 80 (non-contiguous-id) categories map to contiguous labels
0..79 sorted by category id; ``iscrowd`` annotations are kept and flagged so
evaluation can ignore them; boxes convert xywh -> xyxy.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from .common import DetectionDataset
from ..utils.image import read_image_rgb


class CocoIndex:
    """Minimal pycocotools.COCO equivalent over an annotation JSON."""

    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {i: [] for i in self.imgs}
        for ann in data.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    @property
    def cat_ids_sorted(self) -> List[int]:
        return sorted(self.cats)


class CocoDataset(DetectionDataset):
    def __init__(self, data_dir: str, set_name: str = "val2017",
                 annotation_file: str | None = None):
        self.data_dir = data_dir
        self.set_name = set_name
        ann = annotation_file or os.path.join(
            data_dir, "annotations", f"instances_{set_name}.json"
        )
        self.coco = CocoIndex(ann)
        self.image_ids = sorted(self.coco.imgs)
        # contiguous label <-> coco category id (sorted by id, as reference).
        self.cat_ids = self.coco.cat_ids_sorted
        self.coco_label_to_label = {c: i for i, c in enumerate(self.cat_ids)}
        self.label_to_coco_label = {i: c for i, c in enumerate(self.cat_ids)}

    def __len__(self) -> int:
        return len(self.image_ids)

    def num_classes(self) -> int:
        return len(self.cat_ids)

    def label_to_name(self, label: int) -> str:
        cid = self.label_to_coco_label.get(label)
        return self.coco.cats[cid]["name"] if cid in self.coco.cats else str(label)

    def image_id(self, index: int) -> int:
        return self.image_ids[index]

    def image_info(self, index: int) -> dict:
        return self.coco.imgs[self.image_ids[index]]

    def image_aspect_ratio(self, index: int) -> float:
        info = self.image_info(index)
        return info["width"] / info["height"]

    def load_image(self, index: int) -> np.ndarray:
        info = self.image_info(index)
        path = os.path.join(self.data_dir, self.set_name, info["file_name"])
        return read_image_rgb(path)

    def load_annotations(self, index: int, include_crowd: bool = False):
        anns = self.coco.img_to_anns.get(self.image_ids[index], [])
        boxes, labels = [], []
        for a in anns:
            if a.get("iscrowd", 0) and not include_crowd:
                continue
            x, y, w, h = a["bbox"]
            if w < 1 or h < 1:
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(self.coco_label_to_label[a["category_id"]])
        if not boxes:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
        return np.asarray(boxes, np.float32), np.asarray(labels, np.int32)
