"""Pascal VOC dataset from its XML files: counterpart of the JAX package's
``data/pascal.py``, with the same difficult flags (images are read inside
``load_image``, so importing this needs neither PIL nor cv2)."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Tuple

import numpy as np

from .common import DetectionDataset
from ..utils.image import read_image_rgb

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class PascalVocDataset(DetectionDataset):
    def __init__(self, data_dir: str, set_name: str = "trainval",
                 skip_difficult: bool = False):
        self.data_dir = data_dir
        self.skip_difficult = skip_difficult
        self.classes = {name: i for i, name in enumerate(VOC_CLASSES)}
        split = os.path.join(data_dir, "ImageSets", "Main", f"{set_name}.txt")
        with open(split) as f:
            self.image_names = [ln.strip() for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.image_names)

    def num_classes(self) -> int:
        return len(VOC_CLASSES)

    def label_to_name(self, label: int) -> str:
        return VOC_CLASSES[label] if 0 <= label < len(VOC_CLASSES) else str(label)

    def load_image(self, index: int) -> np.ndarray:
        path = os.path.join(
            self.data_dir, "JPEGImages", self.image_names[index] + ".jpg"
        )
        return read_image_rgb(path)

    def load_annotations(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        path = os.path.join(
            self.data_dir, "Annotations", self.image_names[index] + ".xml"
        )
        root = ET.parse(path).getroot()
        boxes: List[List[float]] = []
        labels: List[int] = []
        for obj in root.iter("object"):
            name = obj.findtext("name", "").strip()
            if name not in self.classes:
                continue
            difficult = obj.findtext("difficult", "0").strip() == "1"
            if difficult and self.skip_difficult:
                continue
            bb = obj.find("bndbox")
            # VOC is 1-based inclusive.
            x1 = float(bb.findtext("xmin")) - 1
            y1 = float(bb.findtext("ymin")) - 1
            x2 = float(bb.findtext("xmax")) - 1
            y2 = float(bb.findtext("ymax")) - 1
            boxes.append([x1, y1, x2, y2])
            labels.append(self.classes[name])
        if not boxes:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
        return np.asarray(boxes, np.float32), np.asarray(labels, np.int32)
