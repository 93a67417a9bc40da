"""CSV dataset: counterpart of the JAX package's ``data/csv_.py``, parsed the same way
and with the same error messages.

Annotations CSV rows: ``path,x1,y1,x2,y2,class_name`` (empty x1..class for a
negative image). Class-map CSV rows: ``class_name,id``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Tuple

import numpy as np

from .common import DetectionDataset
from ..utils.image import read_image_rgb


class CsvDataset(DetectionDataset):
    def __init__(self, csv_data_file: str, csv_class_file: str, base_dir: str | None = None):
        self.base_dir = base_dir or os.path.dirname(csv_data_file)
        self.classes: Dict[str, int] = {}
        with open(csv_class_file, newline="") as f:
            for row in csv.reader(f):
                if not row:
                    continue
                name, cid = row[0], int(row[1])
                if name in self.classes:
                    raise ValueError(f"duplicate class name {name!r}")
                self.classes[name] = cid
        self.labels = {v: k for k, v in self.classes.items()}

        per_image: Dict[str, List[Tuple[float, float, float, float, int]]] = {}
        order: List[str] = []
        with open(csv_data_file, newline="") as f:
            for ln, row in enumerate(csv.reader(f), 1):
                if not row:
                    continue
                path = row[0]
                if path not in per_image:
                    per_image[path] = []
                    order.append(path)
                rest = [c for c in row[1:]]
                if len(rest) < 5 or all(c == "" for c in rest[:5]):
                    continue  # negative image
                x1, y1, x2, y2 = (float(v) for v in rest[:4])
                name = rest[4]
                if name not in self.classes:
                    raise ValueError(f"line {ln}: unknown class {name!r}")
                if x2 <= x1 or y2 <= y1:
                    raise ValueError(f"line {ln}: degenerate box {rest[:4]}")
                per_image[path].append((x1, y1, x2, y2, self.classes[name]))
        self.image_paths = order
        self.annotations = per_image

    def __len__(self) -> int:
        return len(self.image_paths)

    def num_classes(self) -> int:
        return max(self.classes.values()) + 1 if self.classes else 0

    def label_to_name(self, label: int) -> str:
        return self.labels.get(label, str(label))

    def image_path(self, index: int) -> str:
        p = self.image_paths[index]
        return p if os.path.isabs(p) else os.path.join(self.base_dir, p)

    def load_image(self, index: int) -> np.ndarray:
        return read_image_rgb(self.image_path(index))

    def load_annotations(self, index: int):
        anns = self.annotations[self.image_paths[index]]
        if not anns:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
        arr = np.asarray(anns, np.float32)
        return arr[:, :4], arr[:, 4].astype(np.int32)
