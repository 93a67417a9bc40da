"""Datasets and the input pipeline: COCO, Pascal VOC and CSV readers, the
host batch pipeline, host augmentation and the device-resident cache."""

from .common import DetectionDataset, batch_iterator, letterbox_hostside, prefetch
from .device_cache import DeviceDataCache
from .csv_ import CsvDataset
from .coco import CocoDataset
from .pascal import PascalVocDataset
