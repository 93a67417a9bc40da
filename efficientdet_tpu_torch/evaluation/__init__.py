"""Evaluation: COCO AP (numpy, no pycocotools) and VOC-style mAP."""

from .coco_eval import CocoEvaluator, collect_detections, evaluate_coco, make_batch_predict_fn
from .voc import evaluate_voc, mean_ap
