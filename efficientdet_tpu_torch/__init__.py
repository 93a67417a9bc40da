"""EfficientDet in PyTorch for NVIDIA Hopper: a port of ``efficientdet_tpu``.

The JAX package beside this one is the reference; this package imports none
of it and no JAX. Its kernels (``csrc/``) are CUDA C++ for sm_90a, built with
nvcc at first use; on CPU tensors their plain PyTorch versions run instead.
``parallel`` trains and predicts over several processes, one a card
(``torch.distributed``), by batch or by image height.
"""

from .configs import AnchorConfig, BlockConfig, EvalConfig, ModelConfig, TrainConfig
from .data import (
    CocoDataset,
    CsvDataset,
    DetectionDataset,
    DeviceDataCache,
    PascalVocDataset,
    batch_iterator,
)
from .evaluation import CocoEvaluator, evaluate_coco, evaluate_voc
from .export import load_exported, save_exported
from .anchors import (
    anchor_targets,
    anchor_targets_batch,
    anchor_targets_batch_compact,
    anchor_targets_compact,
    anchors_for_shape,
    clip_boxes,
    decode_boxes,
    encode_boxes,
    iou_matrix,
)
from .losses import detection_loss, focal_loss, smooth_l1_loss
from .models.detector import (
    EfficientDet,
    build_efficientdet,
    efficientdet_d0,
    efficientdet_d1,
    efficientdet_d2,
    efficientdet_d3,
    efficientdet_d4,
    efficientdet_d5,
    efficientdet_d6,
    efficientdet_d7,
    efficientdet_d7x,
    fuse_for_inference,
    make_predict_fn,
    predict_pipeline,
)
from .ops.preprocess import preprocess_image
from .parallel import (
    make_mesh,
    make_sharded_predict_fn,
    make_sharded_train_step,
    make_spatial_predict_fn,
    make_spatial_train_step,
)
from .predict import Predictor
from .serve import BatchingPredictor, PredictorOverloaded
from .train_lib import TrainState, create_train_state, make_eval_loss_fn, make_train_step
from .utils.checkpoint import CheckpointManager

__all__ = [
    "AnchorConfig", "BlockConfig", "EvalConfig", "ModelConfig", "TrainConfig",
    "anchor_targets", "anchor_targets_batch", "anchor_targets_batch_compact",
    "anchor_targets_compact", "anchors_for_shape", "clip_boxes", "decode_boxes",
    "encode_boxes", "iou_matrix", "detection_loss", "focal_loss", "smooth_l1_loss",
    "EfficientDet", "build_efficientdet", "fuse_for_inference", "make_predict_fn",
    "predict_pipeline", "preprocess_image", "Predictor", "BatchingPredictor",
    "PredictorOverloaded", "TrainState", "create_train_state", "make_eval_loss_fn",
    "make_train_step", "CheckpointManager", "CocoDataset", "CsvDataset", "DetectionDataset",
    "DeviceDataCache", "PascalVocDataset", "batch_iterator", "CocoEvaluator", "evaluate_coco",
    "evaluate_voc", "load_exported", "save_exported", "make_mesh", "make_sharded_predict_fn",
    "make_sharded_train_step", "make_spatial_predict_fn", "make_spatial_train_step",
] + [f"efficientdet_d{i}" for i in range(8)] + ["efficientdet_d7x"]
