"""EfficientDet in PyTorch for NVIDIA Hopper: a port of ``efficientdet_tpu``.

The JAX package beside this one is the reference; this package imports none
of it and no JAX. Its kernels (``csrc/``) are CUDA C++ for sm_90a, built with
nvcc at first use; on CPU tensors their plain PyTorch versions run instead.
"""

from .configs import AnchorConfig, BlockConfig, EvalConfig, ModelConfig
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
    fuse_for_inference,
    make_predict_fn,
    predict_pipeline,
)

__all__ = [
    "AnchorConfig", "BlockConfig", "EvalConfig", "ModelConfig", "EfficientDet",
    "build_efficientdet", "fuse_for_inference", "make_predict_fn",
    "predict_pipeline",
] + [f"efficientdet_d{i}" for i in range(8)]
