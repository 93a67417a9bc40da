"""Fused NMS suppression: CUDA kernel and plain twin.

Counterpart of the JAX package's ``ops/nms_pallas.py``. For score-sorted
candidates ``boxes (B, K, 4)`` float32 xyxy, ``classes (B, K)`` int32 and
``valid (B, K)`` bool, both return the greedy per-class NMS keep mask
``(B, K)`` bool: the fixpoint of ``keep[i] = valid[i] and not any_{j<i}
keep[j] and IoU(j, i) > t and class[j] == class[i]``.

:func:`suppression_keep_mask` launches ``csrc/nms_suppress.cu`` (a bit-packed
mask, then a greedy scan) for CUDA tensors and takes
:func:`suppression_keep_mask_reference` only for CPU ones.
"""

from __future__ import annotations

import ctypes

import torch

from ..anchors import iou_matrix

# The scan holds an image's bit-packed mask (K * ceil(K/64) words) and its
# valid flags in shared memory: at most 227 KB a block on Hopper, K <= 1536.
_SCAN_SMEM_MAX = 232448


def suppression_keep_mask_reference(
    boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
    iou_threshold: float = 0.5,
) -> torch.Tensor:
    """Plain-torch twin: the JAX package's ``_fixpoint_suppress``, batched."""
    k = boxes.shape[1]
    ious = iou_matrix(boxes, boxes)  # (B, K, K), [j, i]
    same = classes[:, :, None] == classes[:, None, :]
    idx = torch.arange(k, device=boxes.device)
    tri = idx[:, None] < idx[None, :]
    sup = ((ious > iou_threshold) & same & tri).float()
    keep = valid.clone()
    for _ in range(k):
        suppressed = torch.bmm(keep.float()[:, None, :], sup)[:, 0] > 0.5
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def suppression_keep_mask(
    boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
    iou_threshold: float = 0.5,
) -> torch.Tensor:
    """Greedy per-class NMS keep mask (B, K) bool for score-sorted candidates."""
    if boxes.device.type == "cpu":
        return suppression_keep_mask_reference(boxes, classes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"suppression_keep_mask: unsupported device {boxes.device}")
    from . import cuda_build

    b, k = boxes.shape[:2]
    if boxes.shape != (b, k, 4) or classes.shape != (b, k) or valid.shape != (b, k):
        raise ValueError(
            f"shapes boxes {tuple(boxes.shape)}, classes {tuple(classes.shape)}, "
            f"valid {tuple(valid.shape)} do not agree"
        )
    if boxes.dtype != torch.float32 or classes.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(
            f"need float32 boxes, int32 classes, bool valid; got "
            f"{boxes.dtype}, {classes.dtype}, {valid.dtype}"
        )
    if not (boxes.is_contiguous() and classes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes, classes and valid must be contiguous")
    if classes.device != boxes.device or valid.device != boxes.device:
        raise ValueError("boxes, classes and valid must be on one device")
    words = -(-k // 64)
    if words > 32 or k * words * 8 + k > _SCAN_SMEM_MAX:
        raise ValueError(f"K={k} candidates need more shared memory than the scan has")
    lib = cuda_build.load("nms_suppress")
    mask = torch.empty((b, k, words), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)

    fn = lib.nms_suppress_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = fn(
            boxes.data_ptr(), classes.data_ptr(), valid.data_ptr(),
            mask.data_ptr(), keep.data_ptr(), b, k, float(iou_threshold), stream,
        )
    cuda_build.check(lib, "nms_suppress", err)
    suppression_keep_mask.launches += 1
    return keep


suppression_keep_mask.launches = 0
