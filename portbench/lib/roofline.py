"""Bytes and operations that a configuration's shapes require of the port's
two kernels, from which a roofline share is the least time (``peaks.bound_s``)
over the kernel's device time.

Each input byte is counted read once and each output byte written once, at
the shapes the configuration fixes, whatever the kernel pads, stages or
reads again.
"""

from __future__ import annotations

NMS_OPS_PER_PAIR = 14  # one IoU test: 2 min, 2 max, 2 sub, 2 clamp, mul, add, sub, max, div, compare


def head_rows(config, batch: int) -> int:
    """Pixel rows of the heads' final pointwise conv: every P3-P7 pixel of
    every image (698,368 for D0@512 at batch 128)."""
    return batch * sum((-(-config.image_size // s)) ** 2 for s in config.strides)


def head_kernel(config, batch: int, elem: int = 2):
    """(bytes, operations) of one call's class and box launches: x (M, Cin)
    read, the (Cin, A out) kernel and the float32 bias read, z (A, M, out)
    and the per-anchor best (A, M) written, 2 operations a multiply-add."""
    m, cin, a = head_rows(config, batch), config.bifpn_width, config.num_anchors
    nbytes = ops = 0
    for out, amax in ((config.num_classes, True), (4, False)):
        nbytes += m * cin * elem + cin * a * out * elem + a * out * 4 + a * m * out * elem
        nbytes += a * m * elem if amax else 0
        ops += 2.0 * m * cin * a * out
    return nbytes, ops


def nms_kernel(batch: int, k: int, same_class_pairs: float):
    """(bytes, operations) of one call's suppression: boxes (B, K, 4)
    float32, classes (B, K) int32 and valid (B, K) read, keep (B, K)
    written; a class compare for every pair j < i, an IoU test for each pair
    of one class (``same_class_pairs`` over the batch)."""
    nbytes = batch * k * (16 + 4 + 1) + batch * k
    ops = batch * k * (k - 1) / 2 + same_class_pairs * NMS_OPS_PER_PAIR
    return nbytes, ops
