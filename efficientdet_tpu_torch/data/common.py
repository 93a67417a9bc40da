"""Host-side letterboxing for the batching server.

Counterpart of ``letterbox_hostside`` in the JAX package's ``data/common.py``
(the datasets and the training batch pipeline are not ported yet). The JAX
version resizes with ``cv2.resize(INTER_LINEAR)``; the machine that runs the
port on the card has neither cv2 nor PIL, so this one resizes with torch on
CPU tensors: bilinear with half-pixel centres and no antialiasing, as
INTER_LINEAR. It agrees with cv2 to one grey level (both sum in fixed
point, with other weights' precision).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def letterbox_hostside(image: np.ndarray, target_size: int) -> Tuple[np.ndarray, float]:
    """(H, W, 3) RGB uint8 -> a (target_size, target_size, 3) uint8 canvas, and the scale.

    The long side is resized to ``target_size`` (the short one to
    round(side * scale)); the bottom and right are zero padded. The server
    assembles these canvases into one fixed-shape batch, so a single CUDA
    graph per batch size serves every source shape.
    """
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise TypeError(f"expected an (H, W, 3) uint8 image, got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    scale = target_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if not image.flags.writeable:  # a decoded request; torch.from_numpy wants writable
        image = image.copy()
    # torch's uint8 bilinear sums in fixed point, as cv2 does, on the
    # channels-last view (no copy in or out): a third of the time of float
    # planes on one core
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    resized = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    canvas = np.zeros((target_size, target_size, 3), np.uint8)
    canvas[:nh, :nw] = resized[0].permute(1, 2, 0).numpy()
    return canvas, scale
