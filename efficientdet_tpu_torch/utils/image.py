"""Image file reading and drawing for the demo CLI, on the host only.

Counterpart of the JAX package's ``utils/image.py``. PIL and cv2 are
imported inside the functions: the machine that runs the port on the card
has neither, and nothing on the card's path calls these.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def read_image_rgb(path: str) -> np.ndarray:
    """(H, W, 3) RGB uint8 from disk (PIL; cv2 where PIL is missing)."""
    try:
        from PIL import Image
    except ImportError:
        import cv2

        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        return bgr[..., ::-1].copy()
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    label_names: Optional[Sequence[str]] = None,
    score_threshold: float = 0.3,
    color=(255, 64, 32),
) -> np.ndarray:
    """Boxes and ``name score`` labels drawn onto a copy of ``image`` (cv2)."""
    import cv2

    out = np.ascontiguousarray(image.copy())
    for box, score, cls in zip(boxes, scores, classes):
        if score < score_threshold:
            continue
        x1, y1, x2, y2 = (int(round(float(v))) for v in box)
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        name = (
            label_names[int(cls)]
            if label_names is not None and 0 <= int(cls) < len(label_names)
            else str(int(cls))
        )
        cv2.putText(out, f"{name} {score:.2f}", (x1, max(0, y1 - 4)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)
    return out
