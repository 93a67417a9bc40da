"""Single-image detection and the demo CLI.

Counterpart of the JAX package's ``predict.py``::

    predictor = Predictor(phi=0, num_classes=90)          # random weights from ``seed``
    predictor = Predictor.from_checkpoint(path, phi=0)    # a save_params file or a
                                                          # CheckpointManager directory
    boxes, scores, classes = predictor(image)             # one RGB uint8 image, any shape

The whole pipeline (aspect-preserving resize, pad to square, normalise,
backbone, BiFPN, heads, decode, clip, per-class NMS on the NMS kernel) runs
on the model's device; only the file decode and the truncation to the valid
detections happen on the host. Where the JAX package compiles one XLA
program per source shape, the card replays one CUDA graph per source shape
(h, w), captured at the first image of that shape and cached per instance,
at most 8 (the oldest goes first). With ``device="cpu"`` every call runs
eagerly, on the kernels' plain versions.

Threads may share one instance, as they may share the JAX package's jitted
function: one lock per instance covers a call's cache lookup (and capture or
eviction), copy-in, replay and copy-out. It is one lock for every shape, not
one a shape, because all of an instance's graphs share one memory pool and a
replay may overwrite another shape's outputs.

CLI::

    python -m efficientdet_tpu_torch.predict --phi 0 --checkpoint params.pt \\
        --image in.jpg --output out.png --score-threshold 0.3
"""

from __future__ import annotations

import argparse
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .configs import PHIS, EvalConfig, parse_phi
from .models.detector import build_efficientdet
from .ops.nms import filter_detections_from_logits
from .ops.preprocess import preprocess_image
from .utils.checkpoint import CheckpointManager, load_params
from .utils.cuda_graph import GraphedCall
from .utils.profiling import stage

MAX_CACHED_SHAPES = 8  # the JAX package's bound on its per-shape program cache


class Predictor:
    """Single-image detection with one CUDA graph per source shape on the card."""

    def __init__(
        self,
        phi: int = 0,
        num_classes: int = 90,
        weighted_bifpn: bool | None = None,
        score_threshold: float = 0.01,
        nms_iou_threshold: float = 0.5,
        max_detections: int = 100,
        dtype: str = "f32",
        variables: Optional[Dict[str, torch.Tensor]] = None,
        image_size: Optional[int] = None,
        seed: int = 0,
        device=None,
    ):
        """``variables``: a state dict of the unfused model, loaded strictly
        (``utils/convert.from_flax_variables`` bridges a flax tree);
        otherwise random weights from ``seed``. ``device=None`` is the GPU
        (raises without one)."""
        if dtype not in ("f32", "bf16"):
            raise ValueError(f"dtype must be 'f32' or 'bf16', got {dtype!r}")
        self.model, self.config = build_efficientdet(
            phi,
            num_classes=num_classes,
            weighted_bifpn=weighted_bifpn,
            dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
            image_size=image_size,
            device=device,
            seed=seed,
        )
        self.device = next(self.model.parameters()).device
        if variables is not None:
            self.model.load_state_dict(variables, strict=True)
        self.eval_config = EvalConfig(
            score_threshold=score_threshold,
            nms_iou_threshold=nms_iou_threshold,
            max_detections=max_detections,
        )
        # per-INSTANCE cache keyed on source shape, oldest first; the graphs
        # share one memory pool, made with the first of them
        self._run_cache: dict = {}
        self._pool = None
        self._lock = threading.Lock()

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "Predictor":
        """A Predictor whose weights come from a params-only checkpoint
        (``utils/checkpoint.save_params``) or from a ``CheckpointManager``
        directory (numbered step directories: the latest step's params and
        BN statistics, without the optimizer's state), loaded strictly."""
        p = cls(**kwargs)
        is_manager_dir = os.path.isdir(path) and any(s.isdigit() for s in os.listdir(path))
        if is_manager_dir:
            saved = CheckpointManager(path).restore_partial()
            p.model.load_state_dict({**saved["params"], **saved["batch_stats"]}, strict=True)
        else:
            load_params(path, p.model)
        return p

    def _pipeline(self, image: torch.Tensor):
        """(H, W, 3) uint8 on the model's device -> (boxes in source pixels
        (D, 4), scores (D,), classes (D,), num_valid ()), padded."""
        size = self.config.image_size
        ec = self.eval_config
        with stage("preprocess"):
            x, scale = preprocess_image(image, size, dtype=self.model.dtype)
        cls_logits, box_deltas = self.model(x[None])
        with stage("postprocess"):
            b, s, c, n = filter_detections_from_logits(
                self.model.anchors(size, self.device),
                box_deltas[0],
                cls_logits[0],
                (size, size),
                ec.score_threshold,
                ec.nms_iou_threshold,
                ec.max_detections,
                ec.pre_nms_top_k,
            )
            return b / scale, s, c, n

    def _compiled(self, h: int, w: int):
        """The runner for source shape (h, w): its CUDA graph on the card,
        the eager pipeline on the CPU; made once and cached."""
        run = self._run_cache.get((h, w))
        if run is not None:
            return run
        if self.device.type == "cuda":
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            example = torch.zeros((h, w, 3), dtype=torch.uint8, device=self.device)
            run = GraphedCall(self._pipeline, example, pool=self._pool)
        else:
            run = torch.inference_mode()(self._pipeline)
        if len(self._run_cache) >= MAX_CACHED_SHAPES:
            self._run_cache.pop(next(iter(self._run_cache)))
        self._run_cache[(h, w)] = run
        return run

    def _to_host(self, outputs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Padded device outputs -> numpy copies truncated to the valid detections."""
        if self.device.type == "cuda":
            # one wait for the four copies (a graph's outputs are read before
            # its next replay: the copies are on the replay's stream)
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outputs]
            for dst, src in zip(host, outputs):
                dst.copy_(src, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        else:
            host = outputs
        b, s, c, n = (t.numpy() for t in host)
        n = int(n)
        return b[:n].copy(), s[:n].copy(), c[:n].copy()

    @staticmethod
    def _check(image) -> np.ndarray:
        image = np.ascontiguousarray(image)
        if not image.flags.writeable:  # torch.from_numpy wants a writable array
            image = image.copy()
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected one (H, W, 3) RGB image, got shape {image.shape}")
        return image

    def __call__(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(H, W, 3) RGB uint8 -> (boxes xyxy in source pixels, scores,
        classes), truncated to the valid detections."""
        image = self._check(image)
        with self._lock:
            run = self._compiled(*image.shape[:2])
            return self._to_host(run(torch.from_numpy(image)))

    def eager(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The same pipeline run op by op, without a graph: what a replay is
        held against, and its time."""
        image = self._check(image)
        with torch.inference_mode():
            out = self._pipeline(torch.from_numpy(image).to(self.device))
        return self._to_host(out)


def main(argv=None):
    p = argparse.ArgumentParser(description="EfficientDet inference demo.")
    p.add_argument("--phi", type=parse_phi, default=0, choices=PHIS)
    p.add_argument("--checkpoint", default=None,
                   help="a save_params file or a CheckpointManager directory")
    p.add_argument("--image", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--num-classes", type=int, default=90)
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--device", default=None, help="default: the GPU; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    from .utils.image import draw_detections, read_image_rgb

    kwargs = dict(phi=args.phi, num_classes=args.num_classes, device=args.device)
    if args.checkpoint:
        predictor = Predictor.from_checkpoint(args.checkpoint, **kwargs)
    else:
        predictor = Predictor(**kwargs)
        print("warning: no --checkpoint, using random weights")

    image = read_image_rgb(args.image)
    boxes, scores, classes = predictor(image)
    keep = scores >= args.score_threshold
    print(f"{int(keep.sum())} detections >= {args.score_threshold}")
    for b, s, c in zip(boxes[keep], scores[keep], classes[keep]):
        print(f"  class={int(c):3d} score={s:.3f} box={np.round(b, 1).tolist()}")
    if args.output:
        out = draw_detections(image, boxes, scores, classes, score_threshold=args.score_threshold)
        from PIL import Image

        Image.fromarray(out).save(args.output)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
