"""The float64 witness for a float32 comparison of the port, on the CPU.

:func:`float64_distance` says how far a model's own float32 head outputs lie
from its float64 ones, in units of the gpu_vs_cpu rule (1e-4 of the
output's scale). A card-vs-CPU difference of that order is float32
rounding, not a fault of either device. ``chip_smoke.py``'s family draws its
weights with ``efficientdet_tpu_torch.experiments.drawn_weights``, and this
script shows why: on ``build_efficientdet``'s init, or at the draw's default
gain at D6/D7, float32 alone lies past the rule. No JAX is imported.

    PYTHONPATH=. python tests/torch_float64_witness.py --phi 6 --image-size 384 [--gain 1]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from efficientdet_tpu_torch.experiments.drawn_weights import drawn_model
from efficientdet_tpu_torch.models.detector import (
    EfficientDet,
    build_efficientdet,
    fuse_for_inference,
)
from efficientdet_tpu_torch.ops.preprocess import preprocess_batch_fixed


@torch.no_grad()
def float64_distance(model: torch.nn.Module, images: torch.Tensor) -> dict:
    """The CPU's float32 head outputs (BN folded, "concat") against the same
    weights computed in float64, each as its largest difference over 1e-4
    of the float64 output's scale."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    f32 = EfficientDet(model.config)
    f32.load_state_dict(state)
    f32 = fuse_for_inference(f32.eval())
    f64 = EfficientDet(model.config, torch.float64).double()
    f64.load_state_dict({k: v.double() for k, v in state.items()})
    images = images.cpu()
    got = f32(preprocess_batch_fixed(images))
    want = f64.eval()(preprocess_batch_fixed(images, dtype=torch.float64))
    return {name: {"scale": w.abs().max().item(),
                   "over_tol": ((g.double() - w).abs().max() / (1e-4 * w.abs().max())).item()}
            for name, g, w in zip(("class", "box"), got, want)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phi", type=int, default=0)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--weights", choices=("init", "drawn"), default="drawn",
                    help="build_efficientdet's init or the numpy draw")
    ap.add_argument("--gain", type=float, default=1.5, help="the draw's conv variance x fan-in")
    args = ap.parse_args(argv)
    if args.weights == "init":
        model, _ = build_efficientdet(args.phi, seed=args.phi, device="cpu",
                                      image_size=args.image_size)
    else:
        model = drawn_model("cpu", seed=args.phi, phi=args.phi, image_size=args.image_size,
                            gain=args.gain)
    size = model.config.image_size
    rng = np.random.RandomState(100 + args.phi)
    images = torch.from_numpy(rng.randint(0, 256, (1, size, size, 3)).astype(np.uint8))
    print(json.dumps({"phi": args.phi, "size": size, "weights": args.weights,
                      "gain": args.gain if args.weights == "drawn" else None,
                      **float64_distance(model, images)}))


if __name__ == "__main__":
    main()
