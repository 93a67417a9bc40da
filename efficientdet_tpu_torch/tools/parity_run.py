"""The weights-day drill: an official checkpoint -> COCO AP -> the delta from
the paper. The port's counterpart of the JAX package's ``tools/parity_run.py``.

One command stands between "weights obtained" and "parity number"
(BASELINE.json asks for COCO mAP within 0.2 of the reference). When an
official automl EfficientDet checkpoint is at hand as an ``.npz`` of
``{tf_name: array}`` (dumped with TensorFlow on any machine), run::

  python -m efficientdet_tpu_torch.tools.parity_run --weights d0.npz --coco-path /data/coco --phi 0

It (a) loads the archive, (b) runs ``import_detector(strict=True)``, which
needs every tensor of the model covered and every shape to match, so a
naming drift fails here, (c) runs the exact COCO evaluation
(``EvalConfig.exact``, ``make_sharded_predict_fn`` over this process's mesh,
the automl 90-id label map where the model's classes exceed the dataset's)
over val2017, and (d) prints one JSON line with the AP and the delta from
the paper's table. It runs on the GPU; ``--device cpu`` runs it on the CPU.

The shrink flags (``--bifpn-width``/``--bifpn-depth``/``--head-depth``,
``--image-size``) let ``tests/test_torch_parity_run.py`` drive this drill
end to end on synthetic ``export_detector_tf_style`` weights, so it cannot rot
before weights day. ``run(args, dataset)`` takes any detection dataset in
place of the COCO directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

# EfficientDet paper Table 2 (arXiv 1911.09070), COCO test-dev AP: the JAX
# drill's figures, and D7x's
PAPER_AP = {0: 34.6, 1: 40.5, 2: 43.0, 3: 47.5, 4: 49.7, 5: 51.5,
            6: 52.6, 7: 53.7, "7x": 55.1}


def parse_args(argv=None):
    from ..configs import PHIS, parse_phi

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--weights", required=True,
                   help=".npz archive of {tf_name: array} official weights")
    p.add_argument("--coco-path", required=True)
    p.add_argument("--set", dest="eval_set", default="val2017")
    p.add_argument("--phi", type=parse_phi, default=0, choices=PHIS)
    p.add_argument("--num-classes", type=int, default=90,
                   help="automl checkpoints are 90-class")
    p.add_argument("--weighted-bifpn", action="store_true", default=None)
    p.add_argument("--no-weighted-bifpn", dest="weighted_bifpn",
                   action="store_false")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="f32 default: parity first, speed second")
    p.add_argument("--score-threshold", type=float, default=0.001,
                   help="automl eval uses a near-zero threshold")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--save-detections", default=None)
    p.add_argument("--device", default=None,
                   help="default: the GPU (raises without one); 'cpu' to run on the CPU")
    # the test harness's shrink flags (see the module docstring)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--bifpn-width", type=int, default=None)
    p.add_argument("--bifpn-depth", type=int, default=None)
    p.add_argument("--head-depth", type=int, default=None)
    p.add_argument("--paper-ap", type=float, default=None,
                   help="override the paper AP the delta is computed "
                   "against (test harness)")
    return p.parse_args(argv)


def load_tf_archive(path: str) -> dict:
    import numpy as np

    with np.load(path, allow_pickle=False) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def run(args, dataset=None) -> dict:
    """The drill on parsed ``args``; ``dataset``: a detection dataset with a
    COCO index (``data.DetectionDataset``), else ``CocoDataset`` of
    ``args.coco_path``. Prints the drill's lines; returns ``{"record": the
    parity line's dict, "stats": the unrounded COCO stats, "model": the
    imported model}``."""
    import torch

    from ..configs import EvalConfig
    from ..data import CocoDataset
    from ..evaluation.coco_eval import evaluate_coco, make_batch_predict_fn
    from ..models.detector import EfficientDet, build_efficientdet, resolve_device
    from ..parallel import make_mesh
    from ..utils.convert import import_detector

    device = resolve_device(args.device)  # no card: raise before reading anything
    tf_vars = load_tf_archive(args.weights)
    print(f"loaded {len(tf_vars)} variables from {args.weights}", flush=True)

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model, cfg = build_efficientdet(
        args.phi, num_classes=args.num_classes, weighted_bifpn=args.weighted_bifpn,
        dtype=dtype, image_size=args.image_size, device=device,
    )
    shrink = {
        k: v for k, v in (
            ("bifpn_width", args.bifpn_width),
            ("bifpn_depth", args.bifpn_depth),
            ("head_depth", args.head_depth),
        ) if v is not None
    }
    if shrink:
        cfg = dataclasses.replace(cfg, **shrink)
        model = EfficientDet(cfg, dtype).to(device).eval()

    # the parity gate: strict and full coverage, so that one unmapped or
    # misshapen variable aborts here instead of leaving random weights in
    # the model and a quietly wrong mAP
    import_detector(model, tf_vars, cfg, strict=True)
    print("import_detector: strict full-coverage import ok", flush=True)

    if dataset is None:
        dataset = CocoDataset(args.coco_path, args.eval_set)
    mesh = make_mesh(device=device)
    # "exact" is judged against the MODEL's class space: a per-anchor class
    # cap sized off the dataset's 80 categories would leave a top-80-of-90
    # approximation inside the one tool whose contract is no approximation
    eval_cfg = EvalConfig.exact(cfg.num_classes)
    predict = make_batch_predict_fn(model, eval_cfg, mesh=mesh)

    # official automl checkpoints classify over the 90-id COCO space
    # (category_id = label + 1); the dataset maps its 80 categories
    # contiguously. Where the class counts differ, take the automl
    # convention and drop labels whose id has no annotations.
    label_to_cat = None
    if cfg.num_classes != dataset.num_classes():
        valid = set(dataset.cat_ids)
        label_to_cat = {lab: lab + 1 for lab in range(cfg.num_classes) if (lab + 1) in valid}
        print(f"label map: automl 90-id convention (label+1); {len(label_to_cat)}/"
              f"{cfg.num_classes} labels have annotated categories", flush=True)

    # each rank predicts its rows of a batch: round the batch up to a
    # multiple of the world (a short last batch is padded anyway)
    n_dev = mesh.world_size
    batch_size = -(-args.batch_size // n_dev) * n_dev
    if batch_size != args.batch_size:
        print(f"batch_size {args.batch_size} -> {batch_size} (multiple of {n_dev} ranks)",
              flush=True)

    stats = evaluate_coco(
        dataset, predict, cfg.image_size,
        batch_size=batch_size,
        score_threshold=args.score_threshold,
        max_images=args.max_images,
        save_detections=args.save_detections,
        label_to_cat=label_to_cat,
    )
    ap = 100.0 * stats.get("AP", float("nan"))
    paper = args.paper_ap if args.paper_ap is not None else PAPER_AP[args.phi]
    rec = {
        "event": "parity",
        "phi": args.phi,
        "AP": round(ap, 2),
        "paper_AP": paper,
        "delta": round(ap - paper, 2),
        "within_0.2": bool(abs(ap - paper) <= 0.2),
        "images": len(dataset) if args.max_images is None else min(args.max_images, len(dataset)),
        "stats": {k: round(v, 4) for k, v in stats.items()},
    }
    print(json.dumps(rec), flush=True)
    return {"record": rec, "stats": stats, "model": model}


def main(argv=None) -> dict:
    return run(parse_args(argv))["record"]


if __name__ == "__main__":
    main()
