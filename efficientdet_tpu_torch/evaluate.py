"""Evaluation CLI: counterpart of the JAX package's ``evaluate.py``.

    python -m efficientdet_tpu_torch.evaluate coco /data/coco --snapshot ckpts/ \\
        --phi 0 [--set val2017] [--max-images N]
    python -m efficientdet_tpu_torch.evaluate pascal /data/VOC2007 --snapshot ... \\
        --phi 0 [--set test]
    python -m efficientdet_tpu_torch.evaluate csv annots.csv classes.csv --snapshot ...
    ... --device cpu   # the CPU; the default is the GPU, raising without one
    torchrun --nproc-per-node N -m efficientdet_tpu_torch.evaluate ...  # N cards

Restores a ``train.py`` snapshot directory (``CheckpointManager``, with the
``TrainConfig`` of its ``train_config.json``), then prints the 12 COCO
statistics (numpy COCOeval) for ``coco``, or per-class VOC AP and the mAP
otherwise. Detections come from ``make_predict_fn`` in batches (normalise,
forward, decode and per-class NMS on the device), with the parity-exact
``EvalConfig.exact`` unless ``--fast-eval``. Over several processes
(``torchrun``) the batches go through ``make_sharded_predict_fn``: each
rank predicts its rows of every batch, every rank collects all the
detections, and rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    from .configs import PHIS, parse_phi

    p = argparse.ArgumentParser(prog="efficientdet_tpu_torch.evaluate",
                                description="Evaluate a checkpoint: COCO AP or VOC-style mAP.")
    sub = p.add_subparsers(dest="dataset_type", required=True)

    coco = sub.add_parser("coco")
    coco.add_argument("coco_path")
    coco.add_argument("--set", dest="eval_set", default="val2017")

    pascal = sub.add_parser("pascal")
    pascal.add_argument("pascal_path")
    pascal.add_argument("--set", dest="eval_set", default="test")

    csv_ = sub.add_parser("csv")
    csv_.add_argument("annotations_path")
    csv_.add_argument("classes_path")

    for q in (coco, pascal, csv_):
        q.add_argument("--snapshot", required=True,
                       help="checkpoint directory (train.py --snapshot-path)")
        q.add_argument("--phi", type=parse_phi, default=0, choices=PHIS)
        q.add_argument("--weighted-bifpn", action="store_true", default=None,
                       help="force weighted fusion (default: per-phi — "
                            "weighted for D0-D5, unweighted for D6, D7, D7x)")
        q.add_argument("--no-weighted-bifpn", dest="weighted_bifpn", action="store_false")
        q.add_argument("--image-size", type=int, default=None)
        q.add_argument("--batch-size", type=int, default=8)
        q.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
        q.add_argument("--score-threshold", type=float, default=0.05,
                       help="COCO collection threshold")
        q.add_argument("--iou-threshold", type=float, default=0.5, help="VOC matching IoU")
        q.add_argument("--max-images", type=int, default=None)
        q.add_argument("--save-detections", default=None, metavar="PATH",
                       help="also write the detections as a COCO results JSON")
        q.add_argument("--use-ema", action="store_true",
                       help="evaluate the EMA params if present in the snapshot")
        q.add_argument("--fast-eval", action="store_true",
                       help="the serving NMS settings (per-anchor class cap); "
                            "the default is the parity-exact EvalConfig.exact")
        q.add_argument("--device", default=None,
                       help="'cuda' (default; raises without a GPU) or 'cpu'")
    return p.parse_args(argv)


def build_dataset(args):
    from .data import CocoDataset, CsvDataset, PascalVocDataset

    if args.dataset_type == "coco":
        return CocoDataset(args.coco_path, args.eval_set)
    if args.dataset_type == "pascal":
        return PascalVocDataset(args.pascal_path, args.eval_set)
    return CsvDataset(args.annotations_path, args.classes_path)


def resolve_model_args(saved_cfg, phi, weighted, image_size, num_classes):
    """Merge the model section of train_config.json with the CLI's.

    The saved phi wins (with a warning); weighted_bifpn and image_size fall
    back to the saved values only when the CLI left them unset (None); a
    num_classes that differs from the dataset's warns and goes on.
    """
    if not saved_cfg or "model" not in saved_cfg:
        return phi, weighted, image_size
    m = saved_cfg["model"]
    if m.get("phi") is not None and m["phi"] != phi:
        if phi is not None:  # an unset CLI phi is a fallback, not an override
            print(f"WARNING: snapshot was trained with phi={m['phi']}; "
                  f"using it over --phi {phi}", flush=True)
        phi = m["phi"]
    if weighted is None:
        weighted = m.get("weighted_bifpn")
    if image_size is None:
        image_size = m.get("image_size")
    if m.get("num_classes") not in (None, num_classes):
        print(f"WARNING: snapshot num_classes={m['num_classes']} != "
              f"dataset's {num_classes}", flush=True)
    return phi, weighted, image_size


def evaluate_snapshot(args, dataset, mesh=None):
    """Restore ``args.snapshot`` and evaluate it on ``dataset`` (any
    ``DetectionDataset``; ``coco`` needs the dataset's ``coco`` index and
    ``cat_ids``). Prints as the JAX CLI does and returns the COCO statistics
    or ``{"mAP": ..., "aps": {label: (AP, n)}}``. ``mesh``: the world to
    predict over (parallel/mesh.py; None: ``make_mesh`` on ``args.device``,
    closed on return)."""
    from .parallel import make_mesh

    if mesh is not None:
        return _evaluate(args, dataset, mesh)
    mesh = make_mesh(device=args.device)
    try:
        return _evaluate(args, dataset, mesh)
    finally:
        mesh.close()


def _evaluate(args, dataset, mesh):
    import torch

    from . import build_efficientdet
    from .configs import EvalConfig, train_config_from_snapshot
    from .evaluation.coco_eval import evaluate_coco, make_batch_predict_fn
    from .evaluation.voc import evaluate_voc, mean_ap
    from .train_lib import create_train_state
    from .utils.checkpoint import CheckpointManager

    device = mesh.device
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    num_classes = dataset.num_classes()
    saved_cfg = None
    cfg_path = os.path.join(args.snapshot, "train_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            saved_cfg = json.load(f)
    phi, weighted, image_size = resolve_model_args(
        saved_cfg, args.phi, args.weighted_bifpn, args.image_size, num_classes)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model, cfg = build_efficientdet(phi, num_classes=num_classes, weighted_bifpn=weighted,
                                    dtype=dtype, image_size=image_size, device=device)
    size = cfg.image_size
    # the template has the snapshot's structure (accumulators, EMA copies)
    tc = train_config_from_snapshot(saved_cfg)
    state = CheckpointManager(args.snapshot).restore(create_train_state(model, tc, device))
    if args.use_ema and state.ema_params is not None:
        with torch.no_grad():
            for k, v in state.params.items():
                v.copy_(state.ema_params[k])
    model.eval()
    eval_cfg = EvalConfig() if args.fast_eval else EvalConfig.exact(num_classes)
    predict = make_batch_predict_fn(model, eval_cfg, mesh=mesh)
    say(f"EfficientDet-D{args.phi} | {size}px | {num_classes} classes | "
        f"{len(dataset)} images | {device} | {mesh.world_size} rank(s)", flush=True)
    if args.dataset_type == "coco":
        stats = evaluate_coco(dataset, predict, size, batch_size=args.batch_size,
                              score_threshold=args.score_threshold, max_images=args.max_images,
                              save_detections=args.save_detections if mesh.rank == 0 else None)
        say(json.dumps({k: round(v, 4) for k, v in stats.items()}))
        return stats
    aps = evaluate_voc(dataset, predict, size, batch_size=args.batch_size,
                       iou_threshold=args.iou_threshold, max_images=args.max_images)
    for label, (ap, n) in sorted(aps.items()):
        say(f"{dataset.label_to_name(label)}: AP={ap:.4f} ({n} gt)")
    say(json.dumps({"mAP": round(mean_ap(aps), 4)}))
    return {"mAP": mean_ap(aps), "aps": aps}


def main(argv=None):
    from .models.detector import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)  # raise before reading any file
    return evaluate_snapshot(args, build_dataset(args))


if __name__ == "__main__":
    main()
