"""Training CLI: counterpart of the JAX package's ``train.py``, with its flags.

    python -m efficientdet_tpu_torch.train coco  /data/coco  --phi 0 ...
    python -m efficientdet_tpu_torch.train pascal /data/VOC2012 ...
    python -m efficientdet_tpu_torch.train csv annots.csv classes.csv ...
    ... --device cpu   # the CPU; the default is the GPU, raising without one
    torchrun --nproc-per-node N -m efficientdet_tpu_torch.train ...  # N cards

Read a dataset, batch and letterbox it on the host (optionally augmenting
there, ``--random-transform``, or on the device inside the step,
``--device-augment``), or keep it letterboxed on the card
(``--device-cache N``); train with ``train_lib.make_train_step``; at each
epoch's end evaluate (COCO AP for ``coco``, VOC mAP otherwise) on the EMA
weights when there are any, cut the learning rate on a plateau, and write a
``CheckpointManager`` snapshot. ``train_config.json`` and
``train_log.jsonl`` are written as the JAX package writes them.

``main(argv)`` is ``build_dataset`` and ``train_from_datasets``, which takes
dataset objects, so any ``DetectionDataset`` can drive the same loop.

Over several processes (``torchrun``, or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) the loop
is data parallel (parallel/): ``--batch-size`` stays the global batch and
must divide by the world size; each rank reads its share of every epoch
(``batch_iterator(shard_index=rank, shard_count=world)``, or its rows of the
device cache's batches), steps with ``make_sharded_train_step`` and
evaluates with ``make_sharded_predict_fn``; rank 0 alone prints, logs and
writes snapshots, and broadcasts the epoch's mAP so that every rank takes
the same plateau decision. The flags do not change.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


def parse_args(argv=None):
    from .configs import PHIS, parse_phi

    p = argparse.ArgumentParser(prog="efficientdet_tpu_torch.train",
                                description="Train an EfficientDet model (PyTorch, one GPU).")
    sub = p.add_subparsers(dest="dataset_type", required=True)

    coco = sub.add_parser("coco")
    coco.add_argument("coco_path")
    coco.add_argument("--train-set", default="train2017")
    coco.add_argument("--val-set", default="val2017")

    pascal = sub.add_parser("pascal")
    pascal.add_argument("pascal_path")
    pascal.add_argument("--train-set", default="trainval")
    pascal.add_argument("--val-set", default="test")

    csv_ = sub.add_parser("csv")
    csv_.add_argument("annotations_path")
    csv_.add_argument("classes_path")
    csv_.add_argument("--val-annotations-path")

    for q in (coco, pascal, csv_):
        q.add_argument("--phi", type=parse_phi, default=0, choices=PHIS)
        q.add_argument("--weighted-bifpn", action="store_true", default=None,
                       help="force weighted fusion (default: per-phi — "
                            "weighted for D0-D5, unweighted for D6, D7, D7x)")
        q.add_argument("--no-weighted-bifpn", dest="weighted_bifpn", action="store_false")
        q.add_argument("--freeze-backbone", action="store_true")
        q.add_argument("--freeze-bn", action="store_true")
        q.add_argument("--batch-size", type=int, default=8)
        q.add_argument("--epochs", type=int, default=50)
        q.add_argument("--steps", type=int, default=None,
                       help="steps per epoch (default: dataset//batch)")
        q.add_argument("--lr", type=float, default=1e-3)
        q.add_argument("--snapshot", default=None,
                       help="checkpoint dir to resume from, or 'imagenet' "
                            "(needs converted weights)")
        q.add_argument("--snapshot-path", default="checkpoints")
        q.add_argument("--random-transform", action="store_true")
        q.add_argument("--device-augment", action="store_true",
                       help="random affine + colour augmentation on the device "
                            "inside the step (ops/augment.py); the host only "
                            "reads and letterboxes")
        q.add_argument("--device-cache", type=int, default=0, metavar="N",
                       help="keep the first N letterboxed images resident on the "
                            "device (data/device_cache.py) and gather each batch "
                            "there; pair with --device-augment. 0 = off.")
        q.add_argument("--data-echo", type=int, default=1, metavar="E",
                       help="consume each host batch E times (data echoing); with "
                            "--device-augment every echo is a different view")
        q.add_argument("--compute-val-loss", action="store_true")
        q.add_argument("--max-gt", type=int, default=100)
        q.add_argument("--grad-accum-steps", type=int, default=1,
                       help="accumulate k gradients per optimiser update "
                            "(effective batch = k * batch-size)")
        q.add_argument("--ema-decay", type=float, default=0.0,
                       help="keep an EMA of params for eval (0 = off)")
        q.add_argument("--image-size", type=int, default=None)
        q.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
        q.add_argument("--remat", action="store_true",
                       help="recompute blocks in the backward pass")
        q.add_argument("--remat-scope", default="full", choices=["full", "backbone", "fpn"],
                       help="which components remat applies to")
        q.add_argument("--log-file", default=None)
        q.add_argument("--tensorboard-dir", default=None,
                       help="TensorFlow event files (not written by the port: "
                            "a 'disabled' line is printed)")
        q.add_argument("--no-eval", action="store_true")
        q.add_argument("--eval-every", type=int, default=1, help="epochs")
        q.add_argument("--reduce-lr-patience", type=int, default=2)
        q.add_argument("--reduce-lr-factor", type=float, default=0.1)
        q.add_argument("--workers", type=int, default=0,
                       help="host data-loading threads per batch")
        q.add_argument("--seed", type=int, default=0)
        q.add_argument("--debug-nans", action="store_true",
                       help="raise on a non-finite loss (checked every step)")
        q.add_argument("--device", default=None,
                       help="'cuda' (default; raises without a GPU) or 'cpu'")
    return p.parse_args(argv)


def build_dataset(args, train: bool):
    from .data import CocoDataset, CsvDataset, PascalVocDataset

    if args.dataset_type == "coco":
        return CocoDataset(args.coco_path, args.train_set if train else args.val_set)
    if args.dataset_type == "pascal":
        return PascalVocDataset(args.pascal_path, args.train_set if train else args.val_set)
    if train:
        return CsvDataset(args.annotations_path, args.classes_path)
    if args.val_annotations_path:
        return CsvDataset(args.val_annotations_path, args.classes_path)
    return None


@contextlib.contextmanager
def eval_weights(model, state):
    """``model`` in eval mode (running BN statistics, none updated) holding
    the EMA weights when the state keeps them; the training weights and mode
    come back afterwards."""
    was_training = model.training
    saved = None
    with torch.no_grad():
        if state.ema_params is not None:
            saved = {k: v.detach().clone() for k, v in state.params.items()}
            for k, v in state.params.items():
                v.copy_(state.ema_params[k])
    model.eval()
    try:
        yield model
    finally:
        with torch.no_grad():
            if saved is not None:
                for k, v in state.params.items():
                    v.copy_(saved[k])
        model.train(was_training)


@contextlib.contextmanager
def _restore_threads():
    threads = torch.get_num_threads()
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _snapshot_fused(snapshot: str) -> bool:
    """``fused_optimizer`` of a snapshot's train_config.json (False when the
    file or field is missing: snapshots from before the field)."""
    path = os.path.join(snapshot, "train_config.json")
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return json.load(f).get("train", {}).get("fused_optimizer", False)


def train_from_datasets(args, train_ds, val_ds, on_step: Optional[Callable] = None, mesh=None):
    """The training loop of ``main`` on dataset objects.

    ``args``: ``parse_args``'s namespace (``dataset_type`` picks the epoch
    evaluation: COCO AP for "coco", which needs the dataset's ``coco`` index
    and ``cat_ids``; VOC mAP otherwise). ``on_step(epoch, step_in_epoch,
    state, metrics)``, if given, runs after every step. ``mesh``: the world
    to train over (parallel/mesh.py; None: ``make_mesh`` on ``args.device``,
    one process unless the launcher's environment says otherwise, closed on
    return). Returns the model, the final state and the epoch records
    (``loss``, ``mAP``, ``lr_scale`` ...), equal on every rank.
    """
    from .parallel import make_mesh

    if mesh is not None:
        return _train(args, train_ds, val_ds, on_step, mesh)
    mesh = make_mesh(device=args.device)
    try:
        return _train(args, train_ds, val_ds, on_step, mesh)
    finally:
        mesh.close()


def _train(args, train_ds, val_ds, on_step, mesh):
    from . import build_efficientdet
    from .configs import TrainConfig
    from .data.augment import make_augmenter
    from .data.common import batch_iterator, prefetch
    from .parallel import make_sharded_train_step
    from .parallel.collectives import broadcast_
    from .train_lib import create_train_state, make_eval_loss_fn
    from .utils.checkpoint import CheckpointManager

    device, world, lead = mesh.device, mesh.world_size, mesh.rank == 0
    if args.batch_size % world:
        raise SystemExit(
            f"--batch-size {args.batch_size} is not divisible by the {world}-way "
            "data-parallel axis: every rank must get an equal batch slice")
    local_batch = args.batch_size // world
    say = print if lead else (lambda *a, **k: None)
    num_classes = train_ds.num_classes()
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model, cfg = build_efficientdet(
        args.phi, num_classes=num_classes, weighted_bifpn=args.weighted_bifpn,
        freeze_bn=args.freeze_bn, dtype=dtype, image_size=args.image_size,
        remat=args.remat, remat_scope=args.remat_scope, device=device, seed=args.seed,
    )
    size = cfg.image_size
    say(f"EfficientDet-D{args.phi} | {size}px | {num_classes} classes | {device} | "
        f"{world} rank(s)", flush=True)

    steps_per_epoch = args.steps or max(1, len(train_ds) // args.batch_size)
    tc = TrainConfig(
        batch_size=args.batch_size, learning_rate=args.lr, epochs=args.epochs,
        steps_per_epoch=steps_per_epoch, max_gt_boxes=args.max_gt,
        freeze_backbone=args.freeze_backbone, grad_accum_steps=args.grad_accum_steps,
        ema_decay=args.ema_decay, device_augment=args.device_augment,
    )
    if args.snapshot and args.snapshot != "imagenet":
        # the snapshot's configuration is written back as it was (the field
        # does not change the port's step)
        saved_fused = _snapshot_fused(args.snapshot)
        if saved_fused != tc.fused_optimizer:
            say(f"snapshot opt_state is {'fused' if saved_fused else 'leaf-wise'}; matching "
                f"fused_optimizer={saved_fused} for resume", flush=True)
            tc = dataclasses.replace(tc, fused_optimizer=saved_fused)

    # the configurations beside the snapshots: evaluate.py and --snapshot
    # rebuild the same TrainState from them
    if lead:
        os.makedirs(args.snapshot_path, exist_ok=True)
        with open(os.path.join(args.snapshot_path, "train_config.json"), "w") as f:
            json.dump({"train": dataclasses.asdict(tc),
                       "model": {"phi": args.phi, "num_classes": num_classes,
                                 "weighted_bifpn": cfg.weighted_bifpn, "freeze_bn": args.freeze_bn,
                                 "image_size": size}},
                      f, indent=1)

    if args.snapshot == "imagenet":
        raise SystemExit(
            "--snapshot imagenet needs pretrained weights, which cannot be "
            "downloaded here. Convert an official EfficientNet/EfficientDet "
            "checkpoint with efficientdet_tpu_torch.utils.convert and pass its "
            "directory instead."
        )
    model.train()
    # made first: it gives every rank rank 0's weights, which the state's EMA
    # copies and Adam moments are then made from
    step_fn = make_sharded_train_step(model, tc, mesh)
    state = create_train_state(model, tc, device)
    ckpt = CheckpointManager(args.snapshot_path) if lead else None
    if args.snapshot:
        state = CheckpointManager(args.snapshot).restore(state)
        say(f"resumed from {args.snapshot} at step {int(state.step)}")

    augment = make_augmenter() if args.random_transform and not args.device_augment else None
    if args.device_cache > 0:
        if args.random_transform and not args.device_augment:
            raise SystemExit(
                "--device-cache stores the letterboxed pixels once, so "
                "host-side --random-transform can't apply; use "
                "--device-augment (the fused on-device augmenter)"
            )
        from .data.device_cache import DeviceDataCache

        cache = DeviceDataCache(train_ds, target_size=size, max_gt=args.max_gt,
                                limit=args.device_cache, mesh=mesh)
        say(json.dumps({"device_cache_images": len(cache),
                        "device_cache_mb": round(cache.nbytes() / 1e6, 1),
                        "device_cache_rank_mb": round(cache.local_nbytes() / 1e6, 1)}), flush=True)
        # drop_last=False: a batch larger than a small dataset wrap-pads
        it = cache.batches(args.batch_size, seed=args.seed, drop_last=False)
    else:
        it = prefetch(batch_iterator(
            train_ds, local_batch, target_size=size, max_gt=args.max_gt, shuffle=True,
            repeat=True, augment=augment, seed=args.seed, workers=args.workers,
            shard_index=mesh.rank, shard_count=world), size=2)

    if args.data_echo > 1:
        # each echo is a new view: the step's generator advances
        it = (b for b in it for _ in range(args.data_echo))

    log_path = args.log_file or os.path.join(args.snapshot_path, "train_log.jsonl")
    if lead:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    if args.tensorboard_dir:
        say("tensorboard disabled (the port writes no TensorFlow event files; "
              f"the metrics are in {log_path})", flush=True)

    # the plateau multiplier starts from the restored value on resume
    lr_scale = float(state.lr_scale)
    best_map, bad_epochs = -1.0, 0
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    history = []
    t_epoch = time.time()
    with open(log_path if lead else os.devnull, "a") as logf, _restore_threads():
        if args.workers > 0 and args.device_cache == 0 and device.type == "cuda":
            # each worker letterboxes (and augments) with one intra-op thread
            # rather than all of them sharing torch's pool (faster at 8
            # workers on the card's host: PERF.md); restored on return
            torch.set_num_threads(1)
        for epoch in range(args.epochs):
            agg = {}
            for s in range(steps_per_epoch):
                batch = next(it)
                step_batch = {k: batch[k] for k in ("images", "gt_boxes", "gt_labels")}
                if args.device_augment:
                    step_batch["extents"] = batch["extents"]
                state, metrics = step_fn(state, step_batch, generator)
                if args.debug_nans and not math.isfinite(float(metrics["loss"])):
                    raise FloatingPointError(
                        f"non-finite loss {float(metrics['loss'])} at step {state.step}")
                if on_step is not None:
                    on_step(epoch, s, state, metrics)
                if s % 50 == 0 or s == steps_per_epoch - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(epoch=epoch, step=int(state.step), sec=round(time.time() - t_epoch, 1))
                    say(json.dumps(m), flush=True)
                    logf.write(json.dumps(m) + "\n")
                    logf.flush()
                    agg = m
            epoch_metrics = {"loss": agg.get("loss", 0.0)}
            if args.compute_val_loss and val_ds is not None:
                eval_loss = make_eval_loss_fn(model, tc, device)
                vals = []
                for vb in batch_iterator(val_ds, args.batch_size, target_size=size,
                                         max_gt=args.max_gt, shuffle=False):
                    vals.append({k: float(v) for k, v in eval_loss(state, vb).items()})
                    if len(vals) >= 50:
                        break
                if vals:
                    vl = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
                    epoch_metrics.update(vl)
                    say(json.dumps({"epoch": epoch, **{k: round(v, 4) for k, v in vl.items()}}),
                        flush=True)
            if val_ds is not None and not args.no_eval and (epoch + 1) % args.eval_every == 0:
                epoch_map = evaluate_epoch(args, model, state, val_ds, size, logf, epoch, mesh)
                # rank 0's figure decides the plateau on every rank
                shared = torch.tensor([epoch_map], dtype=torch.float64, device=device)
                broadcast_([shared], mesh.group)
                epoch_map = float(shared[0])
                epoch_metrics["mAP"] = epoch_map
                say(f"epoch {epoch}: mAP={epoch_map:.4f}", flush=True)
                if epoch_map > best_map:
                    best_map, bad_epochs = epoch_map, 0
                else:
                    bad_epochs += 1
                    if bad_epochs >= args.reduce_lr_patience:
                        lr_scale *= args.reduce_lr_factor
                        bad_epochs = 0
                        say(f"ReduceLROnPlateau: lr_scale -> {lr_scale}", flush=True)
                        state = state.replace(lr_scale=lr_scale)
            if lead:
                ckpt.save(int(state.step), state, epoch_metrics)
            history.append({"epoch": epoch, "step": int(state.step), "lr_scale": lr_scale,
                            **epoch_metrics})
            t_epoch = time.time()
    return model, state, history


def evaluate_epoch(args, model, state, val_ds, size, logf=None, epoch=0, mesh=None) -> float:
    """COCO AP (``dataset_type`` "coco", at most 500 images) or VOC mAP of
    the model's eval weights (``eval_weights``) on ``val_ds``; the COCO
    statistics are logged (by rank 0). With a ``mesh`` of several ranks each
    predicts its rows of every batch (``make_sharded_predict_fn``) and all
    get the same figure."""
    from .evaluation.coco_eval import evaluate_coco, make_batch_predict_fn
    from .evaluation.voc import evaluate_voc, mean_ap

    with eval_weights(model, state):
        predict = make_batch_predict_fn(model, mesh=mesh)
        if args.dataset_type == "coco":
            stats = evaluate_coco(val_ds, predict, size, batch_size=args.batch_size, max_images=500)
            if mesh is None or mesh.rank == 0:
                print(json.dumps({"epoch": epoch, **{k: round(v, 4) for k, v in stats.items()}}),
                      flush=True)
            if logf is not None:
                logf.write(json.dumps({"epoch": epoch, **stats}) + "\n")
            return stats["AP"]
        aps = evaluate_voc(val_ds, predict, size, batch_size=args.batch_size, max_images=500)
        return mean_ap(aps)


def main(argv=None):
    from .models.detector import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)  # raise before reading any file
    _, state, _ = train_from_datasets(args, build_dataset(args, train=True),
                                      build_dataset(args, train=False))
    return state


if __name__ == "__main__":
    main()
