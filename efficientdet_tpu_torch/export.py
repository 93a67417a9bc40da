"""Ahead-of-time export: one deployable file for the serving host.

Counterpart of the JAX package's ``export.py``. ``torch.export`` traces the
whole batched predict program (uint8 normalise -> BN-folded forward ->
decode -> per-class NMS, ``front_end="anchor_major"``) at one static input
shape into an ``ExportedProgram``. The head, NMS, conv-epilogue,
depthwise and BiFPN node kernels appear in it as the custom ops
``efficientdet_tpu_torch::head_pointwise``,
``efficientdet_tpu_torch::nms_keep_mask``,
``efficientdet_tpu_torch::conv_epilogue_`` / ``conv_epilogue_padded``,
``efficientdet_tpu_torch::depthwise_conv_silu`` and
``efficientdet_tpu_torch::bifpn_node`` (ops/head_kernel.py,
ops/nms_kernel.py, ops/conv_epilogue.py, ops/depthwise_conv.py,
ops/bifpn_node.py), so the serving host needs torch, those five modules
and this loader, and no
model-construction code: the artifact pins the anchor
layout, the NMS thresholds and the front end at export time.

Artifact format (one zip, extension ``.edz`` by convention), with the JAX
artifact's members and manifest keys:

  manifest.json  format and torch versions, ``runtime: "torch"``, the
                 ModelConfig essentials, EvalConfig, batch size, the device
                 it was exported on (``platforms``), and the dtype, shape
                 and state-dict path of every weight tensor
  program.pt2    ``torch.export.save`` of predict(weights, images)
  vars/<i>.bin   raw little-endian bytes of each weight

Weights ride as program *inputs*: the exported module holds the model
outside its module tree and reparametrises it with the input dict, so the
program holds no copy of them (only the anchors, a constant) and the same
program can be re-exported across checkpoints. The loader closes the
restored weights over the program and returns a plain ``predict(images)``.

``.pt2`` makes no promise across torch versions (StableHLO does across JAX
versions): a load error names the torch that wrote the artifact.

CLI (evaluate.py's snapshot resolution)::

  python -m efficientdet_tpu_torch.export --snapshot ckpts/ --batch 8 --out d0.edz
  python -m efficientdet_tpu_torch.export --phi 0 --batch 1 --out d0.edz  # random weights
  ... --device cpu   # export on the CPU; the default is the GPU, raising without one
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import zipfile

import torch

from .configs import parse_phi

FORMAT_VERSION = 1
_PROGRAM_NAME = "program.pt2"
_JAX_PROGRAM_NAME = "program.stablehlo"
_MANIFEST_NAME = "manifest.json"


class _Pipeline(torch.nn.Module):
    """``predict_pipeline`` over a registered model: what the program
    reparametrises with its weight inputs."""

    def __init__(self, model, eval_config, preprocess: bool):
        super().__init__()
        self.model = model
        self.eval_config = eval_config
        self.preprocess = preprocess

    def forward(self, images):
        from .models.detector import predict_pipeline

        return predict_pipeline(self.model, images, self.eval_config, self.preprocess,
                                front_end="anchor_major")


class _Program(torch.nn.Module):
    """``forward(weights, images)``: the pipeline with the model's state dict
    as an input. The pipeline is kept out of the module tree, so the
    exported program registers no parameter and embeds no weight."""

    def __init__(self, pipeline: _Pipeline):
        super().__init__()
        self.__dict__["_pipeline"] = pipeline

    def forward(self, weights, images):
        named = {f"model.{k}": v for k, v in weights.items()}
        return torch.func.functional_call(self._pipeline, named, (images,))


def export_predict(model, batch_size: int, *, eval_config=None, preprocess: bool = True):
    """Export the full predict pipeline on the model's device; returns
    ``(ExportedProgram, weights)``.

    ``weights`` (the state dict the program takes as its first input) are
    returned because an unfused model's BatchNorms are folded into the conv
    weights first (``fuse_for_inference``, the production inference path)
    and the FUSED weights are what the program takes.
    """
    from .configs import EvalConfig
    from .models.detector import fuse_for_inference
    from .utils.profiling import stages_off

    if eval_config is None:
        eval_config = EvalConfig()
    if not model.fuse_bn:
        model = fuse_for_inference(model)
    model.eval()
    device = next(model.parameters()).device
    size = model.config.image_size
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    # made eagerly: anchors first made while tracing would be fake tensors,
    # left in the model's cache for its later eager calls
    model.anchors(size, device)
    img_dtype = torch.uint8 if preprocess else model.dtype
    images = torch.zeros((batch_size, size, size, 3), dtype=img_dtype, device=device)
    program = _Program(_Pipeline(model, eval_config, preprocess))
    # no stage ranges: a torch version whose non-strict export keeps
    # record_function would put profiler ops into the program
    with torch.no_grad(), stages_off():
        exported = torch.export.export(program, (weights, images), strict=False)
    # the example inputs would store a second copy of the weights in the .pt2
    exported.example_inputs = None
    return exported, weights


def save_exported(path: str, model, batch_size: int, *, eval_config=None,
                  preprocess: bool = True) -> dict:
    """Export and write the one-file serving artifact; returns the manifest."""
    from .configs import EvalConfig

    if eval_config is None:
        eval_config = EvalConfig()
    exported, weights = export_predict(model, batch_size, eval_config=eval_config,
                                       preprocess=preprocess)
    cfg = model.config
    device = next(model.parameters()).device
    manifest = {
        "format_version": FORMAT_VERSION,
        "runtime": "torch",
        "torch_version": torch.__version__,
        "platforms": [device.type],
        "batch_size": batch_size,
        "preprocess": preprocess,
        "fused_bn": True,
        "model": {
            "phi": cfg.phi,
            "image_size": cfg.image_size,
            "num_classes": cfg.num_classes,
            "weighted_bifpn": cfg.weighted_bifpn,
        },
        "eval_config": dataclasses.asdict(eval_config),
        "dtype": _dtype_name(model.dtype),
        "variables": [
            {"path": key.split("."), "dtype": _dtype_name(v.dtype), "shape": list(v.shape)}
            for key, v in weights.items()
        ],
    }
    program = io.BytesIO()
    torch.export.save(exported, program)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_MANIFEST_NAME, json.dumps(manifest, indent=1))
        zf.writestr(_PROGRAM_NAME, program.getvalue())
        for i, v in enumerate(weights.values()):
            zf.writestr(f"vars/{i}.bin", _le_bytes(v))
    return manifest


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _le_bytes(t: torch.Tensor) -> bytes:
    """A tensor's raw bytes, little-endian (the host order of every
    platform torch builds for)."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_bytes(buf: bytes, spec) -> torch.Tensor:
    dtype = getattr(torch, spec["dtype"])
    flat = torch.frombuffer(bytearray(buf), dtype=torch.uint8).view(dtype)
    return flat.reshape(spec["shape"])


def load_exported(path: str, device=None):
    """Load an ``.edz`` artifact; returns ``(predict, manifest)``.

    ``predict(images)`` takes a ``(batch_size, S, S, 3)`` batch on
    ``device`` (None: the GPU, raising without one) and returns
    ``(boxes, scores, classes, num_valid)`` exactly as
    :func:`efficientdet_tpu_torch.make_predict_fn` does. The program is moved
    to ``device`` when it was exported on another (a CPU-made artifact
    serves on the card). Loading imports the kernels' op registrations and
    builds no model.
    """
    from .models.detector import resolve_device
    from .ops import (bifpn_node, conv_epilogue, depthwise_conv,  # noqa: F401 — the
                      head_kernel, nms_kernel)  # program's ops

    device = resolve_device(device)
    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())
        if _PROGRAM_NAME not in names and _JAX_PROGRAM_NAME in names:
            raise ValueError(
                f"{path} was exported by the JAX package (efficientdet_tpu.export: "
                f"{_JAX_PROGRAM_NAME}, no {_PROGRAM_NAME}); load it with "
                "efficientdet_tpu.export.load_exported, or re-export it with "
                "efficientdet_tpu_torch.export"
            )
        manifest = json.loads(zf.read(_MANIFEST_NAME))
        if manifest["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"artifact format {manifest['format_version']} is newer than "
                f"this loader ({FORMAT_VERSION})"
            )
        try:
            exported = torch.export.load(io.BytesIO(zf.read(_PROGRAM_NAME)))
        except Exception as e:  # the .pt2 format is tied to the torch that wrote it
            raise RuntimeError(
                f"cannot load the program of {path}: exported with torch "
                f"{manifest.get('torch_version')}, this is torch {torch.__version__}"
            ) from e
        weights = {
            ".".join(spec["path"]): _from_bytes(zf.read(f"vars/{i}.bin"), spec).to(device)
            for i, spec in enumerate(manifest["variables"])
        }
    if manifest["platforms"][0] != device.type:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, str(device))
    module = exported.module()
    size = manifest["model"]["image_size"]
    shape = (manifest["batch_size"], size, size, 3)

    def predict(images: torch.Tensor):
        if tuple(images.shape) != shape:
            raise ValueError(f"the artifact takes images of shape {shape}, "
                             f"got {tuple(images.shape)}")
        with torch.inference_mode():
            return tuple(module(weights, images))

    return predict, manifest


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="efficientdet_tpu_torch.export",
                                description="Export a one-file AOT serving artifact (.edz)")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--snapshot", help="checkpoint dir written by train.py")
    p.add_argument("--phi", type=parse_phi, default=None, help="D0..D7 or D7x (no snapshot)")
    p.add_argument("--num-classes", type=int, default=90)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--weighted-bifpn", action="store_true", default=None)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--exact-eval", action="store_true",
                   help="use EvalConfig.exact (parity eval) instead of serving defaults")
    p.add_argument("--device", default=None,
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from .configs import EvalConfig, train_config_from_snapshot
    from .evaluate import resolve_model_args
    from .models.detector import build_efficientdet, resolve_device

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    saved_cfg = None
    if args.snapshot:
        cfg_path = os.path.join(args.snapshot, "train_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                saved_cfg = json.load(f)
    phi, weighted, image_size = resolve_model_args(
        saved_cfg, args.phi, args.weighted_bifpn, args.image_size, args.num_classes)
    if phi is None:
        # neither --phi nor a snapshot's train_config.json gave the model
        # scale: a usable CLI error, not a KeyError inside ModelConfig.for_phi
        raise SystemExit(
            "error: no model scale: pass --phi 0..7 or 7x, or --snapshot with a "
            "train_config.json that records phi"
            + (f" ({args.snapshot}/train_config.json is missing or has no "
               "model.phi)" if args.snapshot else "")
        )
    model, _ = build_efficientdet(phi, num_classes=args.num_classes, weighted_bifpn=weighted,
                                  dtype=dtype, image_size=image_size, device=device)
    if args.snapshot:
        from .train_lib import create_train_state
        from .utils.checkpoint import CheckpointManager

        tc = train_config_from_snapshot(saved_cfg)
        state = CheckpointManager(args.snapshot).restore(create_train_state(model, tc, device))
        if args.use_ema and state.ema_params is not None:
            with torch.no_grad():
                for k, v in state.params.items():
                    v.copy_(state.ema_params[k])
        model.eval()
    eval_cfg = EvalConfig.exact(args.num_classes) if args.exact_eval else EvalConfig()
    manifest = save_exported(args.out, model, args.batch, eval_config=eval_cfg)
    print(json.dumps({
        "event": "exported", "out": args.out,
        "mb": round(os.path.getsize(args.out) / 1e6, 2),
        "platforms": manifest["platforms"], "model": manifest["model"],
        "batch_size": manifest["batch_size"],
    }))


if __name__ == "__main__":
    main()
