"""Rank programs of tests/test_torch_parallel.py and tests/test_torch_spatial.py.

Each function here runs in a fresh process started by
``efficientdet_tpu_torch.parallel.launch.spawn`` as ``fn(mesh, **kwargs)``
and returns a dict of tensors and numbers. This module imports the port
only (no JAX): the test files, which import both, compute the references
in the pytest process, partly with the builders below.
"""

import dataclasses
import os

import numpy as np
import torch

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.data import DetectionDataset, DeviceDataCache
from efficientdet_tpu_torch.models.conv import Conv2d
from efficientdet_tpu_torch.models.normalization import TpuBatchNorm
from efficientdet_tpu_torch.ops.resample import downsample_maxpool, upsample_to
from efficientdet_tpu_torch.parallel import (
    make_sharded_predict_fn,
    make_sharded_train_step,
    make_spatial_predict_fn,
    make_spatial_train_step,
)
from efficientdet_tpu_torch.parallel import collectives as C
from efficientdet_tpu_torch.parallel.context import ParallelContext, parallel_context
from efficientdet_tpu_torch.parallel.mesh import split_rows
from efficientdet_tpu_torch.parallel.spatial import band_loss


def build_model(spec, state, device="cpu"):
    """EfficientDet of ``spec`` ({"phi", "num_classes", "image_size",
    "overrides": ModelConfig fields, optionally "dtype": its compute dtype's
    name, whose parameters then take that dtype too}) holding ``state``,
    in eval mode."""
    cfg = et.ModelConfig.for_phi(spec["phi"], num_classes=spec["num_classes"],
                                 image_size=spec["image_size"])
    cfg = dataclasses.replace(cfg, **spec.get("overrides", {}))
    dtype = getattr(torch, spec.get("dtype", "float32"))
    model = et.EfficientDet(cfg, dtype).to(dtype)
    model.load_state_dict(state)
    return model.to(device).eval()


def _cpu(tensors):
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def run_steps(model, config, step, batches, seed, rows=None):
    """``step`` over ``batches`` (``rows``: the slice of each batch this
    process steps on), its generator seeded ``seed``; the metrics, and the
    parameters, BN buffers and Adam first moments after."""
    state = et.create_train_state(model, config, next(model.parameters()).device)
    gen = torch.Generator().manual_seed(seed)
    metrics = []
    for batch in batches:
        if rows is not None:
            batch = {k: v[rows[0]:rows[1]] for k, v in batch.items()}
        state, m = step(state, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": _cpu(state.params), "buffers": _cpu(state.batch_stats),
            "mu": _cpu(state.opt_state["mu"])}


def train_steps(mesh, spec, state, batches, train_config, mode, seed=0):
    """The sharded ("data": each rank its rows of every batch) or spatial
    step over ``batches``."""
    model = build_model(spec, state).train()
    tc = et.TrainConfig(**train_config)
    make = make_sharded_train_step if mode == "data" else make_spatial_train_step
    rows = mesh.rows(batches[0]["images"].shape[0]) if mode == "data" else None
    return run_steps(model, tc, make(model, tc, mesh), batches, seed, rows)


def spatial_grads(mesh, spec, state, batch, train_config):
    """Eval-mode (running BN) gradients of the detection loss with the
    activations in height bands, summed over the ranks."""
    model = build_model(spec, state)
    tc = et.TrainConfig(**train_config)
    names = [k for k, _ in model.named_parameters()]
    ctx = ParallelContext(mesh, "spatial", batch["images"].shape[1])
    with parallel_context(ctx):
        total, _ = band_loss(model, tc, batch["images"], batch["gt_boxes"], batch["gt_labels"],
                             None, ctx)
        grads = torch.autograd.grad(total, list(model.parameters()))
    grads = C.all_reduce_grads(grads, mesh.group)
    loss = C.sum_over_ranks([total.detach().reshape(1)], mesh.group)[0]
    return {"grads": dict(zip(names, grads)), "loss": float(loss[0])}


def predict(mesh, spec, state, images, mode, eval_config):
    """The sharded or spatial predict function's detections."""
    model = build_model(spec, state)
    make = make_sharded_predict_fn if mode == "data" else make_spatial_predict_fn
    dets = make(model, mesh, et.EvalConfig(**eval_config))(images)
    return {"dets": [d.cpu() for d in dets]}


LAYER_CASES = [  # name, op, kernel, stride, depthwise, input stride
    ("stem_conv3_s2", "conv", 3, 2, False, 1),
    ("dw3_s1", "conv", 3, 1, True, 2),
    ("dw3_s2", "conv", 3, 2, True, 2),
    ("dw5_s1", "conv", 5, 1, True, 4),
    ("dw5_s2", "conv", 5, 2, True, 4),
    ("dw3_s1_coarsest_band", "conv", 3, 1, True, 16),
    ("dw3_s2_band_to_whole", "conv", 3, 2, True, 16),
    ("dw5_s2_band_to_whole", "conv", 5, 2, True, 16),
    ("conv3_s1_whole", "conv", 3, 1, False, 32),
    ("pw1_s1", "conv", 1, 1, False, 8),
    ("maxpool3_s2", "maxpool", 3, 2, False, 8),
    ("maxpool3_s2_band_to_whole", "maxpool", 3, 2, False, 16),
    ("maxpool3_s2_whole", "maxpool", 3, 2, False, 32),
    ("upsample2_band", "upsample", 0, 1, False, 8),
    ("upsample2_whole_to_band", "upsample", 0, 1, False, 16),
    ("se_mean", "mean", 0, 1, False, 4),
    ("bn_train", "bn", 0, 1, False, 8),
]


def _layer(op, k, s, depthwise, ch, gen):
    if op == "conv":
        conv = Conv2d(ch, ch, k, stride=s, groups=ch if depthwise else 1)
        with torch.no_grad():
            conv.weight.normal_(0, 0.3, generator=gen)
            conv.bias.normal_(0, 0.1, generator=gen)
        return conv
    if op == "maxpool":
        return downsample_maxpool
    if op == "upsample":
        return lambda x: upsample_to(x, 2 * x.shape[-2], 2 * x.shape[-1])
    if op == "mean":
        return lambda x: torch.mean(x, dim=(2, 3), keepdim=True, dtype=torch.float32)
    bn = TpuBatchNorm(ch).train()
    with torch.no_grad():
        bn.weight.normal_(1, 0.2, generator=gen)
        bn.bias.normal_(0, 0.2, generator=gen)
    return bn


HALO_PAIRS = [(1, 1), (2, 2), (0, 1), (1, 2)]  # 3x3 s1, 5x5 s1, 3x3 s2 and max-pool, 5x5 s2


def layer_cases(mesh, image_size, halo_rows, seed=0):
    """Every case of LAYER_CASES on a (2, 3, S/t, S/t) input: the banded
    output and input gradient (gathered over the ranks) against the serial
    layer's on the whole input; max abs errors and scales by case. Then
    ``halo_roundtrip`` on bands of ``halo_rows`` rows for every HALO_PAIRS."""
    ctx = ParallelContext(mesh, "spatial", image_size)
    lay = ctx.layout
    out = {}
    for name, op, k, s, depthwise, t in LAYER_CASES:
        gen = torch.Generator().manual_seed(seed)
        ch = 3
        in_stride = 2 * t if op == "upsample" else t
        h = image_size // in_stride
        x_full = torch.randn((2, ch, h, h), generator=gen)
        layer = _layer(op, k, s, depthwise, ch, gen)
        if op == "bn":
            serial_bn = TpuBatchNorm(ch).train()
            serial_bn.load_state_dict(layer.state_dict())
            serial = serial_bn
        else:
            serial = layer
        xs = x_full.clone().requires_grad_(True)
        y_full = serial(xs)
        g_full = torch.randn(y_full.shape, generator=gen)
        (dx_full,) = torch.autograd.grad((y_full * g_full).sum(), xs)

        x_in = x_full[:, :, slice(*lay.band(in_stride))] if lay.banded(in_stride) else x_full
        x_in = x_in.clone().requires_grad_(True)
        with parallel_context(ctx):
            y = layer(x_in)
        if op == "mean":
            y = ctx.spatial_mean(x_in) if lay.banded(in_stride) else y
            want, g = y_full, g_full / mesh.world_size
        else:
            out_stride = in_stride * s if op != "upsample" else t
            if lay.banded(out_stride):
                lo, hi = lay.band(out_stride)
                want, g = y_full[:, :, lo:hi], g_full[:, :, lo:hi]
            else:
                lo, hi = split_rows(y_full.shape[2], mesh.world_size)[mesh.rank]
                want = y_full
                g = torch.zeros_like(g_full)
                g[:, :, lo:hi] = g_full[:, :, lo:hi]
        (dx,) = torch.autograd.grad((y * g).sum(), x_in)
        if lay.banded(in_stride):
            lo, hi = lay.band(in_stride)
            (dx,) = C.gather_rows([dx], 2, [(lo, hi, h)], mesh.group)
        else:
            (dx,) = C.sum_over_ranks([dx], mesh.group)
        res = {"out_err": float((y.detach() - want.detach()).abs().max()),
               "out_scale": float(want.detach().abs().max()),
               "grad_err": float((dx - dx_full).abs().max()),
               "grad_scale": float(dx_full.abs().max()),
               "shape": list(y.shape)}
        if op == "bn":
            res["stats_err"] = max(float((layer.running_mean - serial_bn.running_mean).abs().max()),
                                   float((layer.running_var - serial_bn.running_var).abs().max()))
        out[name] = res
    out["layout"] = {"unit": lay.unit, "bounds": list(lay.bounds)}
    out["halo"] = {f"{a}_{b}": halo_roundtrip(mesh, halo_rows, a, b) for a, b in HALO_PAIRS}
    return out


def halo_roundtrip(mesh, rows, above, below):
    """halo_exchange on a band of ``rows[rank]`` rows whose values are their
    global row numbers: the rows it receives, and the gradient it sends back
    (every halo row's gradient = 1)."""
    lo = sum(rows[:mesh.rank])
    band = torch.arange(lo, lo + rows[mesh.rank], dtype=torch.float32).view(1, 1, -1, 1)
    band = band.expand(1, 2, -1, 3).contiguous().requires_grad_(True)
    ext = C.halo_exchange(band, above, below, -1.0, mesh.group, mesh.rank, mesh.world_size)
    (g,) = torch.autograd.grad(ext.sum(), band)
    return {"rows": ext[0, 0, :, 0].detach(), "grad": g[0, 0, :, 0]}


class ArrayDataset(DetectionDataset):
    """Images of several shapes made with numpy, 1-4 boxes each."""

    SHAPES = [(48, 64), (64, 40), (32, 32), (70, 20), (25, 60)]

    def __init__(self, n=11, seed=0):
        rng = np.random.RandomState(seed)
        self.images, self.anns = [], []
        for i in range(n):
            h, w = self.SHAPES[i % len(self.SHAPES)]
            self.images.append(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            k = 1 + i % 4
            xy = rng.uniform(0, [w * 0.6, h * 0.6], (k, 2))
            boxes = np.concatenate([xy, xy + rng.uniform(2, [w * 0.5, h * 0.5], (k, 2))], 1)
            self.anns.append((boxes.astype(np.float32), rng.randint(0, 3, k).astype(np.int32)))

    def __len__(self):
        return len(self.images)

    def load_image(self, index):
        return self.images[index]

    def load_annotations(self, index):
        return self.anns[index]

    def num_classes(self):
        return 3


def device_cache(mesh, n, indices, batch_size):
    """A DeviceDataCache over ``ArrayDataset(n)`` split over the mesh: its
    sizes, this rank's rows of ``get_batch(indices)`` and of the first
    ``batches(batch_size, drop_last=False)`` batch."""
    cache = DeviceDataCache(ArrayDataset(n), target_size=64, max_gt=5, upload_chunk=2,
                            mesh=mesh)
    first = next(cache.batches(batch_size, seed=0, drop_last=False))
    return {"len": len(cache), "nbytes": cache.nbytes(), "local_nbytes": cache.local_nbytes(),
            "batch": _cpu(cache.get_batch(indices)), "first": _cpu(first)}


def train_cli(mesh, argv):
    """``train.train_from_datasets`` on the CLI's arguments (``{rank}`` in
    them is this rank's number) over the mesh: the epoch records."""
    from efficientdet_tpu_torch import train

    args = train.parse_args([a.replace("{rank}", str(mesh.rank)) for a in argv])
    _, state, history = train.train_from_datasets(
        args, train.build_dataset(args, train=True), train.build_dataset(args, train=False),
        mesh=mesh)
    return {"history": history, "step": state.step,
            "files": sorted(os.listdir(args.snapshot_path)) if os.path.isdir(args.snapshot_path)
            else []}


def many(mesh, calls):
    """Several of this module's rank programs in one process: ``calls`` is
    a list of (function name, kwargs); the results in that order."""
    return {"results": [globals()[name](mesh, **kw) for name, kw in calls]}
