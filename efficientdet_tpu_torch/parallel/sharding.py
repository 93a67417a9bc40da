"""Data- and spatially-parallel training and inference over a :class:`Mesh`.

Counterpart of the JAX package's ``parallel/sharding.py``, with its names.
There XLA's GSPMD writes every collective from the shardings; here each one
is written out (parallel/collectives.py), on ``all_reduce`` and
``broadcast`` only:

* :func:`make_sharded_train_step`: each rank steps on its rows of the global
  batch. Training-mode BN normalises with the global batch's statistics (an
  autograd all-reduce of the per-channel sums), the losses divide by the
  global positive count, the random draws (stochastic depth, the device
  augmenter) are the global batch's with each rank keeping its rows, and
  the gradients are SUM-all-reduced between ``torch.autograd.grad`` and
  ``global_norm``. The clip, Adam and EMA then run on identical tensors on
  every rank, so the parameters stay replicated with no broadcast: N ranks
  take the one-process step on the concatenated batch.
* :func:`make_sharded_predict_fn`: ``predict_pipeline`` (the head and NMS
  kernels) on each rank's rows of the batch, then the detections gathered,
  so every rank holds the whole batch's, as ``jax.device_get`` gives them.
* :func:`make_spatial_predict_fn` / :func:`make_spatial_train_step`: every
  rank holds the whole batch and computes a height band of every activation
  (parallel/context.py, parallel/spatial.py): the convnet's context
  parallelism, for images whose activations do not fit one card.

A mesh of one process with no process group gets the one-process functions
themselves (``make_train_step``, ``make_predict_fn``). Whatever
``torch.distributed`` raises (a rank gone, a timeout) fails the step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import collectives as C
from .context import ParallelContext, parallel_context
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, data_sharding, make_mesh, replicate, shard_batch

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "replicate", "data_sharding", "shard_batch",
    "make_sharded_train_step", "make_sharded_predict_fn", "make_spatial_predict_fn",
    "make_spatial_train_step",
]


def _sum_metrics(total: torch.Tensor, aux: Dict[str, torch.Tensor], group,
                 keys=("cls_loss", "box_loss")) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The ranks' loss shares summed: the whole batch's loss."""
    summed = C.sum_over_ranks([torch.stack([total.detach()] + [aux[k].detach() for k in keys])],
                              group)[0]
    aux = dict(aux)
    for i, k in enumerate(keys):
        aux[k] = summed[i + 1]
    return summed[0], aux


class _DataParallel:
    """What ``make_train_step`` changes for one rank of a data-parallel step."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.ctx = ParallelContext(mesh, "data")

    def context_for(self, images: torch.Tensor) -> ParallelContext:
        return self.ctx

    def loss(self, model, config, images, boxes, labels, generator):
        from ..train_lib import _loss

        positives = {}

        def normalize(anchor_state):
            local = (anchor_state == 1.0).float().sum().reshape(1)
            positives["global"] = C.sum_over_ranks([local], self.mesh.group)[0][0]
            return positives["global"].clamp_min(1.0)

        total, aux, _ = _loss(model, config, images, boxes, labels, generator, normalize)
        aux["num_positives"] = positives["global"] / float(images.shape[0] * self.mesh.world_size)
        return total, aux

    def reduce_grads(self, grads):
        return C.all_reduce_grads(grads, self.mesh.group)

    def reduce_metrics(self, total, aux):
        return _sum_metrics(total, aux, self.mesh.group)


class _Spatial(_DataParallel):
    """What ``make_train_step`` changes for one rank of a spatial step: the
    batch whole on every rank, the activations in height bands."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.contexts: Dict[int, ParallelContext] = {}

    def context_for(self, images: torch.Tensor) -> ParallelContext:
        size = images.shape[1]
        if size not in self.contexts:
            self.contexts[size] = ParallelContext(self.mesh, "spatial", size)
        return self.contexts[size]

    def loss(self, model, config, images, boxes, labels, generator):
        from .spatial import band_loss

        return band_loss(model, config, images, boxes, labels, generator, self.context_for(images))


def _replicate_weights(model, mesh: Mesh) -> None:
    """Rank 0's parameters and buffers on every rank, once, when a step is
    made. Only the model's: a train state's EMA copies and Adam moments are
    made from the weights by ``create_train_state``, so make the state after
    the step (train.py does) or build every rank from the same seed. The
    steps then keep every rank's state equal."""
    C.broadcast_(list(model.parameters()) + list(model.buffers()), mesh.group)


def make_sharded_train_step(model, config, mesh: Mesh):
    """``step(state, batch, generator=None) -> (state, metrics)`` over the
    rank's LOCAL batch (its rows of the global batch, equal on every rank;
    ``config.batch_size`` is the global batch). ``generator``: seeded alike
    on every rank. The metrics are the global batch's on every rank. Rank
    0's weights are broadcast here: make the train state after this call
    (``_replicate_weights``)."""
    from ..train_lib import make_train_step

    if mesh.group is None:
        return make_train_step(model, config, mesh.device)
    _replicate_weights(model, mesh)
    return make_train_step(model, config, mesh.device, parallel=_DataParallel(mesh))


def make_spatial_train_step(model, config, mesh: Mesh):
    """``step(state, batch, generator=None) -> (state, metrics)`` over the
    WHOLE batch on every rank, each computing a height band of every
    activation; the loss, gradients and BN statistics are the one-process
    step's. For a model whose activations do not fit one card; for
    throughput, :func:`make_sharded_train_step` (no halo traffic). Rank 0's
    weights are broadcast here, as there."""
    from ..train_lib import make_train_step

    if mesh.group is None:
        return make_train_step(model, config, mesh.device)
    _replicate_weights(model, mesh)
    return make_train_step(model, config, mesh.device, parallel=_Spatial(mesh))


def _no_detections(max_detections: int, device):
    return (torch.zeros((0, max_detections, 4), device=device),
            torch.zeros((0, max_detections), device=device),
            torch.zeros((0, max_detections), dtype=torch.int32, device=device),
            torch.zeros((0,), dtype=torch.int32, device=device))


def make_sharded_predict_fn(model, mesh: Mesh, eval_config=None, preprocess: bool = True):
    """``predict(images) -> (boxes, scores, classes, num_valid)`` of the
    whole batch on every rank. ``images``: the global batch (every rank
    passes the same); each rank runs ``predict_pipeline`` on its
    ``Mesh.rows`` share (some empty when the batch is smaller than the
    world), then the detections are gathered in batch order."""
    from ..configs import EvalConfig
    from ..models.detector import make_predict_fn, predict_pipeline

    eval_config = eval_config or EvalConfig()
    if mesh.group is None:
        return make_predict_fn(model, eval_config, preprocess)
    device = next(model.parameters()).device
    rows = data_sharding(mesh)

    def predict(images: torch.Tensor):
        n = images.shape[0]
        lo, hi = rows.rows(n)
        if hi > lo:
            dets = predict_pipeline(model, images[lo:hi].to(device), eval_config, preprocess)
        else:
            dets = _no_detections(eval_config.max_detections, device)
        return tuple(C.gather_rows(dets, 0, [(lo, hi, n)] * 4, mesh.group))

    return predict


def make_spatial_predict_fn(model, mesh: Mesh, eval_config=None, preprocess: bool = True):
    """``predict(images) -> (boxes, scores, classes, num_valid)``: the whole
    batch on every rank, each image split by height over the ranks. Before
    the heads' final layer each rank holds its band; the head kernel runs on
    the band's pixel rows; the anchor-major logits are gathered back into
    the serial order, and decode and NMS (the NMS kernel) run replicated."""
    from ..configs import EvalConfig
    from ..models.detector import make_predict_fn
    from ..ops.nms import batched_filter_from_anchor_major_levels
    from ..ops.preprocess import preprocess_batch_fixed
    from ..utils.profiling import stage
    from .spatial import gather_anchor_major

    eval_config = eval_config or EvalConfig()
    if mesh.group is None:
        return make_predict_fn(model, eval_config, preprocess)
    device = next(model.parameters()).device
    contexts: Dict[int, ParallelContext] = {}

    @torch.inference_mode()
    def predict(images: torch.Tensor):
        bsz, size = images.shape[0], images.shape[1]
        if images.shape[2] != size:
            raise ValueError(f"spatial predict takes square canvases, got {tuple(images.shape)}")
        if size not in contexts:
            contexts[size] = ParallelContext(mesh, "spatial", size)
        ctx = contexts[size]
        lo, hi = ctx.layout.band(1)
        x = images[:, lo:hi].to(device)
        if preprocess:
            with stage("preprocess"):
                x = preprocess_batch_fixed(x, dtype=model.dtype)
        with parallel_context(ctx):
            cls_out, box_out = model(x, anchor_major=True)
        cls_out, box_out = gather_anchor_major(cls_out, box_out, ctx, bsz,
                                               model.config.anchor.strides)
        with stage("postprocess"):
            return batched_filter_from_anchor_major_levels(
                model.anchors(size, device), box_out, cls_out, (size, size), eval_config)

    return predict
