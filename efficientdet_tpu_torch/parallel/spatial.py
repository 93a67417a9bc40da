"""The spatial mode's two ends: a band's share of the loss, and the heads'
anchor-major outputs put back together.

Inside the model a spatial ``parallel_context`` keeps every level split by
height (parallel/context.py). What comes out of the heads is this rank's
rows of each banded level and the whole of each thin one:

* in training (:func:`band_loss`) each rank's loss covers the anchors of its
  rows (a thin level's rows dealt over the ranks by ``split_rows``, some
  shares empty), divided by the whole batch's positive count, so the ranks'
  losses and gradients sum to the one-process step's;
* in inference (:func:`gather_anchor_major`) the head kernel's anchor-major
  logits, best-class logits and box rows of the bands are gathered back into
  exactly the order the serial heads produce: level by level, then anchor,
  image and pixel row by row (models/heads.py), before decode and NMS.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..anchors import anchor_targets_batch_compact
from ..losses import detection_loss_from_levels
from ..utils.profiling import stage
from . import collectives as C
from .context import ParallelContext
from .mesh import split_rows


def band_loss(model, config, images: torch.Tensor, boxes, labels, generator,
              ctx: ParallelContext) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """This rank's share of the detection loss of a batch every rank holds
    whole: ``images`` (B, S, S, 3) normalised float32; the forward runs on
    the rank's band of rows."""
    lay = ctx.layout
    anchors = model.anchors(images.shape[1], images.device)
    with stage("loss"):
        cls_t, box_t, state_t = anchor_targets_batch_compact(
            anchors, boxes, labels, config.positive_iou, config.negative_iou)
        positive = (state_t == 1.0).float()
        normalizer = positive.sum().clamp_min(1.0)
    lo, hi = lay.band(1)
    cls_levels, box_levels = model(images[:, lo:hi], raw_levels=True, generator=generator)
    with stage("loss"):
        a = model.config.num_anchors_per_cell
        cls_mine, box_mine, ids = [], [], []
        off = 0
        for cl, bl in zip(cls_levels, box_levels):
            w = cl.shape[2]
            stride = lay.size // w
            rows = lay.rows(stride)
            if lay.banded(stride):
                r0, r1 = lay.band(stride)
                cls_mine.append(cl)
                box_mine.append(bl)
            else:
                r0, r1 = split_rows(rows, ctx.world)[ctx.rank]
                cls_mine.append(cl[:, r0:r1])
                box_mine.append(bl[:, r0:r1])
            ids.append(torch.arange(off + r0 * w * a, off + r1 * w * a, device=images.device))
            off += rows * w * a
        ids = torch.cat(ids)
        total, aux = detection_loss_from_levels(
            cls_mine, box_mine, cls_t[:, ids], box_t[:, ids], state_t[:, ids], num_anchors=a,
            alpha=config.focal_alpha, gamma=config.focal_gamma, sigma=config.huber_sigma,
            normalizer=normalizer)
        aux["num_positives"] = positive.sum(dim=1).mean()
        return total, aux


def gather_anchor_major(cls_out, box_out, ctx: ParallelContext, batch: int, strides):
    """The serial heads' anchor-major outputs from each rank's: ``cls_out =
    (z (A, Mp, C), amax_img (B, A_total), hws)`` and ``box_out = (zb (Mp,
    A*4), hws)`` of the rank's rows of the levels of ``strides`` in, the
    same triple and pair of the whole image out (every rank gets all of it;
    ``z``'s rows unpadded)."""
    z, amax_img, hws = cls_out
    zb, _ = box_out
    a, _, ncls = z.shape
    lay = ctx.layout
    parts, dims, bounds = [], [], []
    row = col = 0
    for hw, stride in zip(hws, strides):
        w = lay.rows(stride)  # square images: a level's width is its height
        h = hw // w
        seg = (z[:, row:row + batch * hw].reshape(a, batch, h, w, ncls),
               amax_img[:, col:col + a * hw].reshape(batch, a, h, w),
               zb[row:row + batch * hw].reshape(batch, h, w, -1))
        if lay.banded(stride):
            r0, r1 = lay.band(stride)
            full = lay.rows(stride)
            for t, d in zip(seg, (2, 2, 1)):
                parts.append(t)
                dims.append(d)
                bounds.append((r0, r1, full))
        else:
            parts.extend(seg)
            dims.extend((None,) * 3)
            bounds.extend((None,) * 3)
        row += batch * hw
        col += a * hw
    todo = [i for i, d in enumerate(dims) if d is not None]
    got = C.gather_rows([parts[i] for i in todo], [dims[i] for i in todo],
                        [bounds[i] for i in todo], ctx.group)
    for i, t in zip(todo, got):
        parts[i] = t
    zs, ams, zbs, hws_full = [], [], [], []
    for lvl in range(len(hws)):
        zl, al, bl = parts[3 * lvl:3 * lvl + 3]
        hw_full = zl.shape[2] * zl.shape[3]
        zs.append(zl.reshape(a, batch * hw_full, ncls))
        ams.append(al.reshape(batch, a * hw_full))
        zbs.append(bl.reshape(batch * hw_full, -1))
        hws_full.append(hw_full)
    hws_full = tuple(hws_full)
    return (torch.cat(zs, 1), torch.cat(ams, 1), hws_full), (torch.cat(zbs, 0), hws_full)
