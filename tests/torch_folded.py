"""Scaffolding of the folded model's custom-op tests
(``test_torch_folded_ops.py``: each op against its twin and its contract;
``test_torch_folded_route.py``: the backbone's and the BiFPN's route through
the ops).

The ops are named as ``experiments/folded_ops.OPS`` names them. The CPU's
folded models, with weights drawn at 1 / fan-in
(:func:`random_folded_model`), and the calls of their forwards
(:func:`folded_calls`) are made once a process: callers read them and change
nothing.
"""

import contextlib
import dataclasses
import functools

import pytest
import torch

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.experiments import folded_ops as xf
from efficientdet_tpu_torch.models import bifpn, efficientnet
from efficientdet_tpu_torch.models.detector import EfficientDet

OPS = tuple(xf.OPS)  # "conv_epilogue", "depthwise_conv", "bifpn_node"
LIB = torch.ops.efficientdet_tpu_torch
SIZE = 128  # the CPU tests' image size
PHIS = (0, 4, "7x")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LAYOUTS = {"nhwc": torch.channels_last, "nchw": torch.contiguous_format}
# each op's calls in a folded forward with grad off: the epilogue finishes
# the stem, the expands and the projects (4 of them padded at every phi),
# the depthwise kernel one conv a block, the node op every BiFPN node (8 a
# layer over P3..P7, 10 over P3..P8)
CALLS_PER_FORWARD = {"conv_epilogue": {0: 32, 4: 63, "7x": 107},
                     "depthwise_conv": {0: 16, 4: 32, "7x": 55},
                     "bifpn_node": {0: 24, 4: 56, "7x": 80}}


def bifpn_size(phi) -> int:
    """The BiFPN's image size on the CPU: SIZE, or the least that halves
    down to its top level (D7x's P8: 256)."""
    return max(SIZE, 2 ** et.ModelConfig.for_phi(phi).max_level)


@functools.lru_cache(maxsize=None)
def random_folded_model(phi) -> EfficientDet:
    """D``phi`` built folded (every conv with a bias) at
    :func:`bifpn_size`, weights drawn at 1 / fan-in from seed ``phi`` (7
    for 7x)."""
    model = EfficientDet(et.ModelConfig.for_phi(phi, image_size=bifpn_size(phi)),
                         fuse_bn=True).eval()
    g = torch.Generator().manual_seed({0: 0, 4: 4, "7x": 7}[phi])
    with torch.no_grad():
        for _, p in model.named_parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 10
            p.copy_(torch.randn(p.shape, generator=g) * fan_in ** -0.5)
    return model


def cpu_images(batch: int, seed: int, dtype=torch.float32) -> torch.Tensor:
    """(B, 3, SIZE, SIZE) images laid out channels-last, as the detector's."""
    return xf.nhwc_images(batch, SIZE, dtype, torch.Generator().manual_seed(seed), "cpu")


@contextlib.contextmanager
def parents_route():
    """The depthwise convs on the parent's route: ATen's conv, the conv
    epilogue and ``torch.mean`` (the path a spatial band still takes)."""
    fn = efficientnet.depthwise_folds
    efficientnet.depthwise_folds = lambda conv, x: False
    try:
        yield
    finally:
        efficientnet.depthwise_folds = fn


@functools.lru_cache(maxsize=None)
def _built_folded_model(phi) -> EfficientDet:
    """D``phi`` built folded at :func:`bifpn_size`, its weights left as
    built: which calls a forward makes depends on the shapes alone."""
    return EfficientDet(et.ModelConfig.for_phi(phi, image_size=bifpn_size(phi)),
                        fuse_bn=True).eval()


def zero_taps(model: EfficientDet, batch: int = 1):
    """C3, C4, C5 of zeros at the model's size, channels-last, as the
    backbone hands them to the BiFPN."""
    size = model.config.image_size
    return [torch.zeros(batch, conv.weight.shape[1], size // 2 ** lvl, size // 2 ** lvl
                        ).contiguous(memory_format=torch.channels_last)
            for lvl, conv in zip((3, 4, 5), (model.bifpn.layer0.p3_in_conv,
                                             model.bifpn.layer0.p4_in_td_conv,
                                             model.bifpn.layer0.p5_in_td_conv))]


def _forward_calls(phi, grad_off: str = "inference_mode"):
    """The backbone on SIZE images, the BiFPN on taps at its own size."""
    model, images = _built_folded_model(phi), cpu_images(1, 1)  # built with grad on
    before = xf.counts()
    nodes = (bifpn.fuse.sum, bifpn.fuse.weighted)
    with xf.recording() as (calls, _), getattr(torch, grad_off)():
        model.backbone(images)
        model.bifpn(zero_taps(model))
    after = xf.counts()
    nodes = {"sum": bifpn.fuse.sum - nodes[0], "weighted": bifpn.fuse.weighted - nodes[1]}
    return calls, {k: after[k] - before[k] for k in after}, nodes


@functools.lru_cache(maxsize=None)
def folded_calls(phi, grad_off: str = "inference_mode"):
    """Every op's calls in one forward of D``phi``'s folded backbone and
    BiFPN on a batch of one with grad off (``torch.inference_mode`` or
    ``torch.no_grad``), the launch counters' change over it, and the nodes
    ``bifpn.fuse`` counted (``sum``, ``weighted``)."""
    return _forward_calls(phi, grad_off)


@functools.lru_cache(maxsize=None)
def b0_parents_route_calls():
    """Every epilogue call of a folded B0 forward whose depthwise convs also
    end in the epilogue (:func:`parents_route`)."""
    with parents_route():
        return _forward_calls(0)[0]["conv_epilogue"]


def slim(image_size: int = SIZE) -> et.ModelConfig:
    """D0 at ``image_size`` with the BiFPN and the heads cut to width 16,
    depth 2, and 4 classes."""
    cfg = et.ModelConfig.for_phi(0, num_classes=4, image_size=image_size)
    return dataclasses.replace(cfg, bifpn_width=16, bifpn_depth=2, head_depth=2)


def need_cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ with no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
