"""Scaffolding of the folded backbone's custom-op tests
(``test_torch_folded_ops.py``: each op against its twin and its contract;
``test_torch_folded_route.py``: the backbone's route through the ops).

The ops are named as ``experiments/folded_ops.OPS`` names them. The CPU's
folded backbones, with weights drawn at 1 / fan-in
(:func:`random_folded_backbone`), and the calls of their forwards
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
from efficientdet_tpu_torch.models import efficientnet
from efficientdet_tpu_torch.models.efficientnet import EfficientNet

OPS = tuple(xf.OPS)  # "conv_epilogue", "depthwise_conv"
LIB = torch.ops.efficientdet_tpu_torch
SIZE = 128  # the CPU tests' image size
PHIS = (0, 4, "7x")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LAYOUTS = {"nhwc": torch.channels_last, "nchw": torch.contiguous_format}
# each op's calls in a folded forward with grad off: the epilogue finishes
# the stem, the expands and the projects (4 of them padded at every phi),
# the depthwise kernel one conv a block
CALLS_PER_FORWARD = {"conv_epilogue": {0: 32, 4: 63, "7x": 107},
                     "depthwise_conv": {0: 16, 4: 32, "7x": 55}}


@functools.lru_cache(maxsize=None)
def random_folded_backbone(phi) -> EfficientNet:
    """B``phi``'s backbone built folded (every conv with a bias), weights
    drawn at 1 / fan-in from seed ``phi`` (7 for 7x)."""
    backbone = EfficientNet(et.ModelConfig.for_phi(phi).backbone, fuse_bn=True).eval()
    g = torch.Generator().manual_seed({0: 0, 4: 4, "7x": 7}[phi])
    with torch.no_grad():
        for _, p in backbone.named_parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 10
            p.copy_(torch.randn(p.shape, generator=g) * fan_in ** -0.5)
    return backbone


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
def _built_folded_backbone(phi) -> EfficientNet:
    """B``phi``'s backbone built folded, its weights left as built: which
    calls a forward makes depends on the shapes alone."""
    return EfficientNet(et.ModelConfig.for_phi(phi).backbone, fuse_bn=True).eval()


def _forward_calls(phi, grad_off: str = "inference_mode"):
    backbone, images = _built_folded_backbone(phi), cpu_images(1, 1)  # built with grad on
    before = xf.counts()
    with xf.recording() as (calls, _), getattr(torch, grad_off)():
        backbone(images)
    after = xf.counts()
    return calls, {k: after[k] - before[k] for k in after}


@functools.lru_cache(maxsize=None)
def folded_calls(phi, grad_off: str = "inference_mode"):
    """Every op's calls in one forward of B``phi``'s folded backbone on a
    batch of one with grad off (``torch.inference_mode`` or
    ``torch.no_grad``), and the launch counters' change over it."""
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
