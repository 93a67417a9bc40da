"""The head and NMS kernels as ``torch.library`` custom ops, on the CPU.

``efficientdet_tpu_torch::head_pointwise`` and
``efficientdet_tpu_torch::nms_keep_mask`` run the kernels' plain versions on
CPU tensors; ``torch.library.opcheck`` holds their schemas, fake (shape)
implementations and dispatch. ``torch.export`` keeps each as one node, and
no training path calls them (they have no autograd formula).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.models.detector import init_weights
from efficientdet_tpu_torch.ops import head_kernel as hk
from efficientdet_tpu_torch.ops import nms_kernel as nk

OPS = torch.ops.efficientdet_tpu_torch


def _head_args(rows, cin, anchors, out, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, cin, generator=g).to(dtype)
    k = torch.randn(cin, anchors * out, generator=g) * 0.1
    b = torch.randn(anchors * out, generator=g)
    return x, k, b, anchors


def _nms_args(b, k, classes, seed=0):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(b, k, 2, generator=g) * 100
    boxes = torch.cat([xy, xy + 5 + torch.rand(b, k, 2, generator=g) * 40], -1)
    cls = torch.randint(0, classes, (b, k), generator=g).int()
    valid = torch.rand(b, k, generator=g) > 0.1
    return boxes, cls, valid


HEAD_CASES = [(700, 16, 9, 6, torch.float32), (512, 64, 9, 90, torch.bfloat16),
              (77, 24, 1, 36, torch.float32)]


@pytest.mark.parametrize("rows,cin,anchors,out,dtype", HEAD_CASES)
def test_head_op_on_the_cpu_is_the_plain_twin(rows, cin, anchors, out, dtype):
    args = _head_args(rows, cin, anchors, out, dtype)
    z, amax = OPS.head_pointwise(*args)
    wz, wamax, m = hk.head_pointwise_reference(*args)
    assert torch.equal(z, wz) and torch.equal(amax, wamax)
    got = hk.head_pointwise_anchor_major(*args)
    assert got[2] == m == rows and torch.equal(got[0], wz)


@pytest.mark.parametrize("b,k,classes,thr", [(2, 50, 3, 0.5), (3, 130, 1, 0.3), (1, 7, 2, -0.1)])
def test_nms_op_on_the_cpu_is_the_plain_twin(b, k, classes, thr):
    args = _nms_args(b, k, classes)
    want = nk.suppression_keep_mask_reference(*args, thr)
    assert torch.equal(OPS.nms_keep_mask(*args, thr), want)
    assert torch.equal(nk.suppression_keep_mask(*args, thr), want)


@pytest.mark.parametrize("rows,cin,anchors,out,dtype", HEAD_CASES)
def test_opcheck_head(rows, cin, anchors, out, dtype):
    torch.library.opcheck(OPS.head_pointwise.default, _head_args(rows, cin, anchors, out, dtype))


def test_opcheck_nms():
    torch.library.opcheck(OPS.nms_keep_mask.default, (*_nms_args(2, 50, 3), 0.5))


def test_the_cpu_wrappers_count_no_launch():
    before = (hk.head_pointwise_anchor_major.launches, nk.suppression_keep_mask.launches)
    hk.head_pointwise_anchor_major(*_head_args(64, 8, 9, 6, torch.float32))
    nk.suppression_keep_mask(*_nms_args(1, 20, 2))
    assert (hk.head_pointwise_anchor_major.launches, nk.suppression_keep_mask.launches) == before


def test_fake_shapes_pad_rows_to_the_row_tile():
    with torch.device("meta"):
        x, k, b, a = torch.empty(700, 16), torch.empty(16, 54), torch.empty(54), 9
        z, amax = OPS.head_pointwise(x, k, b, a)
        keep = OPS.nms_keep_mask(torch.empty(2, 30, 4), torch.empty(2, 30, dtype=torch.int32),
                                 torch.empty(2, 30, dtype=torch.bool), 0.5)
    assert z.shape == (9, 1024, 6) and amax.shape == (9, 1024)
    assert keep.shape == (2, 30) and keep.dtype == torch.bool


class _Both(torch.nn.Module):
    def forward(self, x, k, b, boxes, cls, valid):
        z, amax, _ = hk.head_pointwise_anchor_major(x, k, b, 9)
        return z, amax, nk.suppression_keep_mask(boxes, cls, valid, 0.5)


def test_export_keeps_each_op_as_one_node():
    args = (*_head_args(100, 16, 9, 6, torch.float32)[:3], *_nms_args(2, 40, 3))
    ep = torch.export.export(_Both(), args)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("efficientdet_tpu_torch.head_pointwise.default") == 1
    assert targets.count("efficientdet_tpu_torch.nms_keep_mask.default") == 1
    got = ep.module()(*args)
    want = _Both()(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


class _Record(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func))
        return func(*args, **(kwargs or {}))


def test_no_training_path_calls_the_ops():
    cfg = et.ModelConfig.for_phi(0, num_classes=4, image_size=128)
    cfg = dataclasses.replace(cfg, bifpn_width=16, bifpn_depth=2, head_depth=2)
    model = init_weights(et.EfficientDet(cfg), 0).train()
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 128, 128, 3).astype(np.float32))
    with _Record() as rec:
        cls, box = model(x)
        (cls.float().sum() + box.float().sum()).backward()
    assert any("convolution" in n for n in rec.names)
    assert not [n for n in rec.names if n.startswith("efficientdet_tpu_torch")]
