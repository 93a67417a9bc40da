"""The benchmark's arithmetic on the CPU: the stage table and idle share of
a synthetic trace, the rooflines' bytes and operations and the model FLOP
count against hand-worked D0 numbers, and the detection and training
numbers that decide ``correct``."""

from __future__ import annotations

import math

import pytest

from portbench.lib import flops, peaks, roofline
from portbench.lib.compare import DetectionGaps, training_numbers
from portbench.lib.trace import Trace
from portbench.reference.config import config_for


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def synthetic_trace():
    """Two calls: each a ``backbone`` range launching a 30 us kernel and a
    ``heads/...`` range launching the head kernel (10 us); the second call's
    backward on autograd's thread (tid 2) launches a 20 us kernel for the
    forward op of sequence number 7, which ran in ``backbone``."""
    ev = []
    for call, base in enumerate((0.0, 100.0)):
        ev.append(_x("backbone", "user_annotation", base, 40))
        ev.append(_x("aten::conv", "cpu_op", base + 1, 30, **({"Sequence number": 7} if call else {})))
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", base + 2, 2, correlation=10 + call))
        ev.append(_x("conv_kernel", "kernel", base + 5, 30, tid=7, correlation=10 + call))
        ev.append(_x("heads/class_net+box_net", "user_annotation", base + 41, 20))
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", base + 42, 2, correlation=20 + call))
        ev.append(_x("void head_pw_resident_kernel<8>(bf16 const*)", "kernel", base + 45, 10,
                     tid=7, correlation=20 + call))
    ev.append(_x("autograd::engine::evaluate_function: ConvBackward", "cpu_op", 158, 40, tid=2,
                 **{"Sequence number": 7}))
    ev.append(_x("cudaLaunchKernel", "cuda_runtime", 171, 2, tid=2, correlation=30))
    ev.append(_x("wgrad_kernel", "kernel", 175, 20, tid=7, correlation=30))
    return ev


def test_stage_table_busy_and_idle_of_a_synthetic_trace():
    t = Trace(synthetic_trace(), calls=2, window_s=300e-6)
    assert t.stage_ms == pytest.approx({"backbone": 0.030, "heads": 0.010,
                                        "backbone backward": 0.010})
    assert t.busy_s == pytest.approx(100e-6)
    assert t.kernel_ms_per_call(r"head_pw") == pytest.approx(0.010)
    assert t.kernel_ms_per_call(r"nms_suppress") is None
    from portbench.lib.readers import idle_pct, stage_ms

    bench = type("B", (), {"trace": t, "extra": {}})()
    assert stage_ms(bench, "backbone") == pytest.approx(0.040)
    assert idle_pct(bench) == pytest.approx(100.0 * (1 - 100 / 300))
    assert t.top_device_ops[0] == ["conv_kernel", pytest.approx(60e-6)]
    # the gap before the backward kernel: autograd's thread was in evaluate_function
    names = dict((n, s) for n, s in t.idle_gaps)
    assert names["autograd::engine::evaluate_function: ConvBackward"] == pytest.approx(20e-6)


def test_head_kernel_bytes_and_operations_at_d0_b128():
    cfg = config_for(0)
    m = 128 * (64 ** 2 + 32 ** 2 + 16 ** 2 + 8 ** 2 + 4 ** 2)
    assert roofline.head_rows(cfg, 128) == m == 698_368
    cls = m * 64 * 2 + 64 * 810 * 2 + 810 * 4 + 9 * m * 90 * 2 + 9 * m * 2
    box = m * 64 * 2 + 64 * 36 * 2 + 36 * 4 + 9 * m * 4 * 2
    nbytes, ops = roofline.head_kernel(cfg, 128)
    assert nbytes == cls + box == 1_373_103_160
    assert ops == 2.0 * m * 64 * (810 + 36)
    t, by = peaks.bound_s(nbytes, ops, "bf16")
    assert by == "bytes" and t * 1e3 == pytest.approx(0.40988, abs=1e-5)


def test_nms_kernel_bytes_and_operations():
    nbytes, ops = roofline.nms_kernel(128, 1024, same_class_pairs=1000.0)
    assert nbytes == 128 * 1024 * 22
    assert ops == 128 * 1024 * 1023 / 2 + 1000.0 * roofline.NMS_OPS_PER_PAIR
    assert peaks.bound_s(nbytes, ops, "f32")[1] == "operations"


def test_model_flops_at_d0():
    calls = flops.conv_flops(config_for(0), 1)
    # the stem: 3 -> 32 channels, 3x3, stride 2, 512 -> 256 px
    assert calls[0] == (2 * 256 * 256 * 32 * 3 * 9, True)
    # the class head's final pointwise on P3: 64 -> 9 x 90 channels over 64 x 64 px
    assert 2 * 64 * 64 * 64 * 810 in [f for f, _ in calls]
    total = flops.inference_flops(config_for(0), 1)
    assert total == pytest.approx(4.98466304e9)  # the paper's 2.5 B multiply-adds (Table 1)
    assert flops.inference_flops(config_for(0), 128) == pytest.approx(128 * total)
    stem = calls[0][0]
    assert flops.training_flops(config_for(0), 1) == pytest.approx(3 * total - stem)


def _own(ref_boxes, ref_logits, anchors, classes):
    """The reference's own detections at ``anchors`` of ``classes``."""
    import torch

    a, c = torch.tensor(anchors), torch.tensor(classes)
    return ref_boxes[a], ref_logits[a, c].double(), c


def test_detection_gaps_of_a_shifted_answer():
    import torch

    ref_boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0], [20.0, 20.0, 40.0, 40.0]])
    ref_logits = torch.tensor([[-1.0, -3.0], [-2.0, -0.5]])
    own = _own(ref_boxes, ref_logits, [1, 0], [1, 0])
    g = DetectionGaps()
    g.add(ref_boxes[[1, 0]] + torch.tensor([0.0, 0.0, 0.0, 0.25]),
          torch.sigmoid(torch.tensor([-0.5, -1.1])), torch.tensor([1, 0]),
          ref_boxes, ref_logits, own)
    n = g.numbers()
    assert n["box_rel"] == pytest.approx(0.025)  # 0.25 px of a 10 px box
    assert n["logit_gap"] == pytest.approx(0.1, abs=1e-6)
    assert n["missed"] == 0.0
    assert not g.bad
    # the wrong class at the second anchor: its logit is the other class's
    g.add(ref_boxes[1:], torch.sigmoid(torch.tensor([-0.5])), torch.tensor([0]),
          ref_boxes, ref_logits, own)
    assert g.numbers()["logit_gap"] == pytest.approx(1.5, abs=1e-6)


def test_missed_reads_what_the_selection_left_out_above_what_it_kept():
    import torch

    from portbench.reference.config import Eval

    ev = Eval(max_detections=2)
    # anchors 0 and 1 overlap (IoU 0.82), anchor 2 stands apart; one class
    ref_boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0], [1.0, 0.0, 11.0, 10.0],
                              [50.0, 50.0, 60.0, 60.0], [80.0, 80.0, 90.0, 90.0]])
    ref_logits = torch.tensor([[-1.0], [-1.2], [-2.0], [-3.0]])
    own = _own(ref_boxes, ref_logits, [0, 2], [0, 0])  # greedy NMS: 0 suppresses 1

    def missed(anchors, logits):
        g = DetectionGaps()
        g.add(ref_boxes[anchors], torch.sigmoid(torch.tensor(logits)),
              torch.zeros(len(anchors), dtype=torch.long), ref_boxes, ref_logits, own, ev)
        return g.numbers()["missed"]

    assert missed([0, 2], [-1.0, -2.0]) == 0.0
    # the lower box of the overlapping pair kept: anchor 0 lies 0.2 above its cover
    assert missed([1, 2], [-1.2, -2.0]) == pytest.approx(0.2, abs=1e-6)
    # anchor 2 left out for one that scores lower: 1.0 above the port's cut
    assert missed([0, 3], [-1.0, -3.0]) == pytest.approx(1.0, abs=1e-6)
    # a short list is cut at the score threshold, which anchor 2 clears
    assert missed([0], [-1.0]) == pytest.approx(-2.0 - math.log(0.01 / 0.99), abs=1e-6)


def test_detection_faults():
    import torch

    ref_boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0], [1.0, 0.0, 11.0, 10.0]])
    ref_logits = torch.zeros((2, 2))
    own = _own(ref_boxes, ref_logits, [0, 1], [0, 1])
    g = DetectionGaps()
    g.add(ref_boxes[:0], torch.zeros(0), torch.zeros(0, dtype=torch.long), ref_boxes, ref_logits,
          own)
    assert g.bad == ["0 detections where the reference keeps 2"]
    g = DetectionGaps()  # two boxes of one class at IoU 0.82: NMS keeps one of them
    g.add(ref_boxes, torch.tensor([0.5, 0.4]), torch.tensor([1, 1]), ref_boxes, ref_logits, own)
    assert g.bad and "overlap" in g.bad[0]


def test_training_numbers_leave_out_leaves_with_no_gradient():
    ref = {"losses": [2.0, 1.5], "grad_norm": {"a": 1.0, "b": 2.0, "bias": 1e-9},
           "change_norm": {"a": 0.1, "b": 0.1, "bias": 0.1}}
    port = {"losses": [2.0, 1.5 * 1.001], "grad_norm": {"a": 1.01, "b": 2.0, "bias": 0.0},
            "change_norm": {"a": 0.1, "b": 0.1, "bias": 0.0}}
    n = training_numbers(port, ref)
    assert n["loss_rel"] == pytest.approx(1e-3)
    assert n["grad_leaf"] == pytest.approx(0.01)  # over the median leaf's norm, 1.0
    assert n["change_leaf"] == 0.0  # "bias" moved by round-off alone, left out
    still = dict(port, change_norm={"a": 0.0, "b": 0.0, "bias": 0.0})
    assert training_numbers(still, ref)["change_leaf"] == pytest.approx(1.0)
    assert math.isfinite(n["loss_rel_step1"])
