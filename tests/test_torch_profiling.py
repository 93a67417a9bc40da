"""The port's profiling helpers (utils/profiling.py), on the CPU."""

import glob
import json
import os

import torch

from efficientdet_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_with_the_conv(tmp_path):
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    x = torch.randn(1, 3, 16, 16)
    with profiling.trace(str(tmp_path / "t")):
        conv(x)
    files = glob.glob(os.path.join(tmp_path, "t", "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(ev.get("name", "")) for ev in events)


def test_flops_estimate_of_one_conv():
    n, h, w, cin, cout, k = 2, 16, 12, 8, 24, 3
    conv = torch.nn.Conv2d(cin, cout, k, padding=1, bias=False)
    x = torch.randn(n, cin, h, w)
    assert profiling.flops_estimate(conv, x) == 2 * n * h * w * cin * cout * k * k


def test_flops_estimate_is_none_on_failure():
    def broken(x):
        raise RuntimeError("no")

    assert profiling.flops_estimate(broken, torch.zeros(1)) is None
