"""Shared set-up of the benchmark's own tests: cells cut to a size the CPU
runs in seconds, driven with the kernels' plain versions.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import argparse
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each cell at a CPU size: D0 at 128 px, D4 at 256 px, batches of one or two,
# the port in float32 so that it agrees with the reference to rounding
TINY = {
    "d0-b128": dict(batch=2, ring=2, precision="f32", check_images=3, check_block=2,
                    trace_start_call=1, trace_calls=2, warmup_calls=1),
    "d4-b64": dict(batch=1, ring=2, precision="f32", check_images=2, check_block=1,
                   trace_start_call=1, trace_calls=1, warmup_calls=1),
    "d0-train": dict(batch=2, ring=4, check_steps=3, warmup_steps=1, trace_start_step=0,
                     trace_steps=1),
}


@pytest.fixture
def tiny():
    """``tiny(name, trace=0, seconds=1.0, **params)`` -> (cell, args) for a
    CPU run of ``name`` through ``run.measure(cell, args, device="cpu")``."""
    import torch

    from portbench.lib.bench import Cell

    torch.set_num_threads(2)

    def make(name, trace=0, seconds=1.0, seed=2 ** 31 + 77, **params):
        cell = Cell(ROOT, name)
        cell.config["image_size"] = 128 if cell.config["phi"] == 0 else 256
        cell.workload["params"].update(TINY[name], **params)
        args = argparse.Namespace(workload=name, seed=seed, seconds=seconds, trace=trace)
        return cell, args

    return make


@pytest.fixture
def card():
    """Skips a test that needs a CUDA device where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
