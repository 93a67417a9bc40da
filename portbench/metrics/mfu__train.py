"""The whole step's share of the float32 peak (CUDA cores, TF32 off): the
model's forward and backward FLOPs (``lib/flops.py``) over the traced
stretch, in %."""

from portbench.lib.readers import mfu_pct


def read(bench):
    return mfu_pct(bench)
