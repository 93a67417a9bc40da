"""The whole call's share of the bf16 peak: the model's FLOPs
(``lib/flops.py``) over the traced stretch, in %."""

from portbench.lib.readers import mfu_pct


def read(bench):
    return mfu_pct(bench)
