"""Device ms a call in the ``preprocess`` range (``ops/preprocess.py``:
the uint8 batch normalised)."""

from portbench.lib.readers import stage_ms


def read(bench):
    return stage_ms(bench, "preprocess")
