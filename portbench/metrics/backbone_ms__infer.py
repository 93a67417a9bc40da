"""Device ms a call in the ``backbone`` range (``models/efficientnet.py``)."""

from portbench.lib.readers import stage_ms


def read(bench):
    return stage_ms(bench, "backbone")
