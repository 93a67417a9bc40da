"""Device ms a call in the ``heads`` range (``models/heads.py``: the towers
and the head kernel)."""

from portbench.lib.readers import stage_ms


def read(bench):
    return stage_ms(bench, "heads")
