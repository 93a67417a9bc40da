"""Stream ms a step in the port's ``loss.focal`` spans (``losses.py``: each
level's focal term, forward and ``_FocalSum.backward``)."""

from portbench.lib.spans import span_ms


def read(bench):
    return span_ms(bench, "loss.focal")
