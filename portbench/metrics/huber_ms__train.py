"""Stream ms a step in the port's ``loss.huber`` spans (``losses.py``: each
level's Huber term and its masked sum, forward and backward)."""

from portbench.lib.spans import span_ms


def read(bench):
    return span_ms(bench, "loss.huber")
