"""Stream ms a step in the port's ``loss.targets`` span (``anchors.py``: the
anchor targets, forward only)."""

from portbench.lib.spans import span_ms


def read(bench):
    return span_ms(bench, "loss.targets")
