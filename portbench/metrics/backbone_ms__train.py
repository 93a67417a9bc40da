"""Device ms a step in the ``backbone`` range, forward and backward."""

from portbench.lib.readers import stage_ms


def read(bench):
    return stage_ms(bench, "backbone")
