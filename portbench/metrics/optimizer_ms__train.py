"""Device ms a step in the ``optimizer`` range (``train_lib.Optimizer``)."""

from portbench.lib.readers import stage_ms


def read(bench):
    return stage_ms(bench, "optimizer")
