"""Device ms a step in the ``loss`` range (``anchors.py`` targets,
``losses.py``), forward and backward."""

from portbench.lib.readers import stage_ms


def read(bench):
    return stage_ms(bench, "loss")
