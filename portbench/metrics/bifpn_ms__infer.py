"""Device ms a call in the ``bifpn`` range (``models/bifpn.py``)."""

from portbench.lib.readers import stage_ms


def read(bench):
    return stage_ms(bench, "bifpn")
