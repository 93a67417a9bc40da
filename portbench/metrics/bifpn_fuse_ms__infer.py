"""Stream ms a call in the port's ``bifpn.fuse`` spans (``models/bifpn.py``:
each BiFPN node's sum, plain or weighted, and its swish)."""

from portbench.lib.spans import span_ms


def read(bench):
    return span_ms(bench, "bifpn.fuse")
