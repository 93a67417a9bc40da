"""Stream ms a call in the port's ``bifpn.resample`` spans
(``models/bifpn.py``: each upsample and max-pool between the BiFPN's levels,
the first layer's pooled levels above P6 included)."""

from portbench.lib.spans import span_ms


def read(bench):
    return span_ms(bench, "bifpn.resample")
