"""The share of the traced stretch in which the device ran nothing, in %."""

from portbench.lib.readers import idle_pct


def read(bench):
    return idle_pct(bench)
