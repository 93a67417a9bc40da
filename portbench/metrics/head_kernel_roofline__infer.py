"""The head kernel (``csrc/head_pointwise.cu``, class and box launches) at
its roofline: the least time the configuration's shapes allow
(``lib/roofline.head_kernel``) over its device time, in %."""

from portbench.lib.readers import roofline_pct


def read(bench):
    return roofline_pct(bench, r"head_pw", "head_bound")
