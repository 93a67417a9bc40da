"""The NMS kernel (``csrc/nms_suppress.cu``) at its roofline: the least
time of its candidates' pairs (``lib/roofline.nms_kernel``) over its
device time, in %."""

from portbench.lib.readers import roofline_pct


def read(bench):
    return roofline_pct(bench, r"nms_suppress", "nms_bound")
