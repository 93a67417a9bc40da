"""Device ms a call in the ``postprocess`` range (``ops/nms.py``: decode,
selection and the NMS kernel)."""

from portbench.lib.readers import stage_ms


def read(bench):
    return stage_ms(bench, "postprocess")
