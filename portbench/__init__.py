"""The benchmark of ``efficientdet_tpu_torch`` on NVIDIA H100s (``run.py``)."""
