"""Subpackage of efficientdet_tpu_torch."""
