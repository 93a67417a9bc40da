"""The benchmark's frozen plain reference of EfficientDet D0-D7.

A copy of the port's plain modules as they stood when the benchmark was
written, with the plain versions in place of its CUDA kernels: the anchor
major head and its pointwise kernel become the heads' ordinary final
convolution over the concatenated (B, A, C) logits, and the NMS kernel the
fixpoint suppression. float32; the callers set TF32 off. It imports nothing
of ``jax``, ``efficientdet_tpu`` or ``efficientdet_tpu_torch``, and takes
nothing that the port made: it is built from the benchmark's own weights.

``quant``: a callable applied to every convolution's input and weight and
to the heads' outputs, the hook through which the lower-precision control
runs this same code (``portbench/lib/precision.py``).
"""
