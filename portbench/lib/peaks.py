"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): every roofline and MFU divides by these."""

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {
    "bf16": 989e12,  # tensor cores
    "f32": 67e12,  # CUDA cores: float32 with TF32 off
}


def bound_s(nbytes: float, ops: float, precision: str):
    """(seconds, "bytes" or "operations"): the least time the chip could
    take, the larger of ``nbytes`` at the memory rate and ``ops`` at the
    precision's peak."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_FLOPS[precision]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
