"""The card's peaks, from NVIDIA's H100 SXM data sheet (dense rates, 700 W),
as ``chip_smoke.py``'s ``bound`` uses them; the least time of a piece of
work is the larger of its bytes over the memory rate and its operations
over their peaks."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores


def least_seconds(nbytes: float, f32: float = 0.0, tf32: float = 0.0) -> float:
    """The least time of work that moves ``nbytes`` and computes the given
    operations of each kind."""
    return max(nbytes / HBM_BYTES_PER_S, f32 / F32_FLOPS + tf32 / TF32_FLOPS)
