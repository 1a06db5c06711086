"""The table of peaks the roofline shares are taken against: one NVIDIA
H100 SXM (NVIDIA's data sheet; dense rates, without sparsity), at its
700 W power limit. A run prints the card's name and power limit beside
its numbers."""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                  "float16": 989e12, "fp8": 1979e12, "int8": 1979e12}


def bound_s(nbytes: float, ops: float, dtype: str = "float32") -> float:
    """The least time the chip could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate of their type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])
