"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory bandwidth and the operations over the f32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S)
