"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W
power limit): HBM3 bandwidth and float32 arithmetic outside the tensor
cores. Every roofline share is stated against these, with the card's power
limit beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_s(bytes_: float, flops: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
