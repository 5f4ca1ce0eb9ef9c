"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the yardstick of every roofline
and peak share the benchmark reports.  The card's own power limit is
printed beside them in every run."""

BYTES_PER_S = 3.35e12     # HBM3
F32_FLOPS = 67e12         # float32 outside the tensor cores
BF16_FLOPS = 989e12       # bf16 on the tensor cores, dense


def bound_s(flops: float, nbytes: float, peak_flops: float = F32_FLOPS):
    """The least time the card could take for this work."""
    return max(flops / peak_flops, nbytes / BYTES_PER_S)
