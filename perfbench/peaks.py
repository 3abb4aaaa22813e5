"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A share of a peak
is stated against these, with the card's power limit beside it."""

BF16_FLOPS = 989e12  # bf16 / fp16 tensor cores
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # bytes per second


def roofline_share(flops: float, nbytes: float, device_s: float, peak_flops: float = BF16_FLOPS):
    """Percent of the roofline: the least time the chip could take (the
    larger of operations over the peak rate and bytes over the memory
    bandwidth) over the measured device time; None without a time."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * max(flops / peak_flops, nbytes / HBM_BYTES) / device_s
