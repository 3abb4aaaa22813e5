"""Percent of the card's float32 peak (67 TFLOP/s) that a VGGT pass's
counted model operations reach over the traced window: per pass both
aggregator passes, the camera and depth heads and the track head on the
pass's queries (perfbench/counts/vggt.py), summed over the window's
passes. A cell that runs no VGGT reads nothing."""

from perfbench.peaks import FP32_FLOPS


def read(ctx):
    work = ctx["work"].get("vggt_model")
    window_s = ctx["device"].get("window_s")
    return 100.0 * work[0] / window_s / FP32_FLOPS if work and window_s else None
