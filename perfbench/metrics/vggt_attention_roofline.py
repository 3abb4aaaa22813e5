"""Percent of the roofline of VGGT's frame and global attention at the
float32 peak (the configuration states float32): the work of every
``vggt.attention`` span of the window (perfbench/counts/vggt.py: 4 n D
operations per query token in sequences of n, q, k, v and the output
once) over the device time of every operation launched inside those
spans, whatever kernels implement them."""

from perfbench.peaks import FP32_FLOPS, roofline_share


def read(ctx):
    work = ctx["work"].get("vggt_attention")
    device_s = ctx["device"]["ranges"].get("vggt.attention")
    return roofline_share(*work, device_s, peak_flops=FP32_FLOPS) if work and device_s else None
