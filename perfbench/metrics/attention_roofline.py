"""Percent of the roofline of LightGlue's attention: the work of every
attention entry LightGlue called (perfbench/counts/attention.py, over the
valid keys) over the device time of every kernel the profiler shows
inside the benchmark's ``perfbench.attention`` ranges around those
entries, whatever kernels implement them."""

from perfbench.peaks import roofline_share


def read(ctx):
    work = ctx["work"].get("attention")
    device_s = ctx["device"]["ranges"].get("attention")
    return roofline_share(*work, device_s) if work and device_s else None
