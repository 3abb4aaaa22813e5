"""Percent of the roofline of the mutual-NN matcher as the two-view batch
calls it: the work of the valid keypoints' similarity
(perfbench/counts/mutual_nn.py) over the device time of every kernel
inside the benchmark's ``perfbench.mutual_nn`` ranges."""

from perfbench.peaks import roofline_share


def read(ctx):
    work = ctx["work"].get("mutual_nn")
    device_s = ctx["device"]["ranges"].get("mutual_nn")
    return roofline_share(*work, device_s) if work and device_s else None
