"""Percent of the card's bf16 peak (989 TFLOP/s) that the whole pass's
learned models reach: SuperPoint's operations per image at the detector's
padded size (perfbench/counts/superpoint.py) times the images detected,
plus LightGlue's on each pair's valid keypoints
(perfbench/counts/lightglue.py), over the traced window. A cell that
runs no learned matcher reads nothing."""

from perfbench.counts.lightglue import lightglue_flops
from perfbench.counts.superpoint import superpoint_flops
from perfbench.peaks import BF16_FLOPS


def read(ctx):
    valid = ctx["spans"].counters.get("lightglue_valid")
    window_s = ctx["device"].get("window_s")
    if not valid or not window_s:
        return None
    model = ctx["config"]["model"]
    flops = sum(float(lightglue_flops(n0.double(), n1.double(), model["lightglue_dim"], model["descriptor_dim"],
                                      model["lightglue_dim"] // model["lightglue_heads"],
                                      model["lightglue_layers"]).sum()) for n0, n1 in valid)
    H, W = ctx["detector_hw"]
    flops += superpoint_flops(-(-H // 8) * 8, -(-W // 8) * 8) * sum(ctx["spans"].units.get("detect", []))
    return 100.0 * flops / window_s / BF16_FLOPS
