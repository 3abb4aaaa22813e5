"""Device milliseconds per pass of VGGT's heads: the device time of the
operations launched inside the program's ``vggt.camera_head``,
``vggt.depth_head`` and ``vggt.track_head`` spans over the window's
passes. None where the program records none of them."""

HEADS = ("vggt.camera_head", "vggt.depth_head", "vggt.track_head")


def read(ctx):
    device_s = sum(ctx["device"]["ranges"].get(name, 0.0) for name in HEADS)
    return 1e3 * device_s / ctx["passes"] if device_s and ctx["passes"] else None
