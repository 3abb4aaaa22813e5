"""Device milliseconds per pass of VGGT's frame blocks (attention within
each frame): the device time of the operations launched inside the
program's ``vggt.frame`` spans over the window's passes. None where the
program records no such span."""


def read(ctx):
    device_s = ctx["device"]["ranges"].get("vggt.frame")
    return 1e3 * device_s / ctx["passes"] if device_s and ctx["passes"] else None
