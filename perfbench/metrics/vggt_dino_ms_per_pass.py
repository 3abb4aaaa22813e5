"""Device milliseconds per pass of VGGT's DINOv2 patch embed: the device
time of the operations launched inside the program's ``vggt.dino`` spans
over the window's passes. None where the program records no such span."""


def read(ctx):
    device_s = ctx["device"]["ranges"].get("vggt.dino")
    return 1e3 * device_s / ctx["passes"] if device_s and ctx["passes"] else None
