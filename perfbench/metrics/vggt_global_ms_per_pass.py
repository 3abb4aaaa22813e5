"""Device milliseconds per pass of VGGT's global blocks (attention over
every token of every frame): the device time of the operations launched
inside the program's ``vggt.global`` spans, both aggregator passes of a
pass, over the window's passes. None where the program records no such
span."""


def read(ctx):
    device_s = ctx["device"]["ranges"].get("vggt.global")
    return 1e3 * device_s / ctx["passes"] if device_s and ctx["passes"] else None
