"""Percent of the traced window in which no operation ran on the card:
one minus the union of the profiler's device intervals (kernels, copies,
sets) over the window's length."""


def read(ctx):
    dev = ctx["device"]
    if not dev.get("window_s"):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
