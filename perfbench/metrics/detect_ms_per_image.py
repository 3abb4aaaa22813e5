"""Milliseconds of the detector's ``detect_batch`` per image: the
benchmark's span around each call (a proxy handed to the scene optimizer),
synchronized at its end, over the images it detected in the window."""


def read(ctx):
    s, n = ctx["spans"].seconds.get("detect"), ctx["spans"].units.get("detect")
    return 1e3 * sum(s) / sum(n) if s and sum(n) else None
