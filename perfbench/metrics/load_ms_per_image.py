"""Milliseconds per view of the loader's ``load_grayscale_batch`` (file
decoding, resizing, gray conversion and padding on the host): the
benchmark's span around each call, through a proxy of the loader."""


def read(ctx):
    s, n = ctx["spans"].seconds.get("load_images"), ctx["spans"].units.get("load_images")
    return 1e3 * sum(s) / sum(n) if s and sum(n) else None
