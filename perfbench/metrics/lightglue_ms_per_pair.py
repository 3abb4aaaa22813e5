"""Milliseconds per pair of the learned matcher: the benchmark's span
around ``match_batch`` (a proxy matcher), synchronized at both ends."""


def read(ctx):
    s, n = ctx["spans"].seconds.get("lightglue"), ctx["spans"].units.get("lightglue")
    return 1e3 * sum(s) / sum(n) if s and sum(n) else None
