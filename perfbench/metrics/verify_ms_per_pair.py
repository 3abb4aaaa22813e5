"""Milliseconds per pair of two-view verification: the synchronized span
around ``run_two_view_batch`` as the scene optimizer calls it, less the
mutual-NN matcher's span inside it."""


def read(ctx):
    spans = ctx["spans"]
    s, n = spans.seconds.get("two_view"), spans.units.get("two_view")
    if not s or not sum(n):
        return None
    return 1e3 * (sum(s) - sum(spans.seconds.get("mutual_nn", []))) / sum(n)
