"""Milliseconds per pass of the feed-forward slot's post-BA: the host time
of the program's ``feedforward.ba`` spans (the bundle adjustment of the
tracks, ending in its host copies) over the window's passes. None where
the program records no such span."""


def read(ctx):
    from gtsfm_tpu_torch.utils import tracing

    spans = getattr(tracing, "spans", None)
    ba = [s for s in (spans() if spans else []) if s["name"] == "feedforward.ba"]
    if not ba or not ctx["passes"]:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in ba) / ctx["passes"]
