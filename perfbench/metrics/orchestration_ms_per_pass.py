"""Milliseconds per pass of the scene optimizer's own host work in the
front end: the self time (duration less what its child spans cover) of
the program's ``load_detect``, ``detect``, ``two_view`` and
``two_view.chunk`` spans, with ``two_view.upload`` counted in the self
time of ``two_view``: the image upload, the detector's border loop and
concatenations, the keypoint upload, each chunk's gathers. None where the
program records no such span."""

OWN = ("load_detect", "detect", "two_view", "two_view.chunk")


def read(ctx):
    from gtsfm_tpu_torch.utils import tracing

    spans = getattr(tracing, "spans", None)
    records = spans() if spans else []
    own = [s for s in records if s["name"] in OWN]
    if not own or not ctx["passes"]:
        return None
    covered = {}
    for s in records:
        if s["parent"] is not None and s["name"] != "two_view.upload":
            covered[s["parent"]] = covered.get(s["parent"], 0) + s["end_ns"] - s["start_ns"]
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] - covered.get(s["id"], 0) for s in own) / ctx["passes"]
