"""Milliseconds per view of reading an image file (open, JPEG decode,
RGB conversion): the program's ``load.read`` spans (one per view, in the
loader's ``get_image``), read from ``gtsfm_tpu_torch.utils.tracing``,
which records them while the window's profiler runs. None where the
program records no such span."""


def read(ctx):
    from gtsfm_tpu_torch.utils import tracing

    spans = getattr(tracing, "spans", None)
    reads = [s for s in (spans() if spans else []) if s["name"] == "load.read"]
    units = sum(s["units"] for s in reads)
    if not units:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in reads) / units
