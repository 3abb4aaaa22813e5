"""Minor page faults of the process per pass in the front end: the
``minor_faults`` (``getrusage``, end less start) of the program's
``load_detect`` and ``two_view`` spans, the roots of a pass's
load-and-detect and two-view stages: mostly first touches of host arrays
the allocator mapped anew. A kernel that counts no minor faults (gVisor's
reports 0) reads 0. None where the program records no such span."""


def read(ctx):
    from gtsfm_tpu_torch.utils import tracing

    spans = getattr(tracing, "spans", None)
    roots = [s for s in (spans() if spans else []) if s["name"] in ("load_detect", "two_view")]
    if not roots or not ctx["passes"]:
        return None
    return sum(s["minor_faults"] for s in roots) / ctx["passes"]
