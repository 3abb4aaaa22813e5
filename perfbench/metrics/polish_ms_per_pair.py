"""Milliseconds per pair of the verifier's Gauss-Newton polish: the
program's ``ransac.polish`` spans (RANSAC's two polish rounds with their
keep-best) and ``verify.refine`` spans (the two-view refinement after
RANSAC), over the pairs of its ``verify`` spans. Host time, as
ransac_ms_per_pair. None where the program records no such span."""


def read(ctx):
    from gtsfm_tpu_torch.utils import tracing

    spans = getattr(tracing, "spans", None)
    records = spans() if spans else []
    pairs = sum(s["units"] for s in records if s["name"] == "verify")
    if not pairs:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in records
                      if s["name"] in ("ransac.polish", "verify.refine")) / pairs
