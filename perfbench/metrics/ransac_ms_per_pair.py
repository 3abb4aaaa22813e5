"""Milliseconds per pair of the verifier's RANSAC: the program's
``verify.draw`` and ``verify.ransac`` spans less ``ransac.polish`` inside
them (the minimal-set draws, the 8-point hypotheses, the preemptive
scoring, the dual-start LO and pose recovery), over the pairs of its
``verify`` spans (``run_two_view_batch``). Host time: the spans do not
synchronize, so device work shows only where the host waits on it. None
where the program records no such span."""


def read(ctx):
    from gtsfm_tpu_torch.utils import tracing

    spans = getattr(tracing, "spans", None)
    records = spans() if spans else []
    pairs = sum(s["units"] for s in records if s["name"] == "verify")
    if not pairs:
        return None
    sign = {"verify.draw": 1, "verify.ransac": 1, "ransac.polish": -1}
    return 1e-6 * sum(sign[s["name"]] * (s["end_ns"] - s["start_ns"]) for s in records if s["name"] in sign) / pairs
