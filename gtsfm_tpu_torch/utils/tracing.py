"""Device trace capture around a region.

Port of gtsfm_tpu/utils/tracing.py. With ``GTSFM_TPU_TRACE=<dir>`` set,
``device_trace(tag)`` records a ``torch.profiler`` trace of the region and
writes it as a Chrome trace, ``<dir>/<tag>/trace.json``: the card's
activity (kernels, copies and the CUDA calls that launched them) when
CUDA is available, else the CPU's operators. Host operators are left out
on a card: they more than double the trace's size. Without the variable the region runs as it is.
Captures do not nest: an inner region runs untraced while an outer capture
is live. ``SceneOptimizer.run`` wraps itself in one.
"""

from __future__ import annotations

import contextlib
import os

_ACTIVE = False


@contextlib.contextmanager
def device_trace(tag: str):
    global _ACTIVE
    trace_dir = os.environ.get("GTSFM_TPU_TRACE")
    if not trace_dir or _ACTIVE:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(trace_dir, tag)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
    _ACTIVE = True
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        _ACTIVE = False
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
