"""Host spans of the program and device trace capture around a region.

Port of gtsfm_tpu/utils/tracing.py, and the port's one span recorder.

``span(name, units=0)`` marks a stage of the host's work. It records only
while a ``torch.profiler`` is recording in this process (the benchmark's
``--trace 1`` window, a ``device_trace`` capture, or an operator's own
profiler); otherwise it costs one check of the profiler's enabled flag and
allocates nothing. A record holds the span's name, its id, its parent's
and its root's ids (a span opened inside no other is a root), its start
and end on ``time.time_ns`` (the clock the profiler stamps its events
with), ``units`` (images or pairs, host integers) and ``minor_faults``, the
process's minor page faults (``getrusage``) from start to end. While
recording, a span also opens ``torch.profiler.record_function(name)``, so
that a profiler recording host activity carries it. Spans measure the
host: they never synchronize the device nor read a device tensor, so where
the host waits on the device inside a span the wait is part of its time.
Records stay in memory, at most ``MAX_SPANS`` of them (``dropped()``
counts the rest), until ``reset()``; ``spans()`` returns them.

``Span(name, units=0)`` is a span that also keeps its own duration in
``seconds`` (two ``perf_counter`` reads) whether or not it records: the
stage clocks of ``SceneOptimizer`` and ``utils.logger.StageTimer``.

With ``GTSFM_TPU_TRACE=<dir>`` set, ``device_trace(tag)`` records a
``torch.profiler`` trace of the region and writes it as a Chrome trace,
``<dir>/<tag>/trace.json``: the card's activity (kernels, copies and the
CUDA calls that launched them) when CUDA is available, else the CPU's
operators. Host operators are left out on a card: they more than double
the trace's size. The spans recorded during the capture go into the
Chrome trace too, as user annotations on the kernels' timeline, and are
written as ``<dir>/<tag>/spans.json``; the store is then reset. Without the
variable the region runs as it is. Captures do not nest: an inner region
runs untraced while an outer capture is live. ``SceneOptimizer.run`` wraps
itself in one.
"""

from __future__ import annotations

import contextlib
import json
import os
import resource
import threading
import time

from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 16
_ACTIVE = False


class _Recorder:
    """The process's span records and each thread's stack of open spans."""

    def __init__(self):
        self.records: list = []
        self.dropped = 0
        self.next_id = 0
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def open(self, name: str, units) -> dict:
        with self.lock:
            self.next_id += 1
            sid = self.next_id
        stack = self.stack()
        parent = stack[-1] if stack else None
        rec = {"name": name, "id": sid, "parent": parent["id"] if parent else None,
               "root": parent["root"] if parent else sid, "units": int(units),
               "start_ns": time.time_ns(), "end_ns": 0,
               "minor_faults": resource.getrusage(resource.RUSAGE_SELF).ru_minflt}
        stack.append(rec)
        return rec

    def close(self, rec: dict) -> None:
        rec["end_ns"] = time.time_ns()
        rec["minor_faults"] = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - rec["minor_faults"]
        stack = self.stack()
        if stack and stack[-1] is rec:
            stack.pop()
        with self.lock:
            if len(self.records) < MAX_SPANS:
                self.records.append(rec)
            else:
                self.dropped += 1


_RECORDER = _Recorder()


class Span:
    """A span that keeps its duration in ``seconds`` when it closes, even
    when it does not record."""

    __slots__ = ("name", "units", "seconds", "_t0", "_rec", "_rf")

    def __init__(self, name: str, units=0):
        self.name, self.units, self.seconds = name, units, 0.0
        self._rec = self._rf = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            import torch

            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            self._rec = _RECORDER.open(self.name, self.units)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._rec is not None:
            _RECORDER.close(self._rec)
            self._rf.__exit__(*exc)
            self._rec = self._rf = None
        return False


class _Off:
    """What ``span`` returns while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, units=0):
    """A span around a stage of the host's work, recorded only while a
    torch profiler records in this process."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, units)


def spans() -> list:
    """The closed spans recorded since the last ``reset``, as dicts."""
    with _RECORDER.lock:
        return list(_RECORDER.records)


def dropped() -> int:
    """Spans left out since the last ``reset``, past ``MAX_SPANS``."""
    return _RECORDER.dropped


def reset() -> None:
    with _RECORDER.lock:
        _RECORDER.records.clear()
        _RECORDER.dropped = 0


def _add_spans_to_chrome_trace(path: str, records: list) -> None:
    """The spans as user annotations in the exported Chrome trace, whose
    times are microseconds after its ``baseTimeNanoseconds``."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "user_annotation", "name": r["name"], "pid": pid, "tid": "program spans",
         "ts": (r["start_ns"] - base) / 1e3, "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
         "args": {"id": r["id"], "parent": r["parent"], "units": r["units"], "minor_faults": r["minor_faults"]}}
        for r in records)
    with open(path, "w") as f:
        json.dump(trace, f)


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
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
    _ACTIVE = True
    t0 = time.time_ns()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        _ACTIVE = False
    records = [r for r in spans() if r["start_ns"] >= t0]
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    if on_card:  # the profiler keeps user annotations only with the CPU's activity
        _add_spans_to_chrome_trace(os.path.join(path, "trace.json"), records)
    with open(os.path.join(path, "spans.json"), "w") as f:
        json.dump({"spans": records, "dropped": dropped()}, f)
    reset()
