"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics read.

The profiler records the device's activity alone (kernels, copies, sets,
and the runtime calls that launched them), which costs the host far less
than recording every operator; the benchmark's ranges are host intervals
it keeps itself on the same clock (``time.time_ns``). From these:

- the device's busy time: the union of the device operations' intervals
  inside the window;
- each range's device time: the operations whose launching call fell
  inside one of the range's intervals (matched by correlation id);
- the breakdown the result line carries: the device operations that took
  most time, and the longest idle gaps, each named by the innermost range
  the host was in at its middle ("host" where it was in none).
"""

from __future__ import annotations

import bisect

import torch

TOP = 10


class _Intervals:
    """Intervals of one range name, sorted by start (nested ones of the
    same name are not expected)."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [s for s, _ in spans]
        self.ends = [e for _, e in spans]

    def find(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        return self.starts[i] if i >= 0 and self.ends[i] >= t else None


def reduce(prof, ranges: list, window: tuple) -> dict:
    """``ranges``: [(name, start_ns, end_ns)]; ``window``: (start_ns,
    end_ns). -> {"busy_s", "window_s", "ranges": {name: device seconds},
    "device_ops": [[name, s]], "idle_gaps": [[name, s]]}."""
    w0, w1 = window
    launches, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id()))
        elif e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    by_name = {}
    for name, s, e in ranges:
        by_name.setdefault(name, []).append((s, e))
    host = {n: _Intervals(s) for n, s in by_name.items()}

    def innermost(t):
        inside = [(iv.find(t), n) for n, iv in host.items() if iv.find(t) is not None]
        return max(inside)[1] if inside else "host"

    by_range, totals = {}, {}
    for s, e, name, corr in ops:
        totals[name] = totals.get(name, 0) + (e - s)
        t = launches.get(corr)
        if t is None:
            continue
        for n, iv in host.items():
            if iv.find(t) is not None:
                by_range[n] = by_range.get(n, 0) + (e - s)
    ops.sort(key=lambda o: o[0])
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _n, _c in ops:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if cur_e is None:
            if s > w0:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    top_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "busy_s": busy * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "ranges": {k: v * 1e-9 for k, v in by_range.items()},
        "device_ops": [[n[:120], v * 1e-9] for n, v in top_ops],
        "idle_gaps": [[innermost((s + e) // 2), (e - s) * 1e-9] for s, e in top_gaps],
    }
