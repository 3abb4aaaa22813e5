"""The port's span recorder (gtsfm_tpu_torch/utils/tracing.py) and the
benchmark's readers of its spans (perfbench/metrics/), on the CPU.

- Without a profiler ``span`` records nothing and hands back one shared
  object; ``Span`` still keeps its duration.
- Under a CPU ``torch.profiler`` spans nest with their parent's and root's
  ids, units and self time, count the minor page faults of a 64 MB
  allocation, and start within 1 ms of the profiler's own event for them.
- ``StageTimer`` timings are spans; records past ``MAX_SPANS`` are counted
  as dropped.
- A tiny front-end pass through ``SceneOptimizer``'s stage methods (the
  benchmark's small CPU overrides) records every span whose stage runs.
- Each reader returns the hand-computed value on recorded spans and None
  on an empty store.
- ``device_trace`` writes ``spans.json`` beside ``trace.json``.
"""

import importlib
import json
import os
import tempfile
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gtsfm_tpu_torch.utils import tracing
from gtsfm_tpu_torch.utils.logger import StageTimer
from tests.torch_threads import cap_threads

cap_threads()

MS = 1_000_000


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.reset()
    yield
    tracing.reset()


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def test_span_records_nothing_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    with tracing.span("outer", 3):
        with tracing.span("inner"):
            time.sleep(0.002)
    assert tracing.span("a") is tracing.span("b")  # the shared no-op: nothing allocated
    with tracing.Span("stage") as clock:
        time.sleep(0.002)
    assert clock.seconds >= 0.002
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_spans_nest_with_ids_units_self_time_and_faults():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", 5):
            time.sleep(0.01)
            with tracing.span("inner", 2):
                time.sleep(0.01)
            with tracing.span("alloc"):
                a = np.ones(64 << 20, np.uint8)
            with tracing.span("empty"):
                pass
        with tracing.span("second_root", 7):
            pass
    del a
    recs = _by_name(tracing.spans())
    outer, inner, alloc, empty = (recs[n][0] for n in ("outer", "inner", "alloc", "empty"))
    second = recs["second_root"][0]
    assert outer["parent"] is None and outer["root"] == outer["id"]
    assert inner["parent"] == alloc["parent"] == empty["parent"] == outer["id"]
    assert inner["root"] == alloc["root"] == outer["id"]
    assert second["parent"] is None and second["root"] == second["id"] != outer["id"]
    assert (outer["units"], inner["units"], alloc["units"], second["units"]) == (5, 2, 0, 7)
    dur = {n: r["end_ns"] - r["start_ns"] for n, r in (("outer", outer), ("inner", inner), ("alloc", alloc),
                                                        ("empty", empty))}
    assert outer["start_ns"] <= inner["start_ns"] and inner["end_ns"] <= alloc["start_ns"]
    assert alloc["end_ns"] <= outer["end_ns"]
    self_ns = dur["outer"] - dur["inner"] - dur["alloc"] - dur["empty"]
    assert 10 * MS <= self_ns < dur["outer"] and dur["inner"] >= 10 * MS
    # 64 MB of fresh pages: 16,384 faults at 4 KiB, 32 even with 2 MiB pages
    assert alloc["minor_faults"] >= 32 and alloc["minor_faults"] > empty["minor_faults"]


def test_span_start_shares_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("warm"):
            pass
        with tracing.span("clock"):
            torch.ones(8).sum()
    rec = _by_name(tracing.spans())["clock"][0]
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock"]
    assert len(events) == 1 and events[0].is_user_annotation()
    assert abs(events[0].start_ns() - rec["start_ns"]) < 1 * MS


def test_stage_timer_timings_are_spans():
    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with timer.time("load"):
                time.sleep(0.001)
    recs = _by_name(tracing.spans())["load"]
    assert len(recs) == 2
    assert timer.timings["load"] == pytest.approx(sum(r["end_ns"] - r["start_ns"] for r in recs) * 1e-9, abs=1e-3)


def test_spans_past_the_bound_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("a", "b", "c"):
            with tracing.span(name):
                pass
    assert [r["name"] for r in tracing.spans()] == ["a", "b"] and tracing.dropped() == 1
    tracing.reset()
    assert tracing.spans() == [] and tracing.dropped() == 0


FRONT_END_SPANS = {"load", "load.read", "load.gray", "load.pad", "load_detect", "load_detect.upload", "detect",
                   "detect.net", "global_descriptor", "two_view", "two_view.upload", "two_view.chunk", "match",
                   "verify", "verify.draw", "verify.ransac", "ransac.hypotheses", "ransac.score", "ransac.lo",
                   "ransac.pose", "ransac.polish", "verify.refine"}


def test_front_end_pass_records_every_span():
    from perfbench import adapter, run, scene, weights
    from perfbench.tests.test_perfbench_harness import CELL, TINY_CONFIG, TINY_TRAFFIC

    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _cell, config, traffic, _w = run.cell_files(bench, CELL)
    traffic = {**traffic, **TINY_TRAFFIC}
    with tempfile.TemporaryDirectory() as work:
        views = scene.render(traffic, 11, "cpu")
        scene.write_olsson(os.path.join(work, "scene"), views)
        paths = weights.write(config, 11, os.path.join(work, "weights"), "cpu")
        fe = adapter.FrontEnd(config, paths, os.path.join(work, "scene"), traffic["max_resolution"], "cpu",
                              adapter.Spans(), -1, TINY_CONFIG)
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                out = fe.run_pass(5)
        finally:
            fe.close()
    recs = tracing.spans()
    names = _by_name(recs)
    assert set(names) == FRONT_END_SPANS  # no mutual-NN (LightGlue matches) and no degeneracy checks
    (ld,), (tv,) = names["load_detect"], names["two_view"]
    n_views = TINY_TRAFFIC["views"]
    assert ld["parent"] is None and ld["units"] == n_views and tv["parent"] is None
    assert sum(r["units"] for r in names["verify"]) == len(out.pairs) == tv["units"]
    assert sum(r["units"] for r in names["load.read"]) == n_views == names["load"][0]["units"]
    assert len(names["two_view.chunk"]) == -(-len(out.pairs) // TINY_CONFIG["scene_optimizer.pair_batch_size"])
    # every span of one stage call shares its root
    for r in recs:
        assert r["root"] == (ld["id"] if ld["start_ns"] <= r["start_ns"] <= ld["end_ns"] else tv["id"])
    children = {r["parent"] for r in recs}
    assert {ld["id"], tv["id"]} <= children


def _records(tree):
    """Records from nested (name, start_ms, end_ms, units, faults,
    children) tuples."""
    out, ids = [], iter(range(1, 1000))

    def walk(node, parent, root):
        name, s, e, units, faults, kids = node
        sid = next(ids)
        out.append({"name": name, "id": sid, "parent": parent, "root": root or sid, "start_ns": s * MS,
                    "end_ns": e * MS, "units": units, "minor_faults": faults})
        for k in kids:
            walk(k, sid, root or sid)

    for node in tree:
        walk(node, None, None)
    return out


PASS = [
    ("load_detect", 0, 100, 4, 1000, [
        ("load", 0, 40, 4, 600, [("load.read", 5 * i, 5 * i + 5, 1, 10, []) for i in range(4)]),
        ("load_detect.upload", 40, 45, 4, 0, []),
        ("detect", 45, 90, 4, 300, [("detect.net", 50, 80, 4, 5, [])]),
    ]),
    ("two_view", 200, 500, 10, 500, [
        ("two_view.upload", 200, 210, 0, 50, []),
        ("two_view.chunk", 210, 490, 10, 400, [
            ("match", 210, 250, 10, 0, []),
            ("verify", 250, 480, 10, 0, [
                ("verify.draw", 250, 260, 0, 0, []),
                ("verify.ransac", 260, 400, 0, 0, [("ransac.score", 260, 300, 0, 0, []),
                                                   ("ransac.polish", 330, 400, 0, 0, [])]),
                ("verify.refine", 400, 470, 0, 0, []),
            ]),
        ]),
    ]),
]

# by hand: decode 4 reads of 5 ms; RANSAC (10 + 140 - 70) / 10 pairs;
# polish (70 + 70) / 10; orchestration self times over 2 passes:
# load_detect 100-40-5-45, detect 45-30, two_view 300-280 (upload kept),
# chunk 280-40-230; faults (1000 + 500) / 2
EXPECTED = {"decode_ms_per_image": 5.0, "ransac_ms_per_pair": 8.0, "polish_ms_per_pair": 14.0,
            "orchestration_ms_per_pass": (10 + 15 + 20 + 10) / 2, "page_faults_per_pass": 750.0}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_span_readers_on_recorded_spans(metric, monkeypatch):
    reader = importlib.import_module(f"perfbench.metrics.{metric}")
    ctx = {"passes": 2, "pairs": 10}
    assert reader.read(ctx) is None  # an empty store: the metric is left out
    monkeypatch.setattr(tracing._RECORDER, "records", _records(PASS))
    assert reader.read(ctx) == pytest.approx(EXPECTED[metric])


def test_device_trace_writes_spans_beside_the_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("GTSFM_TPU_TRACE", str(tmp_path))
    with tracing.device_trace("run"):
        with tracing.span("work", 3):
            (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    assert sorted(os.listdir(tmp_path / "run")) == ["spans.json", "trace.json"]
    with open(tmp_path / "run" / "spans.json") as f:
        written = json.load(f)
    assert [(s["name"], s["units"]) for s in written["spans"]] == [("work", 3)] and written["dropped"] == 0
    assert tracing.spans() == []  # written, then reset
