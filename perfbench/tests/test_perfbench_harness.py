"""CPU tests of the benchmark harness (perfbench/).

    python -m pytest perfbench/tests -q -p no:cacheprovider

They check that every file BENCHMARK.json names is found and parses, the
operation counts at small shapes, that the renderer repeats for a seed,
the result line's keys, that no run loads JAX or the JAX package and the
reference nothing of the program, and that the check passes a sound run
and fails the control and every fault the cell can have. Runs are made on
the CPU at a tiny size (the plain versions of the port's kernels). The
test marked ``cuda`` runs the control at the cell's own size on a card and
skips elsewhere.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.counts.attention import attention_work
from perfbench.counts.lightglue import lightglue_flops
from perfbench.counts.mutual_nn import mutual_nn_work
from perfbench.counts.superpoint import superpoint_flops

ROOT = run.ROOT
BENCH = run.load_json(ROOT, "BENCHMARK.json")
CELL = BENCH["workloads"][0]["name"]
TINY_TRAFFIC = {"views": 8, "width": 200, "height": 136, "focal_px": 180.0, "supersample": 1, "max_resolution": 136}
TINY_CONFIG = {"detector.max_keypoints": 96, "scene_optimizer.pair_batch_size": 8}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def tiny_run(**kw):
    return run.run_cell(BENCH, CELL, 4294967311, kw.pop("seconds", 1e-3), kw.pop("trace", False), device="cpu",
                        overrides=TINY_CONFIG, traffic_override=TINY_TRAFFIC, **kw)


# ------------------------------------------------------------------ files
def test_benchmark_file_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", names)) <= set(names)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    _cell, config, traffic, workload = run.cell_files(BENCH, cell)
    assert config["name"] == _cell["config"] and traffic["name"] == _cell["traffic"]
    assert set(workload["limits"]) >= set(pipeline_of(config).Pipeline.ORDER)
    conf = next(c for c in BENCH["configs"] if c["name"] == _cell["config"])
    assert os.path.exists(os.path.join(ROOT, conf["file"]))


def pipeline_of(config):
    return importlib.import_module(f"perfbench.pipelines.{config['pipeline']}")


@pytest.mark.parametrize("name", sorted(f[:-5] for f in os.listdir(os.path.join(run.HERE, "configs"))))
def test_every_configuration_names_a_pipeline_that_imports(name):
    pipeline = pipeline_of(run.load_json(run.HERE, "configs", f"{name}.json"))
    assert callable(pipeline.Pipeline) and pipeline.Pipeline.ORDER
    assert pipeline.Pipeline.ATTEMPTED in ("views", "pairs")


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_list_the_cells_they_read_in(kind):
    # a metric with no list is reported in every cell, those of other pipelines too
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[kind]:
        if kind == "per_layer" or m["name"] not in ("views_per_s", "peak_gib", "setup_s"):
            assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        else:  # what every pipeline reports
            assert "workloads" not in m


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_are_found_by_name(metric):
    reader = importlib.import_module(f"perfbench.metrics.{metric}")
    empty = {"spans": run_spans(), "work": {}, "device": {"ranges": {}, "busy_s": 0.0, "window_s": 0.0},
             "passes": 0, "pairs": 0, "config": {}, "detector_hw": (8, 8)}
    assert reader.read(empty) is None  # nothing to read: the metric is left out, never 0


def run_spans():
    from perfbench.adapter import Spans

    return Spans(traced=True)


# ------------------------------------------------------------------ counts
def test_lightglue_count_at_small_shapes():
    # d=4, one layer, 2 and 3 keypoints, d_in=4, dh=2, by hand:
    # input 2*5*4*4=160, posenc 2*5*2=20, layer 38*5*16 + 4*4*(4+9+12)=3040+400,
    # head 2*5*16 + 2*2*3*4 + 2*5*4 = 160+48+40
    assert lightglue_flops(2, 3, d=4, d_in=4, dh=2, layers=1) == 160 + 20 + 3440 + 248


def test_superpoint_count_at_small_shapes():
    # 16x16: convs at 16x16, 8x8, 4x4, 2x2 and the heads at 2x2
    H = W = 16
    want = 2 * H * W * (1 * 64 + 64 * 64) * 9 + 2 * 64 * (64 * 64 * 2) * 9 + 2 * 16 * (64 * 128 + 128 * 128) * 9 \
        + 2 * 4 * (128 * 128 * 2) * 9 + 2 * 4 * (128 * 256 * 9 + 256 * 65 + 128 * 256 * 9 + 256 * 256)
    assert superpoint_flops(H, W) == want


def test_attention_counts_at_small_shapes():
    q = torch.zeros(2, 5, 8)
    mask = torch.tensor([[1, 1, 0, 0, 0], [1, 1, 1, 0, 0]], dtype=torch.bool)
    flops, nbytes = attention_work("fused_attention_merged", q, q, q, 2, kv_mask=mask)
    assert float(flops) == 4 * 8 * 5 * 5 and nbytes == 4 * q.nbytes + mask.nbytes
    k1 = torch.zeros(2, 3, 8)
    m1 = torch.ones(2, 3, dtype=torch.bool)
    flops, nbytes = attention_work("fused_cross_attention_merged", q, k1, q, k1, 2, mask0=mask, mask1=m1)
    assert float(flops) == 4 * 8 * (5 * 6 + 3 * 5)
    assert nbytes == 2 * (q.nbytes + k1.nbytes) + q.nbytes + k1.nbytes + mask.nbytes + m1.nbytes
    qs = torch.zeros(2, 2, 5, 4)  # the split layout, 2 heads of 4
    assert float(attention_work("fused_attention", qs, qs, qs, kv_mask=mask)[0]) == 4 * 2 * 4 * 5 * 5


def test_mutual_nn_count_at_small_shapes():
    d = torch.zeros(2, 4, 8)
    m1 = torch.tensor([[1, 1, 0, 0], [1, 0, 0, 0]], dtype=torch.bool)
    m2 = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1]], dtype=torch.bool)
    flops, nbytes = mutual_nn_work(d, d, m1, m2)
    assert float(flops) == 2 * 8 * (2 * 3 + 1 * 4) and nbytes == 2 * d.nbytes + 16 + 2 * 4 * 9


# ------------------------------------------------------------------ scene
def test_renderer_repeats_for_a_seed():
    from perfbench import scene

    traffic = {**run.load_json(run.HERE, "traffic", "gerrard100.json"), **TINY_TRAFFIC, "views": 3}
    a, b = scene.render(traffic, 7, "cpu"), scene.render(traffic, 7, "cpu")
    c = scene.render(traffic, 8, "cpu")
    assert np.array_equal(a["images"], b["images"]) and np.array_equal(a["R"], b["R"])
    assert not np.array_equal(a["images"], c["images"])
    assert a["images"].std() > 20  # textured, not flat


# ------------------------------------------------------------------ runs
def test_sound_run_is_correct_with_the_contract_keys():
    res = tiny_run()
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())


def test_traced_run_reports_per_layer_metrics():
    res = tiny_run(trace=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    want = set(run.metric_names(BENCH, "per_layer", CELL))
    assert {"load_ms_per_image", "detect_ms_per_image", "lightglue_ms_per_pair"} <= set(res["metrics"]) <= want
    assert {"busy_s", "window_s"} <= set(res["device"])


def test_front_end_throughputs_are_whole_passes_over_the_window(monkeypatch):
    from perfbench.pipelines import front_end

    passes = []
    run_pass = front_end.Pipeline.run_pass
    monkeypatch.setattr(front_end.Pipeline, "run_pass", lambda self, seed: passes.append(seed) or run_pass(self, seed))
    res = tiny_run(seconds=2.0)
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    window_s = res["attempted"] / metrics["pairs_per_s"]  # pairs over the window's seconds
    assert res["metrics"]["views_per_s"]["unit"] == "views/s" and res["metrics"]["pairs_per_s"]["unit"] == "pairs/s"
    assert window_s >= 2.0 and len(set(passes)) == len(passes) >= 1
    assert metrics["views_per_s"] == pytest.approx(TINY_TRAFFIC["views"] * len(passes) / window_s, rel=1e-12)


def _drop_half(fe):
    inner = fe.inner["match_batch"]

    def match_batch(*a, **k):
        idx, ok, score = inner(*a, **k)
        ok = ok.clone()
        ok[ok.shape[0] // 2:] = False
        return torch.where(ok, idx, -1), ok, score

    fe.inner["match_batch"] = match_batch


def _alter_match(fe):
    inner = fe.inner["match_batch"]

    def match_batch(*a, **k):
        idx, ok, score = inner(*a, **k)
        return torch.where(ok, (idx + 1) % a[1].shape[1], -1).to(idx.dtype), ok, score

    fe.inner["match_batch"] = match_batch


def _shift_keypoints(fe):
    inner = fe.inner["detect_batch"]
    fe.inner["detect_batch"] = lambda images: (lambda o: (o[0] + 3.0, o[1], o[2]))(inner(images))


def _alter_pose(fe):
    inner = fe.inner["run_two_view_batch"]

    def two_view(*a, **k):
        out = inner(*a, **k)
        return dataclasses.replace(out, i2Ri1=out.i2Ri1.transpose(-1, -2), i2Ui1=-out.i2Ui1)

    fe.inner["run_two_view_batch"] = two_view


@pytest.mark.parametrize("fault", [_drop_half, _alter_match, _shift_keypoints, _alter_pose],
                         ids=["half_the_batch_left_out", "match_altered", "keypoints_altered", "pose_altered"])
def test_check_fails_a_broken_timed_path(fault):
    assert tiny_run(fault=fault)["correct"] is False


def test_control_fails_the_check():
    from perfbench import check

    res = tiny_run(control=True)
    limits = run.load_json(run.HERE, "workloads", f"{CELL}.json")["limits"]
    assert res["correct"] is True and check.judge(res["control"], limits) is False


def test_mutual_nn_configuration_runs_and_checks():
    bench = {**BENCH, "workloads": [{"name": "sift.test", "config": "sift_front_end", "traffic": "gerrard100",
                                     "chips": 1, "why": "test"}]}
    workload = run.load_json(run.HERE, "workloads", f"{CELL}.json")
    res = run.run_cell(bench, "sift.test", 3, 1e-3, False, device="cpu", overrides=TINY_CONFIG,
                       traffic_override=TINY_TRAFFIC, workload=workload)
    assert res["checks"]["kp_gap_px"]["value"] == 0.0 and res["checks"]["pose_gap_deg"]["value"] == 0.0


def _raise_gap(program):
    program.gap = 0.75


@pytest.mark.parametrize("fault, correct", [(None, True), (_raise_gap, False)], ids=["sound", "gap_over_its_limit"])
def test_a_pipeline_of_another_kind_runs_from_files_of_its_own(fault, correct, monkeypatch):
    from perfbench.tests import stub_pipeline

    monkeypatch.setitem(sys.modules, "perfbench.pipelines.stub", stub_pipeline)  # as a new pipelines/stub.py
    bench = {**BENCH, "configs": [{"name": "stub", "file": "perfbench/configs/stub.json"}],
             "workloads": [{"name": "stub.tiny", "config": "stub", "traffic": "gerrard100", "chips": 1, "why": "t"}]}
    res = run.run_cell(bench, "stub.tiny", 2**31 + 5, 0.05, False, device="cpu", traffic_override=TINY_TRAFFIC,
                       fault=fault, config={"name": "stub", "pipeline": "stub", "gap": 0.25},
                       workload={"limits": {"gap": 0.5, "answers_missing": 0}})
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"views_per_s", "peak_gib", "setup_s"}  # no pairs: no pairs_per_s
    assert res["attempted"] % TINY_TRAFFIC["views"] == 0 and res["attempted"] >= TINY_TRAFFIC["views"]
    assert list(res["checks"]) == list(stub_pipeline.Pipeline.ORDER) and res["correct"] is correct
    assert res["checks"]["gap"] == {"value": 0.25 if correct else 0.75, "limit": 0.5}


# ------------------------------------------------------------------ imports
def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["gtsfm_tpu_torch_fake.x"] = sys.modules["json"]
        assert "gtsfm_tpu" not in run.forbidden_modules()
        sys.modules["gtsfm_tpu.fake"] = sys.modules["json"]
        assert "gtsfm_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import perfbench.tests.test_perfbench_harness as t; "
            "t.tiny_run(); from perfbench import run; print('FOUND', run.forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(run.HERE, "reference")
    for f in sorted(os.listdir(ref_dir)):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref_dir, f)).read())
            names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
            names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
            assert not [n for n in names if n.split(".")[0] in ("gtsfm_tpu_torch", "gtsfm_tpu", "jax")], f
    code = ("import sys; sys.path.insert(0, '.'); import perfbench.check; "
            "print('LOADED', sorted({m.split('.')[0] for m in sys.modules} & {'gtsfm_tpu_torch', 'gtsfm_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert "LOADED []" in out.stdout, out.stderr[-2000:]


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cell's kernels have no CPU mode)")
    from perfbench import check

    res = run.run_cell(BENCH, CELL, 97531, 1e-3, False, control=True)
    limits = run.load_json(run.HERE, "workloads", f"{CELL}.json")["limits"]
    assert res["correct"] is True and check.judge(res["control"], limits) is False
