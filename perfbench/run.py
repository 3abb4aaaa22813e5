#!/usr/bin/env python3
"""Run one cell of the benchmark of ``gtsfm_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration
(perfbench/configs/<config>.json), a scene (perfbench/traffic/<traffic>
.json) and its check (perfbench/workloads/<cell>.json); the configuration
names its pipeline (perfbench/pipelines/<pipeline>.py). Set-up renders the
scene from the seed into the temporary directory in Olsson's layout, and
the pipeline writes its seeded checkpoints, builds the program and warms
every shape a pass uses. The window then runs whole passes back to back
while less than ``--seconds`` have passed, and finishes the pass in
flight; each count of a pass (views, pairs) over the window is a
throughput, ``<count>_per_s``. The last line of standard output is the
result as one JSON object; with ``--trace 1`` the window runs under
``torch.profiler`` and the metrics are the cell's per-layer metrics
(perfbench/metrics/<metric>.py). After the window, with the program's
state freed, the pipeline holds the last pass against its plain reference,
and the numbers it compared, each with its limit, close standard error
and the result line.

Exits non-zero without a result when there is no card, when the program
cannot be imported or fails, and when ``jax``, ``jaxlib``, ``flax`` or
``gtsfm_tpu`` is loaded in this process.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gtsfm_tpu")
GIB = float(1 << 30)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(bench: dict, name: str, workload: dict | None = None, config: dict | None = None) -> tuple:
    """(cell, config, traffic, workload) for the cell ``name``: its
    configuration, traffic and check files, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no cell {name!r} in BENCHMARK.json (cells: {', '.join(cells)})")
    cell = cells[name]
    return (cell, config or load_json(HERE, "configs", f"{cell['config']}.json"),
            load_json(HERE, "traffic", f"{cell['traffic']}.json"),
            workload or load_json(HERE, "workloads", f"{name}.json"))


def metric_names(bench: dict, kind: str, cell: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics the cell reports."""
    return [m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])]


def pass_seed(seed: int, k: int) -> int:
    """The two-view stage's seed of pass ``k``: every pass draws anew."""
    import numpy as np

    return int(np.random.default_rng([seed, 2, k]).integers(1 << 31))


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, traffic_override: dict | None = None, fault=None,
             control: bool = False, workload: dict | None = None, config: dict | None = None) -> dict:
    """One run of the cell ``name``; returns the result dict. ``overrides``
    (dotted config keys), ``traffic_override``, ``workload`` and ``config``
    (in place of the cell's check and configuration files) and ``fault``
    (called with the pipeline's built program before the window, to break
    the timed path) serve the CPU tests; with ``control`` the result also
    holds the control's numbers (perfbench/control.py)."""
    import torch

    from perfbench import adapter, check, scene, trace as trace_mod

    cell, config, traffic, workload = cell_files(bench, name, workload, config)
    traffic = {**traffic, **(traffic_override or {})}
    pipeline = importlib.import_module(f"perfbench.pipelines.{config['pipeline']}")
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    work = tempfile.mkdtemp(prefix=f"perfbench-{name}-")
    marks = [("start", time.perf_counter())]
    try:
        views = scene.render(traffic, seed, device)
        marks.append(("render", time.perf_counter()))
        scene_dir = os.path.join(work, "scene")
        scene.write_olsson(scene_dir, views)
        marks.append(("write", time.perf_counter()))
        spans = adapter.Spans(traced=trace)
        pipe = pipeline.Pipeline(config, traffic, scene_dir, views, seed, work, device, spans, overrides)
        del views
        marks.append(("build", time.perf_counter()))
        pipe.warm()
        marks.append(("warm", time.perf_counter()))
        if fault is not None:
            fault(pipe.program)
        spans.clear()
        before = pipe.counters()
        sync()
        setup_s = time.perf_counter() - PROCESS_START

        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if trace and cuda:  # the device's activity alone: see perfbench/trace.py
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        passes, counts, pass_s = 0, {}, []
        w0 = time.time_ns()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for k, v in pipe.run_pass(pass_seed(seed, passes)).items():
                counts[k] = counts.get(k, 0) + v
            passes += 1
            pass_s.append(time.perf_counter() - t0 - sum(pass_s))
        sync()
        t1 = time.perf_counter()
        w1 = time.time_ns()
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        process_peak = max(setup_peak, window_peak)
        if prof is not None:
            prof.stop()
        after = pipe.counters()

        failed = counts.pop("failed", 0)
        result = {"correct": False, "attempted": counts[pipe.ATTEMPTED], "failed": failed, "metrics": {},
                  "device": {"platform": "gpu" if cuda else "cpu",
                             "kind": torch.cuda.get_device_name() if cuda else "cpu",
                             "count": 1, "memory_peak_bytes": process_peak}}
        if trace:
            dev = trace_mod.reduce(prof, spans.ranges, (w0, w1)) if prof is not None else {
                "busy_s": 0.0, "window_s": 0.0, "ranges": {}, "device_ops": [], "idle_gaps": []}
            del prof
            ctx = {"spans": spans, "work": spans.totals(), "device": dev, "passes": passes, "config": config,
                   **counts, **pipe.context()}
            values = {m: importlib.import_module(f"perfbench.metrics.{m}").read(ctx)
                      for m in metric_names(bench, "per_layer", name)}
            result["device"].update(busy_s=dev["busy_s"], window_s=dev["window_s"])
            result["breakdown"] = {"device_ops": dev["device_ops"], "idle_gaps": dev["idle_gaps"]}
        else:
            values = {f"{k}_per_s": v / (t1 - t0) for k, v in counts.items()}
            values.update(peak_gib=window_peak / GIB, setup_s=setup_s)
        units = {m["name"]: m["unit"] for key in ("end_to_end", "per_layer") for m in bench[key]}
        result["metrics"] = {m: {"value": values[m], "unit": units[m]}
                             for m in metric_names(bench, "per_layer" if trace else "end_to_end", name)
                             if values.get(m) is not None}
        print(f"perfbench: {name} seed {seed}: {passes} passes ({', '.join(f'{s:.3f}' for s in pass_s)} s), "
              f"{json.dumps(counts)} in {t1 - t0:.3f} s, set-up "
              f"{setup_s:.3f} s (imports {marks[0][1] - PROCESS_START:.3f}, "
              + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
              + f"); card: {card_line() if cuda else 'none'}", file=sys.stderr, flush=True)
        path = {k: (after[k] - before[k]) if isinstance(after[k], int) else after[k] for k in after}
        print(f"perfbench: path counters over the window: {json.dumps(path)}", file=sys.stderr, flush=True)

        # the check, on the last pass, with the program's state freed
        pipe.close()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        nums, low = pipe.check(workload.get("check", {}), control)
        limits = workload["limits"]
        result["correct"] = check.judge(nums, limits, pipe.ORDER)
        if control:
            result["control"] = low
        result["checks"] = {k: {"value": nums[k], "limit": limits.get(k)} for k in pipe.ORDER}
        print(f"perfbench: check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr, flush=True)
        for k in pipe.ORDER:
            print(f"check {k}: {nums[k]!r} limit {limits.get(k)!r}", file=sys.stderr, flush=True)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    build = os.path.join(ROOT, "build", "perfbench")
    # kernel caches at fixed paths inside the checkout (the port's own nvcc
    # builds go to build/torch_kernels), so only a checkout's first run builds
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    sys.path.insert(0, ROOT)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = cell_files(bench, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: the cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
