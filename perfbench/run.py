#!/usr/bin/env python3
"""Run one cell of the benchmark of ``gtsfm_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration
(perfbench/configs/<config>.json), a scene (perfbench/traffic/<traffic>
.json) and its check (perfbench/workloads/<cell>.json). Set-up renders the
scene from the seed into the temporary directory in Olsson's layout,
writes the seeded checkpoints, builds the scene optimizer as the runner
does and warms every shape a pass uses. The window then runs whole
front-end passes back to back (perfbench/adapter.py) while less than
``--seconds`` have passed, and finishes the pass in flight. The last line
of standard output is the result as one JSON object; with ``--trace 1``
the window runs under ``torch.profiler`` and the metrics are the cell's
per-layer metrics (perfbench/metrics/<metric>.py). After the window the
plain reference checks the last pass (perfbench/check.py), and the
numbers it compared, each with its limit, close standard error and the
result line.

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


def cell_files(bench: dict, name: str, workload: dict | None = None) -> tuple:
    """(cell, config, traffic, workload) for the cell ``name``: its
    configuration, traffic and check files, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no cell {name!r} in BENCHMARK.json (cells: {', '.join(cells)})")
    cell = cells[name]
    return (cell, load_json(HERE, "configs", f"{cell['config']}.json"),
            load_json(HERE, "traffic", f"{cell['traffic']}.json"),
            workload or load_json(HERE, "workloads", f"{name}.json"))


def per_layer_names(bench: dict, cell: str) -> list:
    return [m["name"] for m in bench["per_layer"] if cell in m.get("workloads", [cell])]


def with_overrides(config: dict, overrides: dict | None) -> dict:
    """The configuration with dotted ``overrides`` applied to its settings."""
    config = json.loads(json.dumps(config))
    for key, value in (overrides or {}).items():
        node = config["settings"]
        for part in key.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[key.split(".")[-1]] = value
    return config


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
             control: bool = False, workload: dict | None = None) -> dict:
    """One run of the cell ``name``; returns the result dict. ``overrides``
    (dotted config keys), ``traffic_override``, ``workload`` (in place of
    the cell's check file) and ``fault`` (called with the built
    adapter.FrontEnd before the window, to break the timed path) serve the
    CPU tests; with ``control`` the result also holds the control's
    numbers (perfbench/control.py)."""
    import numpy as np
    import torch

    from perfbench import adapter, check, scene, trace as trace_mod, weights

    cell, config, traffic, workload = cell_files(bench, name, workload)
    traffic = {**traffic, **(traffic_override or {})}
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
        meta = {k: views[k] for k in ("focal", "width", "height")}
        n_views = len(views["images"])
        gray = views["images"].astype(np.float32) @ np.asarray([0.299, 0.587, 0.114], np.float32) / 255.0
        del views
        paths = weights.write(config, seed, os.path.join(work, "weights"), device)
        spans = adapter.Spans(traced=trace)
        fe = adapter.FrontEnd(config, paths, scene_dir, traffic["max_resolution"], device, spans, -1, overrides)
        pair_batch, image_batch = fe.pair_batch, fe.so.options.image_batch_size
        marks.append(("build", time.perf_counter()))
        n_pairs = fe.warm(gray)
        del gray
        marks.append(("warm", time.perf_counter()))
        fe.check_chunk = check.check_chunk(seed, n_pairs, fe.pair_batch)
        if fault is not None:
            fault(fe)
        spans.clear()
        before = adapter.layer_counters()
        sync()
        setup_s = time.perf_counter() - PROCESS_START

        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if trace and cuda:  # the device's activity alone: see perfbench/trace.py
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        passes, pairs, out, pass_s = 0, 0, None, []
        w0 = time.time_ns()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            out = fe.run_pass(pass_seed(seed, passes))
            passes += 1
            pairs += len(out.pairs)
            pass_s.append(time.perf_counter() - t0 - sum(pass_s))
            print(f"perfbench: pass {passes}: {len(out.pairs)} pairs, stages (load-detect, retrieve, two-view) "
                  f"{', '.join(f'{s:.3f}' for s in out.stage_s)} s", file=sys.stderr, flush=True)
        sync()
        t1 = time.perf_counter()
        w1 = time.time_ns()
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        process_peak = max(setup_peak, window_peak)
        if prof is not None:
            prof.stop()
        after = adapter.layer_counters()

        result = {"correct": False, "attempted": pairs, "failed": 0, "metrics": {},
                  "device": {"platform": "gpu" if cuda else "cpu",
                             "kind": torch.cuda.get_device_name() if cuda else "cpu",
                             "count": 1, "memory_peak_bytes": process_peak}}
        if trace:
            dev = trace_mod.reduce(prof, spans.ranges, (w0, w1)) if prof is not None else {
                "busy_s": 0.0, "window_s": 0.0, "ranges": {}, "device_ops": [], "idle_gaps": []}
            del prof
            ctx = {"spans": spans, "work": spans.totals(), "device": dev, "passes": passes, "pairs": pairs,
                   "config": config, "detector_hw": (meta["height"], meta["width"])}
            for metric in per_layer_names(bench, name):
                value = importlib.import_module(f"perfbench.metrics.{metric}").read(ctx)
                if value is not None:
                    unit = next(m["unit"] for m in bench["per_layer"] if m["name"] == metric)
                    result["metrics"][metric] = {"value": value, "unit": unit}
            result["device"].update(busy_s=dev["busy_s"], window_s=dev["window_s"])
            result["breakdown"] = {"device_ops": dev["device_ops"], "idle_gaps": dev["idle_gaps"]}
        else:
            result["metrics"] = {
                "pairs_per_s": {"value": pairs / (t1 - t0), "unit": "pairs/s"},
                "peak_gib": {"value": window_peak / GIB, "unit": "GiB"},
                "setup_s": {"value": setup_s, "unit": "s"},
            }
        print(f"perfbench: {name} seed {seed}: {passes} passes ({', '.join(f'{s:.3f}' for s in pass_s)} s), "
              f"{pairs} pairs in {t1 - t0:.3f} s, set-up "
              f"{setup_s:.3f} s (imports {marks[0][1] - PROCESS_START:.3f}, "
              + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
              + f"); card: {card_line() if cuda else 'none'}", file=sys.stderr, flush=True)
        path = {k: (after[k] - before[k]) if isinstance(after[k], int) else after[k] for k in after}
        print(f"perfbench: path counters over the window: {json.dumps(path)}; the last pass: "
              f"{-(-len(out.pairs) // pair_batch)} chunks, {int(out.result['valid'].sum())} valid pairs, "
              f"{int(out.kp_mask.sum())} keypoints, {int(out.result['num_matches'].sum())} matches",
              file=sys.stderr, flush=True)

        # the check, on the last pass, with the program's state freed
        fe.close()
        del fe
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        ref = check.Reference(with_overrides(config, overrides), paths, meta, scene_dir, device)
        batches = check.sample(seed, n_views, image_batch, workload["check"]["detector_batches"])
        start = out.chunk["start"]
        nums = check.compare(ref, out, batches, out.pairs[start:start + pair_batch], start, out.chunk)
        nums["rows_missing"] = check.rows_missing(out, config["settings"]["retriever"]["max_frame_lookahead"])
        limits = workload["limits"]
        result["correct"] = check.judge(nums, limits)
        result["failed"] = int(max(0, len(out.pairs) - len(out.result["valid"])))
        if control:
            result["control"] = check.compare(ref, out, batches, out.pairs[start:start + pair_batch], start,
                                              out.chunk, control=True)
        result["checks"] = {k: {"value": nums[k], "limit": limits.get(k)} for k in check.ORDER}
        print(f"perfbench: check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr, flush=True)
        for k in check.ORDER:
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
