#!/usr/bin/env python3
"""Wall time of the port's runner in fresh processes, with and without
``--prewarm``, on the card.

    python3 scripts/prewarm_wall.py [--rounds 2] [--out FILE]

The port has no jit programs and no persistent compile cache: a warm-up
warms only its own process, and the kernel build directory
(``utils/cuda_build.py``) is the one thing a process leaves to the next.
This script builds the kernels first, so that no run pays ``nvcc``, renders
the 32 ring views of chip_smoke.py's ``runner`` phase on the card into an
Olsson folder, and then runs ``python -m gtsfm_tpu_torch.runner
--config_name unified`` on it in a fresh process ``2 * rounds`` times, in
the order without, with, with, without ``--prewarm`` (repeated). For each
process it prints the wall time from its start to its exit, the
``total_runtime_sec`` it wrote and, with ``--prewarm``, the warm-up's
seconds by name; then the mean wall time of each arm and their
difference, beside the card's name and power limit. It writes the same
as one JSON object to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def render_folder(data_dir: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses

    gt = spectral_ring_poses(cs.ring_pairs(cs.NUM_CAMERAS), cs.NUM_CAMERAS)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = cs.ring_order(t)
    views = cs.ring_views(R, t, torch.device("cuda"), cs.runner_scene(np.asarray(t).mean(axis=0)), indices=order)
    cs.write_olsson(data_dir, views, np.asarray(R)[order], np.asarray(t)[order], cs.SPLAT_FOCAL)


def run_fresh(data_dir: str, out: str, prewarm: bool) -> dict:
    from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup

    argv = [sys.executable, "-m", "gtsfm_tpu_torch.runner", "--config_name", "unified", "--loader", "olsson",
            "--dataset_dirpath", data_dir, "--output_root", out] + (["--prewarm"] if prewarm else [])
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the runner exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    total = MetricsGroup.from_json(os.path.join(out, "results", "metrics", "total_summary.json"))
    warm = [line for line in proc.stdout.splitlines() if line.startswith("prewarm: ")]
    return {"prewarm": prewarm, "wall_sec": wall,
            "total_runtime_sec": {m.name: m.scalar for m in total.metrics}["total_runtime_sec"],
            "prewarm_line": warm[0] if warm else None}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--out", default=os.path.join(ROOT, "results", "prewarm_wall.json"))
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("prewarm_wall: no CUDA device", file=sys.stderr)
        return 1
    from gtsfm_tpu_torch.utils import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cuda_build.build()
    runs = []
    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "runner_data")
        render_folder(data_dir)
        torch.cuda.empty_cache()
        for i, prewarm in enumerate([False, True, True, False] * args.rounds):
            runs.append(run_fresh(data_dir, os.path.join(work, f"run{i}"), prewarm))
            print(json.dumps(runs[-1]), flush=True)
    mean = {arm: sum(r["wall_sec"] for r in runs if r["prewarm"] == arm) / (2 * args.rounds) for arm in (False, True)}
    summary = {"device": smi, "runs": runs, "mean_wall_sec_without": mean[False], "mean_wall_sec_with": mean[True],
               "with_minus_without_sec": mean[True] - mean[False]}
    print(f"prewarm_wall: fresh-process wall time without --prewarm {mean[False]:.3f} s, with {mean[True]:.3f} s, "
          f"difference {mean[True] - mean[False]:+.3f} s | {smi}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
