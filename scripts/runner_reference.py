#!/usr/bin/env python3
"""The JAX package's default entry point on rendered views, on the CPU: the
reference numbers for chip_smoke.py's ``runner`` phase.

    JAX_PLATFORMS=cpu python3 scripts/runner_reference.py [--views 32] [--out FILE]

The input is the one chip_smoke.py gives the port: the views of its seeded
50,000-gaussian ``runner_scene`` (``--scene splat``: its ``splat_scene``)
from the 32 cameras of its ring (or the first ``--views`` of them in ring
order), rendered by the port's renderer on the
CPU at 480x640, f=600, written as an Olsson folder (images/%02d.png in
ring order and data.mat with the GT projection matrices) in a temporary
directory. It runs ``python -m gtsfm_tpu.runner --config_name unified
--loader olsson`` on that folder in this process, with JAX on the CPU, and
prints one JSON object (and writes it to ``--out``): registered cameras,
the pose AUC@5, the pair count and the stage seconds. This script imports
JAX; the port never does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

from gtsfm_tpu import runner  # noqa: E402
from gtsfm_tpu.evaluation.metrics import MetricsGroup  # noqa: E402
from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses  # noqa: E402


def read_metrics(output_root: str) -> dict:
    """{group: {metric: scalar, or the full data of a distribution}} from a
    run's results/metrics/*.json."""
    mdir = os.path.join(output_root, "results", "metrics")
    out = {}
    for name in sorted(os.listdir(mdir)):
        g = MetricsGroup.from_json(os.path.join(mdir, name))
        out[g.name] = {m.name: (m.scalar if m.dist is None else m.dist) for m in g.metrics}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=chip_smoke.NUM_CAMERAS)
    ap.add_argument("--scene", choices=["runner", "splat"], default="runner",
                    help="chip_smoke's runner_scene (the runner phase's input) or splat_scene")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)[: args.views]
    t0 = time.perf_counter()
    make = chip_smoke.runner_scene if args.scene == "runner" else chip_smoke.splat_scene
    views = chip_smoke.ring_views(R, t, torch.device("cpu"), make(t.mean(axis=0)), indices=order)
    render_sec = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "data")
        out_dir = os.path.join(work, "out")
        chip_smoke.write_olsson(data_dir, views, R[order], t[order], chip_smoke.SPLAT_FOCAL)
        t0 = time.perf_counter()
        rc = runner.main(["--config_name", "unified", "--loader", "olsson", "--dataset_dirpath", data_dir,
                          "--output_root", out_dir])
        wall = time.perf_counter() - t0
        metrics = read_metrics(out_dir)
    fe = metrics["frontend_summary"]
    pose = metrics.get("ba_pose_metrics", {})  # absent when the back end failed
    out = {
        "views": len(order),
        "image_hw": list(chip_smoke.SPLAT_HW),
        "scene": args.scene,
        "registered": int(len(pose.get("rotation_error_deg", []))),
        "pose_auc_@5.0_deg": float(pose.get("pose_auc_@5.0_deg", 0.0)),
        "num_pairs": int(fe["num_pairs"]),
        "num_valid_pairs": int(fe["num_valid_pairs"]),
        "detect_describe_sec": fe["detect_describe_sec"],
        "retriever_duration_sec": fe["retriever_duration_sec"],
        "two_view_sec": fe["two_view_sec"],
        "backend_sec": metrics["multiview_optimizer_metrics"]["backend_sec"],
        "total_runtime_sec": metrics["total_summary"]["total_runtime_sec"],
        "render_sec": render_sec,
        "wall_sec": wall,
        "rc": rc,
        "jax": jax.__version__,
        "device": "cpu",
    }
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
