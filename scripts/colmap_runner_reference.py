#!/usr/bin/env python3
"""The JAX package's default entry point on a distorted COLMAP folder, on the
CPU: the reference numbers for chip_smoke.py's ``colmap_runner`` phase.

    JAX_PLATFORMS=cpu python3 scripts/colmap_runner_reference.py [--out FILE]

The input is the one chip_smoke.py gives the port: the views of its seeded
``runner_scene`` from the 32 cameras of its ring, rendered by the port's
renderer on the CPU at 480x640, f=600, resampled through chip_smoke's
OPENCV_CAMERA (``colmap_opencv_views``) and written as a COLMAP text folder
(``write_colmap_opencv``: one OPENCV camera, the GT poses) in a temporary
directory. It runs ``python -m gtsfm_tpu.runner --config_name unified
--loader colmap`` on that folder in this process, with JAX on the CPU, and
prints one JSON object (and writes it to ``--out``): registered cameras,
the pose AUC@5, the pair count, the exported camera model and the stage
seconds. This script imports JAX; the port never does.
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

import torch  # noqa: E402

import chip_smoke  # noqa: E402

from gtsfm_tpu import runner  # noqa: E402
from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses  # noqa: E402
from scripts.runner_reference import read_metrics  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    t0 = time.perf_counter()
    views, R, t = chip_smoke.colmap_opencv_views(gt.R.numpy(), gt.t.numpy(), torch.device("cpu"))
    render_sec = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "data")
        out_dir = os.path.join(work, "out")
        chip_smoke.write_colmap_opencv(data_dir, views, R, t, chip_smoke.OPENCV_CAMERA)
        t0 = time.perf_counter()
        rc = runner.main(["--config_name", "unified", "--loader", "colmap", "--dataset_dirpath", data_dir,
                          "--output_root", out_dir])
        wall = time.perf_counter() - t0
        metrics = read_metrics(out_dir)
        with open(os.path.join(out_dir, "results", "ba_output", "cameras.txt")) as f:
            models = sorted({ln.split()[1] for ln in f if ln.strip() and not ln.startswith("#")})
    fe = metrics["frontend_summary"]
    pose = metrics.get("ba_pose_metrics", {})  # absent when the back end failed
    out = {
        "views": len(views),
        "image_hw": list(chip_smoke.SPLAT_HW),
        "camera": chip_smoke.OPENCV_CAMERA,
        "registered": int(len(pose.get("rotation_error_deg", []))),
        "pose_auc_@5.0_deg": float(pose.get("pose_auc_@5.0_deg", 0.0)),
        "num_pairs": int(fe["num_pairs"]),
        "num_valid_pairs": int(fe["num_valid_pairs"]),
        "exported_models": models,
        "detect_describe_sec": fe["detect_describe_sec"],
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
