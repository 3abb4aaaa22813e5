#!/usr/bin/env python3
"""The JAX package's default entry point with the two-view and back-end
options of chip_smoke.py's ``runner_options`` phase, on the CPU: that
phase's reference numbers.

    JAX_PLATFORMS=cpu python3 scripts/runner_options_reference.py [--scoring lmeds|inliers] \\
        [--port] [--out FILE]

The input is the runner phase's: the 32 ring views of chip_smoke's
``runner_scene``, rendered by the port's renderer on the CPU at 480x640,
f=600, and written as an Olsson folder by ``chip_smoke.write_olsson``, the
writer scripts/runner_reference.py uses (its ``read_metrics`` reads the
results). It runs ``python -m gtsfm_tpu.runner --config_name unified
--loader olsson`` on that folder in this process with
``chip_smoke.RUNNER_OPTIONS`` (``--scoring`` swaps the RANSAC scoring),
JAX on the CPU, and prints one JSON object (and writes it to ``--out``):
registered cameras, the pose AUC@5, the pair counts and the stage seconds.
``--port`` also runs the port's runner on the same folder on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from runner_reference import read_metrics  # noqa: E402

from gtsfm_tpu import runner  # noqa: E402
from gtsfm_tpu_torch import runner as port_runner  # noqa: E402
from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses  # noqa: E402


def summary(metrics: dict) -> dict:
    fe = metrics["frontend_summary"]
    pose = metrics.get("ba_pose_metrics", {})  # absent when the back end failed
    return {
        "registered": int(len(pose.get("rotation_error_deg", []))),
        "pose_auc_@5.0_deg": float(pose.get("pose_auc_@5.0_deg", 0.0)),
        "num_pairs": int(fe["num_pairs"]),
        "num_valid_pairs": int(fe["num_valid_pairs"]),
        "two_view_sec": fe["two_view_sec"],
        "backend_sec": metrics["multiview_optimizer_metrics"]["backend_sec"],
        "total_runtime_sec": metrics["total_summary"]["total_runtime_sec"],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scoring", choices=["lmeds", "inliers"], default="lmeds")
    ap.add_argument("--port", action="store_true", help="also run the port's runner on the CPU")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    overrides = [o if "ransac.scoring" not in o else o.split("=")[0] + "=" + args.scoring
                 for o in chip_smoke.RUNNER_OPTIONS]
    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)
    t0 = time.perf_counter()
    views = chip_smoke.ring_views(R, t, torch.device("cpu"), chip_smoke.runner_scene(t.mean(axis=0)), indices=order)
    render_sec = time.perf_counter() - t0
    out = {"views": len(order), "image_hw": list(chip_smoke.SPLAT_HW), "overrides": overrides,
           "render_sec": render_sec, "jax": jax.__version__, "device": "cpu"}
    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "data")
        chip_smoke.write_olsson(data_dir, views, R[order], t[order], chip_smoke.SPLAT_FOCAL)
        argv = ["--config_name", "unified", "--loader", "olsson", "--dataset_dirpath", data_dir]
        t0 = time.perf_counter()
        rc = runner.main(argv + ["--output_root", os.path.join(work, "jax")] + overrides)
        out["jax"] = {**summary(read_metrics(os.path.join(work, "jax"))), "rc": rc,
                      "wall_sec": time.perf_counter() - t0}
        if args.port:
            t0 = time.perf_counter()
            rc = port_runner.main(argv + ["--output_root", os.path.join(work, "port")] + overrides
                                  + ["scene_optimizer.device=cpu"])
            out["port_cpu"] = {**summary(read_metrics(os.path.join(work, "port"))), "rc": rc,
                               "wall_sec": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
