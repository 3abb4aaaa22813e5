#!/usr/bin/env python3
"""The JAX package's direct correspondence front ends and SuperGlue on the
correspondence phase's inputs, on the CPU: the reference numbers for
chip_smoke.py's ``correspondence`` phase.

    JAX_PLATFORMS=cpu python3 scripts/correspondence_reference.py \\
        [--out scripts/correspondence_reference.json] \\
        [--npz scripts/correspondence_reference.npz] [--skip_colmap]

The input is the one chip_smoke.py gives the port: the 32 ring views of its
``runner_scene`` rendered by the port on the CPU at 480x640, f=600, written
as an Olsson folder, a COLMAP text model of chip_smoke.CORR_GT_POINTS GT
points of those views (``mvs_tracks``, written by ``write_colmap_tracks``)
and the seeded checkpoints of ``write_correspondence_weights`` (LoFTR in
outdoor_ds.ckpt's layout, SuperGlue in superglue_outdoor.pth's, MASt3R in
the public .pth's), loaded through the reference's own loaders.

1. ``python -m gtsfm_tpu.runner --config_name colmap_front_end`` on the
   folder with ``correspondence.colmap_dir`` set: registered cameras, pose
   AUC@5, pairs, valid pairs and the stage seconds go to ``--out``.
2. On chip_smoke.CORR_HOLD_PAIRS (the first pairs of every run of the
   phase), the reference's LoFTR and MASt3R generators on the folder's
   first five views (stored in ``--npz`` as the 8-bit images the folder
   holds) and its SuperGlue on ``chip_smoke.corr_glue_feed``'s keypoints
   and descriptors of those views: the correspondences and matches go to
   ``--npz``, with each checkpoint's sum of squares.

On an 8-core CPU: the render about 100 s, the colmap run a few minutes,
MASt3R about a minute a pair. This script imports JAX; the port never does.
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from gtsfm_tpu import runner  # noqa: E402
from gtsfm_tpu.evaluation.metrics import MetricsGroup  # noqa: E402
from gtsfm_tpu.frontend.correspondence import DenseCorrespondenceGenerator  # noqa: E402
from gtsfm_tpu.frontend.mast3r import Mast3rCorrespondenceGenerator, MASt3ROptions  # noqa: E402
from gtsfm_tpu.frontend.matchers import loftr, superglue  # noqa: E402
from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses  # noqa: E402


def read_metrics(out_dir: str) -> dict:
    mdir = os.path.join(out_dir, "results", "metrics")
    return {g.name: {m.name: (m.scalar if m.dist is None else m.dist) for m in g.metrics}
            for g in (MetricsGroup.from_json(os.path.join(mdir, f)) for f in sorted(os.listdir(mdir)))}


def colmap_run(data_dir: str, colmap_dir: str, out_dir: str) -> dict:
    t0 = time.perf_counter()
    rc = runner.main(["--config_name", "colmap_front_end", "--loader", "olsson", "--dataset_dirpath", data_dir,
                      "--output_root", out_dir, f"correspondence.colmap_dir={colmap_dir}"])
    wall = time.perf_counter() - t0
    metrics = read_metrics(out_dir)
    fe = metrics["frontend_summary"]
    pose = metrics.get("ba_pose_metrics", {})
    return {"rc": rc, "registered": int(len(pose.get("rotation_error_deg", []))),
            "pose_auc_@5.0_deg": float(pose.get("pose_auc_@5.0_deg", 0.0)),
            "num_pairs": int(fe["num_pairs"]), "num_valid_pairs": int(fe["num_valid_pairs"]),
            "detect_describe_sec": fe["detect_describe_sec"], "two_view_sec": fe["two_view_sec"],
            "backend_sec": metrics["multiview_optimizer_metrics"]["backend_sec"],
            "total_runtime_sec": metrics["total_summary"]["total_runtime_sec"], "wall_sec": wall}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--npz", default=None)
    ap.add_argument("--skip_colmap", action="store_true", help="leave out run 1 (the held pairs only)")
    args = ap.parse_args()

    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)
    hold = np.asarray(chip_smoke.CORR_HOLD_PAIRS)
    n_hold = int(hold.max()) + 1
    out = {"views": len(order), "image_hw": list(chip_smoke.SPLAT_HW), "gt_points": chip_smoke.CORR_GT_POINTS,
           "hold_pairs": hold.tolist(), "jax": jax.__version__, "device": "cpu"}
    rec = {"hold_pairs": hold}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        views = chip_smoke.ring_views(R, t, torch.device("cpu"), chip_smoke.runner_scene(t.mean(axis=0)),
                                      indices=order if not args.skip_colmap else order[:n_hold])
        out["render_sec"] = time.perf_counter() - t0
        data_dir, colmap_dir = os.path.join(work, "data"), os.path.join(work, "colmap")
        chip_smoke.write_olsson(data_dir, views, R[order], t[order], chip_smoke.SPLAT_FOCAL)
        chip_smoke.write_colmap_tracks(colmap_dir, R[order], t[order],
                                       chip_smoke.mvs_tracks(R, t, order, n=chip_smoke.CORR_GT_POINTS))
        if not args.skip_colmap:
            out["colmap_front_end"] = colmap_run(data_dir, colmap_dir, os.path.join(work, "out"))
            print(json.dumps({"colmap_front_end": out["colmap_front_end"]}), flush=True)

        rgb = np.stack([np.asarray(Image.open(os.path.join(data_dir, "images", f"{i:02d}.png")).convert("RGB"))
                        for i in range(n_hold)])
        rec["views_rgb"] = rgb
        gray = chip_smoke.corr_hold_gray(rgb)
        weights = chip_smoke.write_correspondence_weights(work)
        out["sumsq"] = weights["sumsq"]

        t0 = time.perf_counter()
        lm = loftr.LoFTRMatcher(loftr.LoFTROptions(),
                                params=loftr.load_torch_weights(weights["loftr"])["params"])
        got = DenseCorrespondenceGenerator(lm).generate(list(gray), hold)
        out["loftr_sec"] = time.perf_counter() - t0
        for k, (a, b) in enumerate(hold.tolist()):
            rec[f"loftr_uv1_{k}"], rec[f"loftr_uv2_{k}"] = got[(a, b)]
        out["loftr_matches"] = [len(got[tuple(p)][0]) for p in hold.tolist()]
        print("loftr", out["loftr_matches"], f"{out['loftr_sec']:.1f} s", flush=True)
        del lm

        t0 = time.perf_counter()
        gen = Mast3rCorrespondenceGenerator(MASt3ROptions(), weights_path=weights["mast3r"])
        got = gen.generate(list(gray), hold)
        out["mast3r_sec"] = time.perf_counter() - t0
        for k, (a, b) in enumerate(hold.tolist()):
            rec[f"mast3r_uv1_{k}"], rec[f"mast3r_uv2_{k}"] = got[(a, b)]
        out["mast3r_correspondences"] = [len(got[tuple(p)][0]) for p in hold.tolist()]
        print("mast3r", out["mast3r_correspondences"], f"{out['mast3r_sec']:.1f} s", flush=True)
        del gen

        (xy, mask, desc), (i1, i2) = chip_smoke.corr_glue_feed(R[order], t[order])
        sg = superglue.SuperGlueMatcher(superglue.SuperGlueOptions(),
                                        params=superglue.load_torch_weights(weights["superglue"])["params"])
        t0 = time.perf_counter()
        idx, ok, score = (np.asarray(a) for a in sg.match_batch(
            jnp.asarray(desc[i1]), jnp.asarray(desc[i2]), jnp.asarray(xy[i1]), jnp.asarray(xy[i2]),
            jnp.asarray(mask[i1]), jnp.asarray(mask[i2]),
            image_size=(chip_smoke.SPLAT_HW[1], chip_smoke.SPLAT_HW[0])))
        out["superglue_sec"] = time.perf_counter() - t0
        rec["superglue_idx"], rec["superglue_mask"], rec["superglue_score"] = idx, ok, score
        out["superglue_matches"] = ok.sum(axis=1).tolist()
        print("superglue", out["superglue_matches"], f"{out['superglue_sec']:.1f} s", flush=True)

    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if args.npz:
        np.savez_compressed(args.npz, **rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
