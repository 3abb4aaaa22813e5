#!/usr/bin/env python3
"""The JAX package's hierarchical synthetic scene on the CPU: the reference
numbers for chip_smoke.py's ``hierarchical`` phase.

    JAX_PLATFORMS=cpu python3 scripts/hierarchical_reference.py [--cameras 281] [--out FILE]

The configuration is the one chip_smoke.py drives through the PyTorch
port: ``--cameras`` cameras (281, the palace-281 scene's size) with pairs
from the default ``SequentialRetriever`` (lookahead 15), GT poses from
``spectral_ring_poses`` over those pairs, Cal3Bundler f=300 at 240x320,
``SyntheticOptions(num_points=800, noise_px=0.4, seed=0)`` and
``SceneOptimizerOptions(hierarchical=True, max_cluster_size=40)``. It prints
one JSON object (and writes it to ``--out``): registered cameras, the pose
AUC@5 of ``compare_reconstructions``, the median rotation and translation
errors after a Sim3 alignment to GT (rotations by chip_smoke's float64
``rotation_error_deg``), the cluster tree and the stage seconds. This script imports JAX; the port never does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import rotation_error_deg  # noqa: E402  (numpy only)

from gtsfm_tpu.evaluation.compare import compare_reconstructions  # noqa: E402
from gtsfm_tpu.frontend.synthetic import SyntheticCorrespondenceGenerator, SyntheticOptions  # noqa: E402
from gtsfm_tpu.geometry import Cal3Bundler  # noqa: E402
from gtsfm_tpu.geometry.sim3 import align_poses_sim3  # noqa: E402
from gtsfm_tpu.loader.synthetic import SyntheticSceneLoader, spectral_ring_poses  # noqa: E402
from gtsfm_tpu.retriever.retrievers import RetrieverOptions, sequential_pairs  # noqa: E402
from gtsfm_tpu.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions  # noqa: E402

H, W = 240, 320
FOCAL = 300.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cameras", type=int, default=281)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    n = args.cameras

    pairs = sequential_pairs(n, RetrieverOptions().max_frame_lookahead)
    gt = spectral_ring_poses(pairs, n)
    cal = Cal3Bundler.create(jnp.full(n, FOCAL), jnp.zeros(n), jnp.zeros(n),
                             jnp.full(n, W / 2.0), jnp.full(n, H / 2.0))
    loader = SyntheticSceneLoader(gt, cal=cal, image_size=(H, W))
    so = SceneOptimizer(
        SceneOptimizerOptions(hierarchical=True, max_cluster_size=40, save_colmap=False, use_mesh=False),
        correspondence=SyntheticCorrespondenceGenerator(SyntheticOptions(num_points=800, noise_px=0.4, seed=0)),
    )
    t0 = time.perf_counter()
    data, groups = so.run(loader)
    wall = time.perf_counter() - t0

    scalars = {g.name: {m.name: m.scalar for m in g.metrics if m.dist is None} for g in groups}
    est = np.asarray(data.pose_mask)
    auc5 = {m.name: m.scalar for m in compare_reconstructions(data, data.replace(poses=gt)).metrics
            if m.dist is None}["pose_auc_@5.0_deg"]
    sim = align_poses_sim3(data.poses, gt, mask=jnp.asarray(est))
    aligned = sim.transform_pose(data.poses)
    r_err = rotation_error_deg(np.asarray(aligned.R)[est], np.asarray(gt.R)[est])
    t_err = np.linalg.norm(np.asarray(aligned.t) - np.asarray(gt.t), axis=-1)[est]
    mvo = scalars["multiview_optimizer_metrics"]
    out = {
        "cameras": n,
        "pairs": int(len(pairs)),
        "registered": int(est.sum()),
        "pose_auc_@5.0_deg": float(auc5),
        "median_rotation_error_deg": float(np.median(r_err)),
        "median_translation_error": float(np.median(t_err)),
        "num_clusters": mvo.get("num_clusters"),
        "tree_nodes": mvo.get("tree_nodes"),
        "merge_failures": mvo.get("merge_failures", 0),
        "nodes": {"/".join(map(str, p)): d.number_images()
                   for p, d in so._hier_node_results if p},
        "two_view_sec": scalars["frontend_summary"]["two_view_sec"],
        "leaf_mvo_sec": mvo.get("leaf_mvo_sec"),
        "merge_sec": mvo.get("merge_sec"),
        "backend_sec": mvo["backend_sec"],
        "total_runtime_sec": scalars["total_summary"]["total_runtime_sec"],
        "wall_sec": wall,
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
