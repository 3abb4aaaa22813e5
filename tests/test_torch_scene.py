"""The port's reconstruction slice against the JAX reference, end to end.

A 12-camera ring (the 32-camera gate's geometry, cut to size) with the
descriptor feed of chip_smoke.py (K=256, D=128) goes through both
packages' ``SceneOptimizer.run``. Matching is deterministic, so every
pair's putative match count must be identical; RANSAC, triangulation and
the translation-averaging start draw from different random streams, so
the reconstructions are held to the accuracy bar instead: both register
12/12 cameras and the port's pose AUC@5 is within 0.02 of the reference's.

Also here: importing the port or chip_smoke.py never imports jax, flax,
triton or the JAX package, and chip_smoke.py refuses to run without a CUDA
device.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from gtsfm_tpu.geometry import Cal3Bundler as JCal
from gtsfm_tpu.loader.synthetic import SyntheticSceneLoader as JLoader, spectral_ring_poses as j_ring
from gtsfm_tpu.scene.scene_optimizer import (
    SceneOptimizer as JSceneOptimizer,
    SceneOptimizerOptions as JOptions,
)
from gtsfm_tpu_torch.geometry import Cal3Bundler
from gtsfm_tpu_torch.loader.synthetic import SyntheticSceneLoader
from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads, threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, K = 12, 256
H, W = chip_smoke.IMAGE_HW


def _scalars(groups):
    return {(g.name, m.name): m.scalar for g in groups for m in g.metrics if m.dist is None}


@threads(4)
def test_slice_matches_reference_end_to_end():
    pairs = chip_smoke.ring_pairs(N)
    gt = j_ring(pairs, N)
    R, t = np.array(gt.R), np.array(gt.t)
    feed = chip_smoke.descriptor_feed(R, t, chip_smoke.FOCAL, chip_smoke.IMAGE_HW, K)

    # reference
    cal_j = JCal.create(jnp.full(N, chip_smoke.FOCAL), jnp.zeros(N), jnp.zeros(N),
                        jnp.full(N, W / 2.0), jnp.full(N, H / 2.0))
    so_j = JSceneOptimizer(
        JOptions(use_mesh=False, save_colmap=False, reconnect_bridges=False),
        retriever=chip_smoke.FixedPairs(pairs), detector=chip_smoke.FeedDetector(*feed),
    )
    two_view_j = {}
    run_two_view = so_j._run_two_view

    def recording(*args, **kwargs):
        out = run_two_view(*args, **kwargs)
        two_view_j.update(out)
        return out

    so_j._run_two_view = recording
    data_j, groups_j = so_j.run(JLoader(gt, cal=cal_j, image_size=chip_smoke.IMAGE_HW))

    # port
    cal_t = Cal3Bundler.create(torch.full((N,), chip_smoke.FOCAL), torch.zeros(N), torch.zeros(N),
                               torch.full((N,), W / 2.0), torch.full((N,), H / 2.0))
    so_t = SceneOptimizer(SceneOptimizerOptions(device="cpu"), retriever=chip_smoke.FixedPairs(pairs),
                          detector=chip_smoke.FeedDetector(*feed))
    data_t, groups_t = so_t.run(SyntheticSceneLoader(convert.se3({"R": R, "t": t}), cal=cal_t,
                                                     image_size=chip_smoke.IMAGE_HW))

    matches_t = {m.name: m.dist for g in groups_t for m in g.metrics}["num_matches_per_pair"]
    np.testing.assert_array_equal(matches_t, two_view_j["num_matches"])
    assert matches_t.min() > 15
    assert int(np.asarray(data_j.pose_mask).sum()) == N
    assert data_t.number_images() == N
    auc_j = _scalars(groups_j)[("ba_pose_metrics", "pose_auc_@5.0_deg")]
    auc_t = _scalars(groups_t)[("ba_pose_metrics", "pose_auc_@5.0_deg")]
    assert auc_t >= auc_j - 0.02, (auc_t, auc_j)
    assert bool(torch.isfinite(data_t.points[data_t.track_mask]).all())


def test_port_imports_no_jax_flax_or_triton():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gtsfm_tpu_torch\n"
        "for m in pkgutil.walk_packages(gtsfm_tpu_torch.__path__, 'gtsfm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'triton', 'gtsfm_tpu'))\n"
        "missed = [m for m in sys.argv[1:] if m not in sys.modules]\n"
        "print('LEAKED', bad, 'NOT WALKED', missed)\n"
        "sys.exit(1 if bad or missed else 0)\n"
    )
    # the modules of the default entry point must be among those walked
    entry = ["gtsfm_tpu_torch." + m for m in (
        "runner", "configs.config", "common.image", "common.sensor_db", "loader.olsson", "loader.colmap",
        "io.colmap", "frontend.detectors.dog_sift", "frontend.global_descriptors.descriptors",
        "frontend.registry", "retriever.bridge", "utils.ellipsoid", "utils.tracks", "densify.mvs",
        "densify.patchmatchnet", "io.bal", "loader.datasets", "loader.hilti")]
    res = subprocess.run([sys.executable, "-c", code, *entry], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_to_run_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device found" in res.stdout + res.stderr
    assert '"ok": true' not in res.stdout
