"""The port's direct correspondence path against the reference.

- ``KeypointAggregatorUnique`` and ``KeypointAggregatorDedup`` (host numpy,
  copies of the reference's loops): on seeded per-pair correspondences with
  near-duplicates inside and outside the merge radius and a keypoint cap
  that overflows, the keypoint lists, masks and per-pair index triples
  equal the reference's exactly.
- ``ColmapCorrespondenceGenerator``: on a COLMAP text model of GT tracks
  (``chip_smoke.mvs_tracks`` written by ``chip_smoke.write_colmap_tracks``),
  the same correspondences as the reference, exactly.
- ``DenseCorrespondenceGenerator``'s union padding, against the reference's
  with a matcher that records what it is given.
- A direct-branch run: the colmap_front_end config through both packages'
  ``SceneOptimizer`` on an Olsson folder of 6 numpy-made ring views with
  that model (exhaustive pairs): equal registered counts, AUC@5 within
  0.02, correspondences per pair within 2 + 3% of the reference's, and with
  ``telemetry_db`` the same sqlite rows as the reference's (the per-pair
  results; timings aside, the RANSAC draws differ, so inlier counts and
  errors are held loosely).
"""

import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.configs import config as j_config
from gtsfm_tpu.frontend import correspondence as jc
from gtsfm_tpu.loader.olsson import OlssonLoader as JOlssonLoader
from gtsfm_tpu_torch.configs import config
from gtsfm_tpu_torch.frontend import correspondence as tc
from gtsfm_tpu_torch.loader.olsson import OlssonLoader
from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses
from tests.torch_threads import cap_threads, threads

cap_threads()

VIEWS = 6
HW = (96, 128)
FOCAL = 120.0
GT_POINTS = 400
AUC_SLACK = 0.02
CORR_ABS, CORR_REL = 2, 0.03
# global keypoints per image in every direct run of the tests: one two-view
# shape, so that the reference compiles it once per process
DIRECT_KEYPOINTS = 1024


def _pair_corrs(seed=0, n_images=4, m=60):
    """Seeded per-pair correspondences: each pair's points partly repeat
    earlier points of the same images, some within 3 px (merged) and some
    just outside."""
    rng = np.random.default_rng(seed)
    base = [rng.uniform(0, 100, (m, 2)).astype(np.float32) for _ in range(n_images)]
    out = {}
    for i1 in range(n_images):
        for i2 in range(i1 + 1, n_images):
            k = m // 2
            uv1 = np.concatenate([base[i1][:k] + rng.normal(0, 1.5, (k, 2)), rng.uniform(0, 100, (m - k, 2))])
            uv2 = np.concatenate([base[i2][:k] + rng.normal(0, 4.0, (k, 2)), rng.uniform(0, 100, (m - k, 2))])
            out[(i1, i2)] = (uv1.astype(np.float32), uv2.astype(np.float32))
    return out


@pytest.mark.parametrize("cls", ["KeypointAggregatorUnique", "KeypointAggregatorDedup"])
@pytest.mark.parametrize("max_kp", [64, 4096])
def test_aggregators_exact(cls, max_kp):
    corrs = _pair_corrs()
    got = getattr(tc, cls)(tc.AggregatorOptions(max_keypoints_per_image=max_kp)).aggregate(4, corrs)
    want = getattr(jc, cls)(jc.AggregatorOptions(max_keypoints_per_image=max_kp)).aggregate(4, corrs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.float32 and list(got[2]) == list(want[2])
    for k in want[2]:
        for a, b in zip(got[2][k], want[2][k]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.fixture(scope="module")
def folder(tmp_path_factory) -> dict:
    """An Olsson folder of VIEWS ring views (chip_smoke.feedforward_views)
    and a COLMAP model of their GT tracks."""
    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)[:VIEWS]
    root = tmp_path_factory.mktemp("direct")
    views = chip_smoke.feedforward_views(R, t, order, hw=HW, focal=FOCAL)
    chip_smoke.write_olsson(str(root / "data"), views, R[order], t[order], FOCAL)
    tracks = chip_smoke.mvs_tracks(R, t, order, n=GT_POINTS, hw=HW, focal=FOCAL)
    chip_smoke.write_colmap_tracks(str(root / "colmap"), R[order], t[order], tracks, hw=HW, focal=FOCAL)
    return {"data": str(root / "data"), "colmap": str(root / "colmap")}


def test_colmap_replay_exact(folder):
    pairs = np.array([[i, j] for i in range(VIEWS) for j in range(i + 1, VIEWS)])
    got = tc.ColmapCorrespondenceGenerator(folder["colmap"]).generate(None, pairs)
    want = jc.ColmapCorrespondenceGenerator(folder["colmap"]).generate(pairs)
    assert set(got) == set(want)
    assert sum(len(v[0]) for v in want.values()) > 0
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b)


def test_dense_generator_pads_to_the_union():
    seen = {}

    class Recorder:
        def __init__(self, lib):
            self.lib = lib

        def match_images(self, a, b):
            seen.setdefault(self.lib, []).append((np.asarray(a), np.asarray(b)))
            n = 5
            uv = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
            mask = np.arange(n) < 3
            if self.lib == "port":
                return torch.as_tensor(uv), torch.as_tensor(uv + 1), torch.zeros(n), torch.as_tensor(mask)
            return jnp.asarray(uv), jnp.asarray(uv + 1), jnp.zeros(n), jnp.asarray(mask)

    rng = np.random.default_rng(0)
    images = [rng.uniform(size=(10, 12)).astype(np.float32), rng.uniform(size=(8, 14, 3)).astype(np.float32)]
    pairs = np.array([[0, 1]])
    got = tc.DenseCorrespondenceGenerator(Recorder("port"), device="cpu").generate(images, pairs)
    want = jc.DenseCorrespondenceGenerator(Recorder("jax")).generate(images, pairs)
    for (a, b), (c, d) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        assert a.shape == (10, 14)
    for a, b in zip(got[(0, 1)], want[(0, 1)]):
        np.testing.assert_array_equal(a, b)


def _record_aggregation(module, store):
    orig = module.KeypointAggregatorDedup.aggregate

    def recorded(self, num_images, pair_corrs):
        store.update({k: len(v[0]) for k, v in pair_corrs.items()})
        return orig(self, num_images, pair_corrs)

    module.KeypointAggregatorDedup.aggregate = recorded
    return lambda: setattr(module.KeypointAggregatorDedup, "aggregate", orig)


def direct_runs(folder: str, config_name: str, overrides: list, share_weights=None, telemetry_dir=None) -> dict:
    """Both packages' scene optimizers from ``config_name`` with
    ``overrides`` and DIRECT_KEYPOINTS global keypoints on the Olsson
    ``folder`` (the port's on the CPU; ``share_weights(so_port, so_jax)``
    gives the port the reference's net weights; with ``telemetry_dir``
    each writes <dir>/<jax|port>.sqlite), run and held to each other:
    registered counts equal, AUC@5 within AUC_SLACK, correspondences per
    pair within CORR_ABS + CORR_REL. Returns both runs' correspondence
    counts, registered counts and AUC@5."""
    overrides = overrides + [f"scene_optimizer.direct_max_keypoints={DIRECT_KEYPOINTS}"]
    tele = {lib: [f"scene_optimizer.telemetry_db={telemetry_dir}/{lib}.sqlite"] if telemetry_dir else []
            for lib in ("jax", "port")}
    so_j = j_config.build_scene_optimizer(j_config.load_config(config_name, overrides + tele["jax"]))
    so_t = config.build_scene_optimizer(config.load_config(
        config_name, overrides + tele["port"] + ["scene_optimizer.device=cpu"]))
    if share_weights is not None:
        share_weights(so_t, so_j)
    counts = {"jax": {}, "port": {}}
    restore = [_record_aggregation(jc, counts["jax"]), _record_aggregation(tc, counts["port"])]
    try:
        _, groups_j = so_j.run(JOlssonLoader(folder))
        _, groups_t = so_t.run(OlssonLoader(folder))
    finally:
        for r in restore:
            r()
    out = {"counts": counts}
    for lib, groups in (("jax", groups_j), ("port", groups_t)):
        pose = {m.name: m for g in groups if g.name == "ba_pose_metrics" for m in g.metrics}
        out[lib] = {"registered": len(pose["rotation_error_deg"].dist) if pose else 0,
                    "auc5": pose["pose_auc_@5.0_deg"].scalar if pose else 0.0}
    assert out["port"]["registered"] == out["jax"]["registered"], out
    assert out["port"]["auc5"] >= out["jax"]["auc5"] - AUC_SLACK, out
    assert set(counts["port"]) == set(counts["jax"]) and counts["jax"]
    for k, w in counts["jax"].items():
        assert abs(counts["port"][k] - w) <= CORR_ABS + CORR_REL * w, (k, counts["port"][k], w)
    return out


@threads(4)
def test_colmap_front_end_direct_run_and_telemetry(folder, tmp_path):
    out = direct_runs(folder["data"], "colmap_front_end", [f"correspondence.colmap_dir={folder['colmap']}"],
                      telemetry_dir=str(tmp_path))
    assert out["jax"]["registered"] == VIEWS and sum(out["counts"]["jax"].values()) > 0
    rows = {}
    for lib in ("jax", "port"):
        with sqlite3.connect(str(tmp_path / f"{lib}.sqlite")) as conn:
            rows[lib] = {
                "pairs": conn.execute("SELECT i1, i2, num_matches, num_inliers, inlier_ratio, valid, r_error_deg, "
                                      "u_error_deg FROM two_view_results ORDER BY i1, i2").fetchall(),
                "stages": sorted(r[0] for r in conn.execute("SELECT stage FROM stage_timings")),
                "meta": sorted(conn.execute("SELECT key, value FROM run_metadata").fetchall()),
            }
    assert rows["port"]["stages"] == rows["jax"]["stages"]
    assert rows["port"]["meta"] == rows["jax"]["meta"]
    assert len(rows["port"]["pairs"]) == len(rows["jax"]["pairs"]) == VIEWS * (VIEWS - 1) // 2
    for got, want in zip(rows["port"]["pairs"], rows["jax"]["pairs"]):
        assert got[:3] == want[:3] and got[5] == want[5]
        # noise-free correspondences: every match is an inlier in both
        assert abs(got[3] - want[3]) <= CORR_ABS + CORR_REL * want[3]
        assert abs(got[6] - want[6]) < 0.5 and abs(got[7] - want[7]) < 1.0


@threads(4)
def test_loftr_compact_direct_run(folder):
    """The compact dense matcher (loftr_compact, dim 32) on the same
    folder through both scene optimizers, the reference's init in both."""
    from gtsfm_tpu_torch.utils import convert

    def share(so_t, so_j):
        params = {k: {n: {a: np.asarray(b) for a, b in c.items()} for n, c in v.items()}
                  for k, v in so_j.correspondence.matcher.params.items()}
        so_t.correspondence.matcher.net.load_state_dict(convert.dense_matcher_state_dict(params))

    out = direct_runs(folder["data"], "skydio_front_end", ["correspondence.name=loftr_compact",
                                                           "correspondence.dim=32", "correspondence.match_threshold=0.0"],
                      share_weights=share)
    assert sum(out["counts"]["jax"].values()) > 0
