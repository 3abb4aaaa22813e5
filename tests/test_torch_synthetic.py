"""The port's synthetic direct-correspondence front end against the JAX
reference, and the scene-level runs it feeds.

- Synthetic generator at 16 and 32 cameras (with and without outliers):
  every index array equal, ``kp_xy`` within 1e-3 px in view (the
  projection's float32 round-off; out of view, where a point near a
  camera's plane lands 1e4 px away, within 1e-6 relative), ``i2Ri1`` and
  ``i2Ui1`` within 1e-6.
- Retrievers: sequential, exhaustive and similarity pairs equal;
  ``similarity_matrix`` within bf16 tolerance (2^-7 relative).
- Reports: ``make_reports`` and ``aggregate_frontend_metrics`` on one
  two-view result and GT, within 1e-5; rotation errors within 1e-5 deg
  plus a float32 arccos's resolution at their angle.
- Gate twin: the 32-camera gate of ``tests/scene/test_accuracy_gate_32.py``
  through the port's ``SceneOptimizer`` (synthetic generator, flat):
  32/32 registered and ``compare_reconstructions``' AUC@5 >= 0.978.
- Through ``SceneOptimizer`` with ``hierarchical=True, max_cluster_size=8``
  on a 24-camera ring, both packages: the port registers what the
  reference registers within one camera, and its pose AUC@5 is within 0.02
  of the reference's (RANSAC, triangulation and the translation-averaging
  start draw from different random streams, so the runs are held to
  accuracy, not round-off).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.evaluation.compare import compare_reconstructions as j_compare
from gtsfm_tpu.frontend import reports as jreports
from gtsfm_tpu.frontend.synthetic import (
    SyntheticCorrespondenceGenerator as JGenerator,
    SyntheticOptions as JSyntheticOptions,
)
from gtsfm_tpu.geometry import SE3 as JSE3, Cal3Bundler as JCal
from gtsfm_tpu.loader.synthetic import SyntheticSceneLoader as JLoader, spectral_ring_poses as j_ring
from gtsfm_tpu.retriever import retrievers as jret
from gtsfm_tpu.scene.scene_optimizer import (
    SceneOptimizer as JSceneOptimizer,
    SceneOptimizerOptions as JOptions,
)
from gtsfm_tpu_torch.evaluation.compare import compare_reconstructions
from gtsfm_tpu_torch.frontend import reports
from gtsfm_tpu_torch.frontend.detectors.dog_sift import DoGSift
from gtsfm_tpu_torch.frontend.synthetic import SyntheticCorrespondenceGenerator, SyntheticOptions
from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
from gtsfm_tpu_torch.loader.synthetic import SyntheticSceneLoader
from gtsfm_tpu_torch.retriever import retrievers as ret
from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions
from tests.torch_threads import cap_threads, threads

cap_threads()

H, W = chip_smoke.IMAGE_HW
F = chip_smoke.FOCAL


def _ring(n):
    pairs = chip_smoke.ring_pairs(n)
    gt = j_ring(pairs, n)
    return pairs, np.array(gt.R), np.array(gt.t)


def _cals(n):
    cal_j = JCal.create(jnp.full(n, F), jnp.zeros(n), jnp.zeros(n), jnp.full(n, W / 2.0), jnp.full(n, H / 2.0))
    cal_t = Cal3Bundler.create(torch.full((n,), F), torch.zeros(n), torch.zeros(n),
                               torch.full((n,), W / 2.0), torch.full((n,), H / 2.0))
    return cal_j, cal_t


def _auc5(group):
    return {m.name: m.scalar for m in group.metrics if m.dist is None}["pose_auc_@5.0_deg"]


@pytest.mark.parametrize("n,outliers", [(16, 0.0), (32, 0.0), (32, 0.2)])
def test_synthetic_generator_matches_reference(n, outliers):
    pairs, R, t = _ring(n)
    cal_j, cal_t = _cals(n)
    sizes = [(W, H)] * n
    want = JGenerator(JSyntheticOptions(num_points=500, noise_px=0.4, outlier_fraction=outliers, seed=3)).generate(
        JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), cal_j, pairs, sizes)
    got = SyntheticCorrespondenceGenerator(
        SyntheticOptions(num_points=500, noise_px=0.4, outlier_fraction=outliers, seed=3)).generate(
        SE3(R=torch.as_tensor(R), t=torch.as_tensor(t)), cal_t, pairs, sizes)
    for k in ("corr_i1", "corr_i2", "corr_mask", "kp_mask", "valid", "num_inliers", "points"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # in view within 1e-3 px; far outside the image (points near a camera's
    # plane project to 1e4+ px, unused) within float32 round-off
    vis = got["kp_mask"]
    np.testing.assert_allclose(got["keypoints_xy"][vis], want["keypoints_xy"][vis], atol=1e-3)
    np.testing.assert_allclose(got["keypoints_xy"], want["keypoints_xy"], rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got["i2Ri1"], want["i2Ri1"], atol=1e-6)
    np.testing.assert_allclose(got["i2Ui1"], want["i2Ui1"], atol=1e-6)
    assert got["valid"].all() and got["kp_mask"].mean() > 0.3


def test_retrievers_match_reference():
    class EvenPairsOnly:
        def __len__(self):
            return 20

        def is_valid_pair(self, i, j):
            return (i + j) % 2 == 0

    for lookahead in (1, 3, 15, 40):
        np.testing.assert_array_equal(ret.sequential_pairs(20, lookahead), jret.sequential_pairs(20, lookahead))
    np.testing.assert_array_equal(ret.exhaustive_pairs(20), jret.exhaustive_pairs(20))
    np.testing.assert_array_equal(ret.SequentialRetriever().get_image_pairs(20, loader=EvenPairsOnly()),
                                  jret.SequentialRetriever().get_image_pairs(20, loader=EvenPairsOnly()))
    np.testing.assert_array_equal(ret.ExhaustiveRetriever().get_image_pairs(20),
                                  jret.ExhaustiveRetriever().get_image_pairs(20))

    rng = np.random.default_rng(0)
    desc = rng.normal(size=(40, 64)).astype(np.float32)
    desc[20:] = desc[:20] + 0.6 * rng.normal(size=(20, 64)).astype(np.float32)  # similar halves
    sim_t = ret.similarity_matrix(torch.as_tensor(desc)).numpy()
    sim_j = np.asarray(jret.similarity_matrix(jnp.asarray(desc)))
    np.testing.assert_allclose(sim_t, sim_j, rtol=2.0**-7, atol=2.0**-7)
    opts = (5, 0.3)
    np.testing.assert_array_equal(ret.similarity_pairs(torch.as_tensor(desc), *opts)[0],
                                  jret.similarity_pairs(jnp.asarray(desc), *opts)[0])
    np.testing.assert_array_equal(ret.pairs_from_similarity_matrix(sim_j, *opts),
                                  jret.pairs_from_similarity_matrix(sim_j, *opts))
    r_t = ret.JointSimilaritySequentialRetriever(ret.RetrieverOptions(max_frame_lookahead=2))
    r_j = jret.JointSimilaritySequentialRetriever(jret.RetrieverOptions(max_frame_lookahead=2))
    np.testing.assert_array_equal(r_t.get_image_pairs(40, desc), r_j.get_image_pairs(40, jnp.asarray(desc)))
    assert r_t.latest_similarity_matrix.shape == (40, 40)
    with pytest.raises(ValueError):
        ret.SimilarityRetriever().get_image_pairs(40)


def test_reports_and_verifier_summary_match_reference():
    n = 12
    pairs, R, t = _ring(n)
    rng = np.random.default_rng(1)
    E = len(pairs)
    i1, i2 = pairs[:, 0], pairs[:, 1]
    rel = np.einsum("eji,ejk->eik", R[i2], R[i1])
    noise = np.asarray(JSE3.exp(jnp.asarray(np.concatenate(
        [rng.normal(0, np.radians(3.0), (E, 3)), np.zeros((E, 3))], 1), jnp.float32)).R)
    d = np.einsum("eji,ej->ei", R[i2], t[i1] - t[i2]) + rng.normal(0, 0.8, (E, 3))
    tvr = {
        "i2Ri1": np.einsum("eij,ejk->eik", noise, rel).astype(np.float32),
        "i2Ui1": (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32),
        "num_matches": rng.integers(50, 200, E).astype(np.int32),
        "num_inliers": rng.integers(10, 50, E).astype(np.int32),
        "inlier_ratio": rng.random(E).astype(np.float32),
        "valid": rng.random(E) > 0.25,
    }
    gt_j = JSE3(R=jnp.asarray(R), t=jnp.asarray(t))
    gt_t = SE3(R=torch.as_tensor(R), t=torch.as_tensor(t))
    rep_j = jreports.make_reports(pairs, tvr, gt_j)
    rep_t = reports.make_reports(pairs, tvr, gt_t)
    # a float32 arccos resolves an angle theta to about 2^-22 / sin(theta)
    # rad; the two packages round the 3x3 products differently
    def r_tol(reps):
        return 1e-5 + np.degrees(2.0**-22 / np.sin(np.radians([r.R_error_deg for r in reps])))

    for a, b in zip(rep_t, rep_j):
        assert (a.i1, a.i2, a.num_matches, a.num_inliers, a.valid) == (b.i1, b.i2, b.num_matches, b.num_inliers, b.valid)
        assert abs(a.R_error_deg - b.R_error_deg) <= r_tol([b])[0], (a.R_error_deg, b.R_error_deg)
        np.testing.assert_allclose([a.U_error_deg, a.inlier_ratio], [b.U_error_deg, b.inlier_ratio], atol=1e-5)
    g_j = jreports.aggregate_frontend_metrics(rep_j)
    g_t = reports.aggregate_frontend_metrics(rep_t)
    assert g_t.name == g_j.name == "verifier_summary"
    assert [m.name for m in g_t.metrics] == [m.name for m in g_j.metrics]
    valid_tol = r_tol([r for r in rep_j if r.valid])
    for a, b in zip(g_t.metrics, g_j.metrics):
        got, want = (a.scalar, b.scalar) if a.dist is None else (a.dist, b.dist)
        tol = valid_tol if a.name in ("rotation_angular_errors_deg", "pose_errors_deg") else 1e-5
        assert np.all(np.abs(np.asarray(got) - want) <= tol), a.name
    # without GT: counts only, as in the reference
    assert [m.name for m in reports.aggregate_frontend_metrics(reports.make_reports(pairs, tvr, None)).metrics] == \
        [m.name for m in jreports.aggregate_frontend_metrics(jreports.make_reports(pairs, tvr, None)).metrics]


def _port_scene(n, pairs, R, t, options, points=600):
    _, cal_t = _cals(n)
    poses = SE3(R=torch.as_tensor(R), t=torch.as_tensor(t))
    so = SceneOptimizer(options, retriever=chip_smoke.FixedPairs(pairs),
                        correspondence=SyntheticCorrespondenceGenerator(
                            SyntheticOptions(num_points=points, noise_px=0.4, seed=0)))
    data, groups = so.run(SyntheticSceneLoader(poses, cal=cal_t, image_size=(H, W)))
    return so, data, groups, poses


@threads(4)
def test_gate_twin_registers_all_32_cameras_above_the_bar():
    n = 32
    pairs, R, t = _ring(n)
    so, data, groups, poses = _port_scene(n, pairs, R, t, SceneOptimizerOptions(device="cpu"))
    names = [g.name for g in groups]
    assert names[:3] == ["frontend_summary", "verifier_summary", "multiview_optimizer_metrics"]
    assert data.number_images() == n
    auc5 = _auc5(compare_reconstructions(data, data.replace(poses=poses)))
    assert auc5 >= chip_smoke.AUC5_BAR, auc5
    assert so.node_results == [] and "num_clusters" not in so.backend_metrics


@threads(4)
def test_hierarchical_scene_optimizer_matches_reference():
    n = 24
    pairs, R, t = _ring(n)
    cal_j, _ = _cals(n)
    gt_j = JSE3(R=jnp.asarray(R), t=jnp.asarray(t))
    so_j = JSceneOptimizer(
        JOptions(hierarchical=True, max_cluster_size=8, use_mesh=False, save_colmap=False, reconnect_bridges=False),
        retriever=chip_smoke.FixedPairs(pairs),
        correspondence=JGenerator(JSyntheticOptions(num_points=600, noise_px=0.4, seed=0)),
    )
    data_j, groups_j = so_j.run(JLoader(gt_j, cal=cal_j, image_size=(H, W)))
    so_t, data_t, groups_t, poses = _port_scene(
        n, pairs, R, t, SceneOptimizerOptions(device="cpu", hierarchical=True, max_cluster_size=8))

    mvo_j = {m.name: m.scalar for g in groups_j if g.name == "multiview_optimizer_metrics" for m in g.metrics}
    mvo_t = {m.name: m.scalar for g in groups_t if g.name == "multiview_optimizer_metrics" for m in g.metrics}
    assert so_t.backend_metrics["partitioner"] == "metis"
    assert (mvo_t["num_clusters"], mvo_t["tree_nodes"]) == (mvo_j["num_clusters"], mvo_j["tree_nodes"])
    assert mvo_t["num_clusters"] >= 2 and not so_t.backend_metrics.get("merge_failures")
    for k in ("leaf_mvo_sec", "merge_sec", "backend_sec"):
        assert mvo_t[k] > 0
    assert [p for p, _ in so_t.node_results] == [p for p, _ in so_j._hier_node_results]
    reg_j, reg_t = data_j.number_images(), data_t.number_images()
    assert reg_t >= reg_j - 1 and reg_t >= n - 1, (reg_t, reg_j)
    auc_j = _auc5(j_compare(data_j, data_j.replace(poses=gt_j)))
    auc_t = _auc5(compare_reconstructions(data_t, data_t.replace(poses=poses)))
    assert auc_t >= auc_j - 0.02, (auc_t, auc_j)
    assert bool(torch.isfinite(data_t.points[data_t.track_mask]).all())


def test_direct_branch_needs_no_detector_or_retriever_and_raises_without_a_card(monkeypatch):
    gen = SyntheticCorrespondenceGenerator()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SceneOptimizer(SceneOptimizerOptions(hierarchical=True), correspondence=gen)
    so = SceneOptimizer(SceneOptimizerOptions(hierarchical=True, device="cpu"), correspondence=gen)
    assert isinstance(so.retriever, ret.SequentialRetriever) and so.detector is None
    # without a detector or a generator, DoG-SIFT with the options' detector settings
    default = SceneOptimizer(SceneOptimizerOptions(device="cpu"))
    assert isinstance(default.detector, DoGSift) and default.detector.max_keypoints == 1024
