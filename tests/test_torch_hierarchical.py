"""The port's hierarchical back end against the JAX reference.

- Partitioner: ``metis_bisect`` labels are identical on three seeded
  graphs (the 10-camera pair graph of the reference's hierarchical test, a
  64-camera sequential graph, the 240-camera lawnmower graph of
  ``tests/scene/test_scale_synthetic.py``); ``MetisPartitioner`` trees are
  identical node for node; ``BinaryTreePartitioner`` trees are identical up
  to the order of siblings (the sign of an eigenvector from ARPACK's random
  start decides which half comes first, in the reference too).
- Merge: ``sim3_from_point_pairs`` with 30% gross outliers gives the same
  inlier mask and s, R, t within 1e-4 relative; ``concatenate_scenes`` and
  ``compact_tracks`` give the same index arrays and points within 1e-5;
  ``merge_children`` with the parent BA gives rotations within 1e-4 rad,
  centers within 1e-4 x the scene's scale and the same track mask (the
  tolerance of the dense BA's own parity test); ``run_compact`` alone is
  held the same way.
- Hierarchical: the reference test's inputs (10 cameras,
  ``HierarchicalOptions(max_depth=1, max_cluster_size=4)``) with JAX's
  two-view result as the common input: the same cluster count, tree size
  and node paths; both register n - 1 or more cameras; the port meets the
  reference test's bars (max rotation error < 2 deg, max translation error
  < 0.3). The leaf back ends draw from different random streams, so the
  runs are held to these bars, not to round-off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.bundle.ba import BAOptions as JBAOptions, BundleAdjustment as JBA
from gtsfm_tpu.common.sfm_data import SfmData as JSfmData
from gtsfm_tpu.frontend.two_view import TwoViewOptions as JTwoViewOptions, run_two_view_batch as j_two_view
from gtsfm_tpu.frontend.verifiers.essential import RansacOptions as JRansacOptions
from gtsfm_tpu.geometry import SE3 as JSE3, Cal3Bundler as JCal, so3 as jso3
from gtsfm_tpu.loader.synthetic import spectral_ring_poses as j_ring
from gtsfm_tpu.merging import merge as jmerge
from gtsfm_tpu.partitioner import partitioners as jpart
from gtsfm_tpu.retriever.retrievers import sequential_pairs as j_sequential_pairs
from gtsfm_tpu.scene.hierarchical import (
    HierarchicalOptions as JHierOptions,
    HierarchicalReconstruction as JHier,
)
from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment
from gtsfm_tpu_torch.geometry import so3
from gtsfm_tpu_torch.geometry.sim3 import Sim3, align_poses_sim3
from gtsfm_tpu_torch.merging import merge
from gtsfm_tpu_torch.partitioner import partitioners as part
from gtsfm_tpu_torch.scene.hierarchical import HierarchicalOptions, HierarchicalReconstruction
from gtsfm_tpu_torch.utils import convert
from tests.frontend.test_two_view import make_pair_batch
from tests.torch_threads import cap_threads, threads

cap_threads()

F = 300.0


# ---------------------------------------------------------------------------
# partitioner
# ---------------------------------------------------------------------------
def _lawnmower_pairs():
    """The 240-camera sweep graph of test_scale_synthetic.py:82-89."""
    n, cols = 240, 120
    seq = np.asarray(j_sequential_pairs(n, 8))
    cross = [(i, i + cols + dj) for i in range(n) for dj in (-1, 0, 1) if i < i + cols + dj < n]
    return np.unique(np.concatenate([seq, np.asarray(cross, seq.dtype)]), axis=0)


GRAPHS = {
    "pair_graph_10": lambda: make_pair_batch(n_cams=10, n_pts=200, seed=11)[1],
    "sequential_64": lambda: np.asarray(j_sequential_pairs(64, 6)),
    "lawnmower_240": _lawnmower_pairs,
}


def _weights(edges, seed=0):
    return np.random.default_rng(seed).integers(20, 400, len(edges)).astype(np.float64)


def _tree(t, ordered=True):
    """Every node's edge set, recursively; siblings sorted unless ordered."""
    kids = [_tree(c, ordered) for c in t.children]
    return (tuple(map(tuple, np.asarray(t.value).tolist())), tuple(kids if ordered else sorted(kids)))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_metis_bisect_labels_match_reference(graph):
    edges = GRAPHS[graph]().astype(np.int64)
    n = int(edges.max()) + 1
    for w in (None, _weights(edges)):
        got = part.metis_bisect(n, edges, w)
        want = jpart.metis_bisect(n, edges, w)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < n


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_metis_partitioner_tree_matches_reference(graph):
    edges = GRAPHS[graph]()
    w = _weights(edges, 1)
    for depth, size in ((1, 4), (3, 8), (6, 40)):
        p = part.MetisPartitioner(max_depth=depth, max_cluster_size=size)
        got = p.run(edges, w)
        want = jpart.MetisPartitioner(max_depth=depth, max_cluster_size=size).run(edges, w)
        assert p.ran == "metis"
        assert _tree(got) == _tree(want)
        np.testing.assert_array_equal(got.all_edges(), want.all_edges())
        assert len(got.leaves()) == len(want.leaves()) and got.num_nodes() == want.num_nodes()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_binary_tree_partitioner_matches_reference(graph):
    edges = GRAPHS[graph]()
    w = _weights(edges, 2)
    got = part.BinaryTreePartitioner(max_depth=3, max_cluster_size=8).run(edges, w)
    want = jpart.BinaryTreePartitioner(max_depth=3, max_cluster_size=8).run(edges, w)
    assert _tree(got, ordered=False) == _tree(want, ordered=False)
    assert len(got.leaves()) > 1


def test_metis_partitioner_falls_back_to_spectral_visibly(monkeypatch):
    def no_library():
        raise OSError("no toolchain")

    monkeypatch.setattr(part, "_load_metis", no_library)
    edges = GRAPHS["sequential_64"]()
    p = part.MetisPartitioner(max_depth=2, max_cluster_size=8)
    tree = p.run(edges)
    assert p.ran == "spectral" and len(tree.leaves()) > 1


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------
def _rot(rng, deg):
    return np.asarray(jso3.expmap(jnp.asarray(rng.normal(0, np.radians(deg), 3), jnp.float32)))


def test_sim3_from_point_pairs_matches_reference_with_gross_outliers():
    rng = np.random.default_rng(0)
    n = 300
    pa = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    R, s, t = _rot(rng, 40.0), 1.7, np.array([1.0, -2.0, 0.5])
    pb = ((pa - t) @ R / s + rng.normal(0, 0.01, (n, 3))).astype(np.float32)  # pa = s R pb + t
    out = rng.random(n) < 0.3
    pb[out] = rng.uniform(-8, 8, (out.sum(), 3))
    sim_j, inl_j, ok_j = jmerge.sim3_from_point_pairs(pa, pb)
    sim_t, inl_t, ok_t = merge.sim3_from_point_pairs(torch.as_tensor(pa), torch.as_tensor(pb))
    assert ok_t and ok_j
    np.testing.assert_array_equal(inl_t, np.asarray(inl_j))
    assert not inl_t[out].any() and inl_t[~out].mean() > 0.9
    for got, want in ((sim_t.s, sim_j.s), (sim_t.R, sim_j.R), (sim_t.t, sim_j.t)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # too few pairs: no Sim3
    assert merge.sim3_from_point_pairs(torch.as_tensor(pa[:7]), torch.as_tensor(pb[:7]))[2] is False


def _children(rng):
    """Two children of a 12-camera ring (cameras 0-5 and 6-11) seeing the
    same 150 points; child b lives in another Sim3 frame. -> (JAX SfmData a,
    b, (pa, pb, ta, tb) 3D-3D pairs)."""
    N, Tn = 12, 150
    edges = np.asarray(sorted({(min(i, (i + k) % N), max(i, (i + k) % N)) for i in range(N) for k in (1, 2)}))
    gt = j_ring(edges, N)
    R, t = np.array(gt.R), np.array(gt.t)
    X = rng.uniform(-4, 4, (Tn, 3))
    cal = JCal.create(jnp.full(N, F), jnp.zeros(N), jnp.zeros(N), jnp.full(N, 160.0), jnp.full(N, 120.0))
    Rb, sb, tb_ = _rot(rng, 25.0), 0.6, np.array([3.0, 1.0, -2.0])  # frame b = Sim3 of the world

    def child(cams, to_frame, pose_to_frame):
        tracks = []
        for s in range(Tn):
            obs = []
            for c in rng.choice(cams, rng.integers(2, 5), replace=False):
                pc = R[c].T @ (X[s] - t[c])
                obs.append((int(c), F * pc[:2] / pc[2] + np.array([160.0, 120.0]) + rng.normal(0, 0.3, 2)))
            tracks.append((to_frame(X[s] + rng.normal(0, 0.03, 3)), obs))
        Rc, tc = pose_to_frame(R, t)
        Rc = np.einsum("nij,njk->nik", Rc, np.stack([_rot(rng, 0.2) for _ in range(N)])).astype(np.float32)
        tc = (tc + rng.normal(0, 0.02, tc.shape)).astype(np.float32)
        mask = np.zeros(N, bool)
        mask[cams] = True
        return JSfmData.from_cameras_and_tracks(JSE3(R=jnp.asarray(Rc), t=jnp.asarray(tc)), cal, tracks,
                                                pose_mask=mask, pad_tracks_to=256, pad_meas_to=1024)

    data_a = child(np.arange(6), lambda x: x, lambda R_, t_: (R_, t_))
    data_b = child(np.arange(6, 12), lambda x: sb * Rb @ x + tb_,
                   lambda R_, t_: (np.einsum("ij,njk->nik", Rb, R_), sb * t_ @ Rb.T + tb_))
    ta = tb = np.arange(Tn, dtype=np.int64)
    pa = np.asarray(data_a.points)[ta]
    pb = np.asarray(data_b.points)[tb].copy()
    pb[::7] += 5.0  # a few wrong pairs
    return data_a, data_b, (pa, pb, ta, tb)


def _angle_rad(Ra, Rb):
    M = np.einsum("nji,njk->nik", np.asarray(Ra, np.float64), np.asarray(Rb, np.float64))
    v = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return np.arctan2(0.5 * np.linalg.norm(v, axis=-1), 0.5 * (np.trace(M, axis1=1, axis2=2) - 1.0))


def _sim3_to_port(sim_j):
    return Sim3(R=torch.tensor(np.asarray(sim_j.R)), t=torch.tensor(np.asarray(sim_j.t)),
                s=torch.tensor(np.asarray(sim_j.s)))


def test_concatenate_and_compact_match_reference():
    rng = np.random.default_rng(1)
    data_a, data_b, (pa, pb, ta, tb) = _children(rng)
    sim_j, inl, _ = jmerge.sim3_from_point_pairs(pa, pb)
    inl = np.asarray(inl)
    pairs = np.stack([ta[inl], tb[inl]], -1)
    pairs = np.concatenate([pairs, np.stack([pairs[3:6, 0], pairs[:3, 1]], -1)])  # b tracks listed twice
    cat_j = jmerge.concatenate_scenes(data_a, data_b, sim_j, merge_track_pairs=pairs)
    a_t, b_t = (convert.sfm_data(jax.tree.map(np.asarray, d)) for d in (data_a, data_b))
    cat_t = merge.concatenate_scenes(a_t, b_t, _sim3_to_port(sim_j), merge_track_pairs=pairs)
    for k in ("pose_mask", "track_mask", "meas_cam", "meas_track", "meas_mask"):
        np.testing.assert_array_equal(getattr(cat_t, k).numpy(), np.asarray(getattr(cat_j, k)), err_msg=k)
    for got, want in ((cat_t.points, cat_j.points), (cat_t.poses.t, cat_j.poses.t), (cat_t.poses.R, cat_j.poses.R)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()))

    com_j, o2n_j = jmerge.compact_tracks(cat_j)
    com_t, o2n_t = merge.compact_tracks(cat_t)
    np.testing.assert_array_equal(o2n_t, o2n_j)
    nt, nm = com_t.max_tracks, com_t.meas_mask.shape[0]  # the reference pads on to a power of two
    assert nt == int((o2n_j >= 0).sum()) and np.asarray(com_j.track_mask)[nt:].sum() == 0
    assert np.asarray(com_j.meas_mask)[nm:].sum() == 0
    for k in ("track_mask", "meas_cam", "meas_track", "meas_mask"):
        n = nt if k == "track_mask" else nm
        np.testing.assert_array_equal(getattr(com_t, k).numpy(), np.asarray(getattr(com_j, k))[:n], err_msg=k)
    np.testing.assert_allclose(com_t.points.numpy(), np.asarray(com_j.points)[:nt], atol=1e-5 * 10)


def test_run_compact_matches_reference():
    rng = np.random.default_rng(2)
    data_a, _, _ = _children(rng)
    fixed = np.zeros(data_a.max_cameras, bool)
    fixed[2] = True
    out_j, m_j = JBA(JBAOptions(max_iterations=15, cg_iterations=30, layout="dense")).run_compact(
        data_a, fixed_cam=jnp.asarray(fixed))
    out_t, m_t = BundleAdjustment(BAOptions(max_iterations=15, cg_iterations=30, layout="dense")).run_compact(
        convert.sfm_data(jax.tree.map(np.asarray, data_a)), fixed_cam=torch.as_tensor(fixed))
    live = np.asarray(data_a.pose_mask)
    assert _angle_rad(out_t.poses.R.numpy()[live], np.asarray(out_j.poses.R)[live]).max() < 1e-4
    t_j = np.asarray(out_j.poses.t)
    np.testing.assert_allclose(out_t.poses.t.numpy(), t_j, atol=1e-4 * np.abs(t_j).max())
    np.testing.assert_array_equal(out_t.poses.R.numpy()[~live], np.asarray(data_a.poses.R)[~live])
    assert abs(m_t["final_cost"] - m_j["final_cost"]) <= 1e-3 * abs(m_j["final_cost"])
    assert m_t["final_cost"] < m_t["initial_cost"]


def test_merge_children_with_parent_ba_matches_reference():
    rng = np.random.default_rng(3)
    data_a, data_b, (pa, pb, ta, tb) = _children(rng)
    merged_j, m_j = jmerge.merge_children(data_a, data_b, (pa, pb, ta, tb))
    a_t, b_t = (convert.sfm_data(jax.tree.map(np.asarray, d)) for d in (data_a, data_b))
    merged_t, m_t = merge.merge_children(a_t, b_t, (torch.as_tensor(pa), torch.as_tensor(pb), ta, tb))
    np.testing.assert_array_equal(m_t["sim3_inlier_mask"], m_j["sim3_inlier_mask"])
    np.testing.assert_array_equal(m_t["track_old2new"], m_j["track_old2new"])
    assert merged_t.number_images() == merged_j.number_images() == 12
    assert _angle_rad(merged_t.poses.R.numpy(), np.asarray(merged_j.poses.R)).max() < 1e-4
    t_j = np.asarray(merged_j.poses.t)
    np.testing.assert_allclose(merged_t.poses.t.numpy(), t_j, atol=1e-4 * np.abs(t_j).max())
    nt = merged_t.max_tracks
    np.testing.assert_array_equal(merged_t.track_mask.numpy(), np.asarray(merged_j.track_mask)[:nt])
    assert m_t["merged_tracks"] == m_j["merged_tracks"]


# ---------------------------------------------------------------------------
# hierarchical
# ---------------------------------------------------------------------------
@threads(4)
def test_hierarchical_matches_reference_on_its_test_inputs():
    n_cams = 10
    scene, pairs, batch = make_pair_batch(n_cams=n_cams, n_pts=200, desc_noise=0.01, seed=11)
    res = j_two_view(**batch, key=jax.random.PRNGKey(0),
                     opts=JTwoViewOptions(ransac=JRansacOptions(num_hypotheses=256)))
    kp_xy = np.zeros((n_cams, 200, 2), np.float32)
    for e, (i, j) in enumerate(pairs):
        kp_xy[i] = np.asarray(batch["kp_xy1"][e])
        kp_xy[j] = np.asarray(batch["kp_xy2"][e])
    tvr = {k: np.asarray(getattr(res, k)) for k in
           ("i2Ri1", "i2Ui1", "valid", "num_inliers", "corr_i1", "corr_i2", "corr_mask")}

    hier_j = JHier(JHierOptions(max_depth=1, max_cluster_size=4))
    data_j, m_j = hier_j.run(n_cams, pairs, tvr, kp_xy, scene.cal)
    hier_t = HierarchicalReconstruction(HierarchicalOptions(max_depth=1, max_cluster_size=4))
    cal_t = convert.cal3_bundler(jax.tree.map(np.asarray, scene.cal))
    data_t, m_t = hier_t.run(n_cams, pairs, tvr, kp_xy, cal_t)

    assert not m_t.get("failed") and not m_j.get("failed"), (m_t, m_j)
    assert m_t["partitioner"] == "metis"
    assert (m_t["num_clusters"], m_t["tree_nodes"]) == (m_j["num_clusters"], m_j["tree_nodes"])
    assert m_t["num_clusters"] >= 2
    assert [p for p, _ in hier_t.node_results] == [p for p, _ in hier_j.node_results]
    assert hier_t.node_results[-1][0] == ()
    assert data_j.number_images() >= n_cams - 1
    assert data_t.number_images() >= n_cams - 1, m_t

    gt = convert.se3(jax.tree.map(np.asarray, scene.poses))
    est = data_t.pose_mask
    sim = align_poses_sim3(data_t.poses, gt, mask=est)
    aligned = sim.transform_pose(data_t.poses)
    r_err = so3.relative_angle_deg(aligned.R, gt.R).numpy()[est.numpy()]
    t_err = torch.linalg.vector_norm(aligned.t - gt.t, dim=-1).numpy()[est.numpy()]
    assert r_err.max() < 2.0, r_err
    assert t_err.max() < 0.3, t_err
