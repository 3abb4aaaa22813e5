"""Port back-end stages against the JAX reference on one synthetic scene.

A 10-camera ring with seeded numpy noise feeds both packages:
- rotation averaging (chordal init, staircase + certificate, robust GN):
  1e-4 rad per camera; the re-refine after an outlier edge, see its test;
- translation averaging with camera->track directions, the LUD start
  replayed from the reference's jax.random draw: 1e-3 relative;
- RANSAC-DLT triangulation with the reference's uniforms replayed: points
  1e-4 relative, inlier / ok masks equal;
- dense-Schur BA run_staged: poses 1e-4 (rotations) and 1e-4 relative
  (centers), final cost 1e-3 relative.
Tolerances are float32 round-off carried through iterative solvers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gtsfm_tpu.averaging.rotation.averaging import RotationAveraging as JRA
from gtsfm_tpu.averaging.translation.averaging import TranslationAveraging as JTA
from gtsfm_tpu.bundle.ba import BAOptions as JBAOptions, BundleAdjustment as JBA
from gtsfm_tpu.bundle.triangulation import TriangulationMode as JMode, triangulate_tracks as j_tri
from gtsfm_tpu.common.sfm_data import SfmData as JSfmData
from gtsfm_tpu.geometry import SE3 as JSE3, Cal3Bundler as JCal, so3 as jso3
from gtsfm_tpu.loader.synthetic import spectral_ring_poses as j_ring
from gtsfm_tpu_torch.averaging.rotation.averaging import RotationAveraging
from gtsfm_tpu_torch.averaging.translation.averaging import TranslationAveraging
from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment
from gtsfm_tpu_torch.bundle.triangulation import triangulate_tracks
from gtsfm_tpu_torch.utils import convert

N = 10
F = 300.0


def _scene():
    edges = np.asarray(sorted({(min(i, (i + k) % N), max(i, (i + k) % N))
                               for i in range(N) for k in (1, 2, 3)}), np.int64)
    gt = j_ring(edges, N)
    R = np.array(gt.R)
    t = np.array(gt.t)
    return edges, R, t


def _rot(w):
    return np.asarray(jso3.expmap(jnp.asarray(w, jnp.float32)))


def _angle_rad(Ra, Rb):
    """Angle of Ra^T Rb in float64 (float32 arccos near 1 resolves only
    ~3e-4 rad)."""
    M = np.einsum("nji,njk->nik", np.asarray(Ra, np.float64), np.asarray(Rb, np.float64))
    v = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return np.arctan2(0.5 * np.linalg.norm(v, axis=-1), 0.5 * (np.trace(M, axis1=1, axis2=2) - 1.0))


def _ra_inputs(outlier: bool):
    rng = np.random.default_rng(0)
    edges, R, _ = _scene()
    E = len(edges)
    rel = np.einsum("eji,ejk->eik", R[edges[:, 1]], R[edges[:, 0]])
    noise = _rot(rng.normal(0, np.radians(0.5), (E, 3)))
    i2Ri1 = np.einsum("eij,ejk->eik", noise, rel).astype(np.float32)
    if outlier:
        i2Ri1[4] = _rot([0.0, np.radians(30.0), 0.0]) @ i2Ri1[4]
    num_inliers = rng.integers(50, 200, E)
    edge_mask = np.ones(E, bool)
    edge_mask[7] = False
    return edges, i2Ri1, num_inliers, edge_mask


def test_rotation_averaging_matches_reference():
    edges, i2Ri1, num_inliers, edge_mask = _ra_inputs(outlier=False)
    wRi_j, valid_j = JRA().run(N, edges, i2Ri1, num_inliers=num_inliers, edge_mask=edge_mask)
    wRi_t, valid_t = RotationAveraging().run(N, edges, torch.as_tensor(i2Ri1),
                                             num_inliers=num_inliers, edge_mask=edge_mask)
    np.testing.assert_array_equal(valid_t, valid_j)
    assert _angle_rad(wRi_t.numpy(), np.asarray(wRi_j, np.float32)).max() < 1e-4


def test_rotation_averaging_rerefine_drops_the_outlier_edge():
    """With a 30 degree outlier edge, both drop it in the re-refine. The
    reference's LM solves with the gauge unanchored (node 0 zeroed after
    the solve), so it converges linearly here and float32 order differences
    leave the two endpoints ~1e-3 rad apart (measured: the reference itself
    moves 1.2e-3 rad more when re-run from its own result). Held to 5e-3
    rad and to the same robust cost within 1%."""
    edges, i2Ri1, num_inliers, edge_mask = _ra_inputs(outlier=True)
    wRi_j, valid_j = JRA().run(N, edges, i2Ri1, num_inliers=num_inliers, edge_mask=edge_mask)
    wRi_t, valid_t = RotationAveraging().run(N, edges, torch.as_tensor(i2Ri1),
                                             num_inliers=num_inliers, edge_mask=edge_mask)
    np.testing.assert_array_equal(valid_t, valid_j)
    wRi_j = np.asarray(wRi_j, np.float32)
    assert _angle_rad(wRi_t.numpy(), wRi_j).max() < 5e-3

    def edge_angles(wRi):
        rel = np.einsum("eji,ejk->eik", wRi[edges[:, 1]], wRi[edges[:, 0]])
        return _angle_rad(i2Ri1.astype(np.float64), rel)

    a_j, a_t = edge_angles(wRi_j), edge_angles(wRi_t.numpy())
    assert a_j[4] > np.radians(25) and a_t[4] > np.radians(25)  # the outlier stays unexplained
    keep = edge_mask & (np.arange(len(edges)) != 4)
    assert abs(np.sum(a_t[keep] ** 2) - np.sum(a_j[keep] ** 2)) < 0.01 * np.sum(a_j[keep] ** 2)


def _track_dirs(rng, R, t):
    """Camera->landmark directions for 6 landmarks + 2 weight-0 padding
    entries on the sentinel node (the multi-view optimizer's layout)."""
    X = rng.uniform(-3, 3, (6, 3))
    cams, nodes, dirs = [], [], []
    for s in range(6):
        for c in rng.choice(N, 4, replace=False):
            d = X[s] - t[c]
            cams.append(c)
            nodes.append(s)
            dirs.append(d / np.linalg.norm(d))
    cams += [0, 0]
    nodes += [7, 7]
    dirs += [[0, 0, 1], [0, 0, 1]]
    wts = np.r_[np.ones(len(cams) - 2), np.zeros(2)]
    return (np.asarray(cams, np.int32), np.asarray(nodes, np.int32),
            np.asarray(dirs, np.float32), wts.astype(np.float32))


def test_translation_averaging_matches_reference_on_replayed_start():
    rng = np.random.default_rng(1)
    edges, R, t = _scene()
    d = np.einsum("eji,ej->ei", R[edges[:, 1]], t[edges[:, 0]] - t[edges[:, 1]])
    d += rng.normal(0, 0.02, d.shape)
    i2Ui1 = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    i2Ui1[3] = -i2Ui1[3]  # one flipped direction
    edge_mask = np.ones(len(edges), bool)
    dirs = _track_dirs(rng, R, t)
    n_nodes = N + int(dirs[1].max()) + 1

    t_j, valid_j, inl_j = JTA().run(N, edges, i2Ui1, R.astype(np.float32), edge_mask=edge_mask,
                                    seed=0, track_dirs=dirs)
    t0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (n_nodes, 3)) * 0.1)
    t_t, valid_t, inl_t = TranslationAveraging().run(
        N, edges, torch.as_tensor(i2Ui1), torch.as_tensor(R.astype(np.float32)),
        edge_mask=edge_mask, seed=0, track_dirs=dirs, t0=torch.as_tensor(t0),
    )
    np.testing.assert_array_equal(inl_t, inl_j)
    np.testing.assert_array_equal(valid_t, valid_j)
    t_t = t_t.numpy()
    assert np.linalg.norm(t_t - t_j) / np.linalg.norm(t_j) < 1e-3


def test_triangulation_matches_reference_on_replayed_uniforms():
    rng = np.random.default_rng(2)
    _, R, t = _scene()
    T, L, H = 32, 5, 32
    X = rng.uniform(-3, 3, (T, 3))
    track_cam = np.stack([rng.choice(N, L, replace=False) for _ in range(T)]).astype(np.int32)
    p_cam = np.einsum("tkji,tkj->tki", R[track_cam], X[:, None] - t[track_cam])
    uv = F * p_cam[..., :2] / p_cam[..., 2:] + np.array([160.0, 120.0]) + rng.normal(0, 0.5, (T, L, 2))
    uv[0, 2] += 40.0  # an outlier observation
    track_mask = rng.random((T, L)) > 0.15
    track_mask[1, 1:] = False  # a single-view track
    uv = uv.astype(np.float32)
    cal_np = {k: np.full(N, v, np.float32) for k, v in (("f", F), ("k1", 0.0), ("k2", 0.0),
                                                        ("u0", 160.0), ("v0", 120.0))}
    key = jax.random.PRNGKey(3)
    pts_j, inl_j, ok_j = (np.asarray(a) for a in j_tri(
        JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), JCal(**{k: jnp.asarray(v) for k, v in cal_np.items()}),
        jnp.asarray(track_cam), jnp.asarray(uv), jnp.asarray(track_mask), key,
        reproj_threshold_px=10.0, num_hypotheses=H, mode=JMode.RANSAC_SAMPLE_UNIFORM,
        min_triangulation_angle_deg=1.0,
    ))
    n_pairs = L * (L - 1) // 2
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (H, n_pairs), minval=1e-12, maxval=1.0))(
        jax.random.split(key, T)))
    pts_t, inl_t, ok_t = triangulate_tracks(
        convert.se3({"R": R, "t": t}), convert.cal3_bundler(cal_np),
        torch.as_tensor(track_cam, dtype=torch.int64), torch.as_tensor(uv), torch.as_tensor(track_mask),
        reproj_threshold_px=10.0, num_hypotheses=H, min_triangulation_angle_deg=1.0,
        uniforms=torch.as_tensor(u),
    )
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    # inliers of failed tracks come from rank-deficient DLTs (free eigenvector)
    np.testing.assert_array_equal(inl_t.numpy()[ok_j], inl_j[ok_j])
    assert ok_j.sum() > T // 2 and not ok_j[1]
    np.testing.assert_allclose(pts_t.numpy()[ok_j], pts_j[ok_j], rtol=1e-4, atol=1e-4)


def _ba_scene(rng):
    _, R, t = _scene()
    Tn = 120
    X = rng.uniform(-3, 3, (Tn, 3))
    tracks = []
    for s in range(Tn):
        obs = []
        for c in rng.choice(N, rng.integers(2, 7), replace=False):
            pc = R[c].T @ (X[s] - t[c])
            obs.append((int(c), F * pc[:2] / pc[2] + np.array([160.0, 120.0]) + rng.normal(0, 0.3, 2)))
        tracks.append((X[s] + rng.normal(0, 0.05, 3), obs))
    tracks[5][1][0] = (tracks[5][1][0][0], tracks[5][1][0][1] + 25.0)  # an outlier measurement
    R0 = np.einsum("nij,njk->nik", R, _rot(rng.normal(0, np.radians(0.3), (N, 3)))).astype(np.float32)
    t0 = (t + rng.normal(0, 0.05, t.shape)).astype(np.float32)
    cal = JCal.create(jnp.full(N, F), jnp.zeros(N), jnp.zeros(N), jnp.full(N, 160.0), jnp.full(N, 120.0))
    return JSfmData.from_cameras_and_tracks(JSE3(R=jnp.asarray(R0), t=jnp.asarray(t0)), cal, tracks,
                                            pad_tracks_to=128, pad_meas_to=512)


def test_dense_ba_run_staged_matches_reference():
    rng = np.random.default_rng(4)
    data_j = _ba_scene(rng)
    fixed = np.zeros(N, bool)
    fixed[0] = True
    out_j, m_j = JBA(JBAOptions(max_iterations=30, cg_iterations=40, layout="dense")).run_staged(
        data_j, fixed_cam=jnp.asarray(fixed))
    data_t = convert.sfm_data(jax.tree.map(np.asarray, data_j))
    out_t, m_t = BundleAdjustment(BAOptions(max_iterations=30)).run_staged(
        data_t, fixed_cam=torch.as_tensor(fixed))
    assert _angle_rad(out_t.poses.R.numpy(), np.asarray(out_j.poses.R)).max() < 1e-4
    t_j = np.asarray(out_j.poses.t)
    np.testing.assert_allclose(out_t.poses.t.numpy(), t_j, atol=1e-4 * np.abs(t_j).max())
    np.testing.assert_array_equal(out_t.track_mask.numpy(), np.asarray(out_j.track_mask))
    c_j, c_t = m_j[-1]["final_cost"], m_t[-1]["final_cost"]
    assert abs(c_t - c_j) <= 1e-3 * abs(c_j)
    assert c_j < m_j[0]["initial_cost"]


def test_convert_round_trips_reference_state():
    """Reference pytrees as numpy -> port tensors -> numpy, unchanged."""
    rng = np.random.default_rng(5)
    data_np = jax.tree.map(np.asarray, _ba_scene(rng))
    data_t = convert.sfm_data(data_np)
    back = convert.to_numpy(data_t)
    for name in ("pose_mask", "points", "track_mask", "meas_cam", "meas_track", "meas_uv", "meas_mask"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(data_np, name)))
    np.testing.assert_array_equal(back["poses"]["R"], data_np.poses.R)
    np.testing.assert_array_equal(back["cal"]["f"], data_np.cal.f)
    assert data_t.meas_cam.dtype == torch.int64 and data_t.points.dtype == torch.float32
    tv = {"i2Ri1": rng.normal(size=(3, 3, 3)), "i2Ui1": rng.normal(size=(3, 3)),
          "corr_i1": np.zeros((3, 8), np.int32), "corr_i2": np.ones((3, 8), np.int32),
          "corr_mask": rng.random((3, 8)) > 0.5, "num_matches": np.arange(3, dtype=np.int32),
          "num_inliers": np.arange(3, dtype=np.int32), "inlier_ratio": np.ones(3, np.float32),
          "valid": np.ones(3, bool)}
    tv_t = convert.two_view_result(tv)
    assert tv_t["i2Ri1"].dtype == torch.float32 and tv_t["corr_mask"].dtype == torch.bool
    for k, v in convert.to_numpy(tv_t).items():
        np.testing.assert_allclose(v, tv[k], rtol=1e-6)
