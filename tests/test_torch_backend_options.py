"""The port's back-end options against the JAX reference.

On the 10-camera ring of tests/test_torch_backend.py, with seeded numpy
noise:
- triangulation in each of the four modes (the sampling modes' uniforms
  replayed): ok masks equal, inliers of ok tracks equal, points to 1e-4
  relative;
- rotation averaging with uniform edge weights: 1e-4 rad per camera;
  ``certify_rotation_solution`` at the averaged and at a perturbed
  solution: the same verdict, least eigenvalues to 1e-6 of the largest;
- translation averaging without outlier rejection, with camera-only MFAS
  and measurement-seeded projection directions (bit-equal numpy draws),
  and rig-constrained (5 rigs of two cameras with known offsets), the LUD
  start replayed: inlier edges equal, positions to 1e-3 relative (1e-2
  where a flipped edge stays in the solve, see the test);
- ``configs.config``: every option this slice adds, set away from its
  default, builds the same option tree as the reference; an unknown field
  raises;
- the slice as a whole: ``run_two_view_batch`` (draws replayed) then
  ``MultiViewOptimizer.run`` with the chip phase's option set on an
  8-camera ring of the descriptor feed: the same valid pairs, the same
  edges after the one-pass cycle filter, the same registered cameras with
  rotations within 5e-3 rad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.averaging.rotation.averaging import (
    RotationAveraging as JRA,
    RotationAveragingOptions as JRAOptions,
    certify_rotation_solution as j_certify,
)
from gtsfm_tpu.averaging.translation.averaging import (
    TranslationAveraging as JTA,
    TranslationAveragingOptions as JTAOptions,
)
from gtsfm_tpu.bundle.triangulation import TriangulationMode as JMode, triangulate_tracks as j_tri
from gtsfm_tpu.configs import config as j_config
from gtsfm_tpu.frontend.two_view import TwoViewOptions as JTwoViewOptions, run_two_view_batch as j_two_view
from gtsfm_tpu.frontend.verifiers.essential import RansacOptions as JRansacOptions
from gtsfm_tpu.geometry import SE3 as JSE3, Cal3Bundler as JCal
from gtsfm_tpu.loader.synthetic import spectral_ring_poses as j_ring
from gtsfm_tpu.scene.mvo import MultiViewOptimizer as JMVO, MVOOptions as JMVOOptions
from gtsfm_tpu_torch.averaging.rotation.averaging import (
    RotationAveraging,
    RotationAveragingOptions,
    certify_rotation_solution,
)
from gtsfm_tpu_torch.averaging.translation.averaging import TranslationAveraging, TranslationAveragingOptions
from gtsfm_tpu_torch.bundle.triangulation import TriangulationMode, triangulate_tracks
from gtsfm_tpu_torch.configs import config
from gtsfm_tpu_torch.frontend.two_view import TwoViewOptions, run_two_view_batch
from gtsfm_tpu_torch.frontend.verifiers.essential import RansacOptions
from gtsfm_tpu_torch.scene.mvo import MultiViewOptimizer, MVOOptions
from gtsfm_tpu_torch.utils import convert
from tests.test_torch_backend import N, _angle_rad, _ra_inputs, _rot, _scene, _track_dirs
from tests.test_torch_runner import _options_equal
from tests.test_torch_two_view_options import _replayed_draws
from tests.torch_threads import cap_threads

cap_threads()

F = 300.0


@pytest.mark.parametrize("mode", [m.name for m in TriangulationMode])
def test_triangulation_modes_match_reference(mode):
    rng = np.random.default_rng(2)
    _, R, t = _scene()
    T, L, H = 32, 5, 8  # 8 hypotheses < the 10 view pairs: top-K keeps the widest baselines
    X = rng.uniform(-3, 3, (T, 3))
    track_cam = np.stack([rng.choice(N, L, replace=False) for _ in range(T)]).astype(np.int32)
    p_cam = np.einsum("tkji,tkj->tki", R[track_cam], X[:, None] - t[track_cam])
    uv = F * p_cam[..., :2] / p_cam[..., 2:] + np.array([160.0, 120.0]) + rng.normal(0, 0.5, (T, L, 2))
    uv[0, 2] += 40.0  # an outlier observation
    uv[3, :2] += rng.normal(0, 30.0, (2, 2))  # two, on the same track
    track_mask = rng.random((T, L)) > 0.15
    track_mask[1, 1:] = False  # a single-view track
    uv = uv.astype(np.float32)
    cal_np = {k: np.full(N, v, np.float32) for k, v in (("f", F), ("k1", 0.0), ("k2", 0.0),
                                                        ("u0", 160.0), ("v0", 120.0))}
    key = jax.random.PRNGKey(3)
    pts_j, inl_j, ok_j = (np.asarray(a) for a in j_tri(
        JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), JCal(**{k: jnp.asarray(v) for k, v in cal_np.items()}),
        jnp.asarray(track_cam), jnp.asarray(uv), jnp.asarray(track_mask), key,
        reproj_threshold_px=10.0, num_hypotheses=H, mode=JMode[mode], min_triangulation_angle_deg=1.0,
    ))
    n_pairs = L * (L - 1) // 2
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (H, n_pairs), minval=1e-12, maxval=1.0))(
        jax.random.split(key, T)))
    pts_t, inl_t, ok_t = triangulate_tracks(
        convert.se3({"R": R, "t": t}), convert.cal3_bundler(cal_np),
        torch.as_tensor(track_cam, dtype=torch.int64), torch.as_tensor(uv), torch.as_tensor(track_mask),
        reproj_threshold_px=10.0, num_hypotheses=H, mode=TriangulationMode[mode], min_triangulation_angle_deg=1.0,
        uniforms=torch.as_tensor(u),
    )
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_array_equal(inl_t.numpy()[ok_j], inl_j[ok_j])
    assert ok_j.sum() > T // 2 and not ok_j[1]
    np.testing.assert_allclose(pts_t.numpy()[ok_j], pts_j[ok_j], rtol=1e-4, atol=1e-4)


def test_rotation_averaging_without_inlier_weights_and_certificate_match_reference():
    """Without the staircase (tests/test_torch_backend.py holds it), which
    saves the reference its compiles at p = 4..6."""
    edges, i2Ri1, num_inliers, edge_mask = _ra_inputs(outlier=False)
    opts = dict(weight_by_inliers=False, staircase_p_max=3)
    wRi_j, valid_j = JRA(JRAOptions(**opts)).run(N, edges, i2Ri1, num_inliers=num_inliers, edge_mask=edge_mask)
    wRi_t, valid_t = RotationAveraging(RotationAveragingOptions(**opts)).run(
        N, edges, torch.as_tensor(i2Ri1), num_inliers=num_inliers, edge_mask=edge_mask)
    np.testing.assert_array_equal(valid_t, valid_j)
    wRi_j = np.asarray(wRi_j, np.float32)
    assert _angle_rad(wRi_t.numpy(), wRi_j).max() < 1e-4

    w = edge_mask.astype(np.float64)
    perturbed = np.einsum("nij,njk->nik", wRi_j, _rot(np.random.default_rng(3).normal(0, 0.3, (N, 3))))
    for sol, certified in ((wRi_j, True), (perturbed, False)):
        ok_j, min_j = j_certify(N, edges, i2Ri1, w, sol)
        ok_t, min_t = certify_rotation_solution(N, edges, i2Ri1, w, sol)
        assert bool(ok_t) == bool(ok_j) == certified
        assert abs(min_t - min_j) < 1e-6 * max(1.0, abs(min_j))


def _ta_inputs():
    rng = np.random.default_rng(1)
    edges, R, t = _scene()
    d = np.einsum("eji,ej->ei", R[edges[:, 1]], t[edges[:, 0]] - t[edges[:, 1]])
    d += rng.normal(0, 0.02, d.shape)
    i2Ui1 = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    i2Ui1[3] = -i2Ui1[3]  # one flipped direction
    return edges, R, t, i2Ui1, _track_dirs(rng, R, t)


@pytest.mark.parametrize("variant", ["keep_outliers", "camera_mfas_seeded_dirs", "rig"])
def test_translation_averaging_options_match_reference_on_replayed_start(variant):
    edges, R, t, i2Ui1, dirs = _ta_inputs()
    opts, rig = {}, {}
    if variant == "keep_outliers":
        opts = dict(reject_outliers=False)
    elif variant == "camera_mfas_seeded_dirs":
        opts = dict(mfas_include_tracks=False, mfas_uniform_sampling=False)
    else:
        # cameras 2k and 2k+1 share a rig body placed at camera 2k
        rig_of = np.arange(N) // 2
        rig = dict(rig_of=rig_of, rig_offsets=(t - t[2 * rig_of]).astype(np.float32))
    n_nodes = (N // 2 if rig else N) + int(dirs[1].max()) + 1
    edge_mask = np.ones(len(edges), bool)
    t_j, valid_j, inl_j = JTA(JTAOptions(**opts)).run(N, edges, i2Ui1, R.astype(np.float32), edge_mask=edge_mask,
                                                      seed=0, track_dirs=dirs, **rig)
    t0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (n_nodes, 3)) * 0.1)
    t_t, valid_t, inl_t = TranslationAveraging(TranslationAveragingOptions(**opts)).run(
        N, edges, torch.as_tensor(i2Ui1), torch.as_tensor(R.astype(np.float32)), edge_mask=edge_mask, seed=0,
        track_dirs=dirs, t0=torch.as_tensor(t0), **rig)
    np.testing.assert_array_equal(inl_t, inl_j)
    np.testing.assert_array_equal(valid_t, valid_j)
    assert (variant == "keep_outliers") == bool(inl_j.all())
    # with the flipped edge left in the solve (both variants but the rig's)
    # the Huber GN ends in a flat valley: each package stops moving (the
    # same to 1e-7 after 100 and 300 steps) 1.4e-3 to 3.7e-3 apart
    # (measured), so those variants are held to 1e-2
    tol = 1e-3 if rig else 1e-2
    assert bool(inl_j[3]) == (not rig)
    assert np.linalg.norm(t_t.numpy() - t_j) / np.linalg.norm(t_j) < tol
    if rig:  # the offsets are metric: the solve has the true scale
        assert np.linalg.norm(t_j - t_j[0] - (t - t[0])) < 0.1 * np.linalg.norm(t - t[0])


OPTION_OVERRIDES = [
    "scene_optimizer.two_view.use_pallas_matcher=true",
    "scene_optimizer.two_view.run_two_view_ba=false",
    "scene_optimizer.two_view.homography_degeneracy_ratio=0.85",
    "scene_optimizer.two_view.homography_hypotheses=64",
    "scene_optimizer.two_view.indeterminacy_eig_ratio=1.0e-5",
    "scene_optimizer.two_view.ransac.scoring=lmeds",
    "scene_optimizer.mvo.run_view_graph_two_passes=false",
    "scene_optimizer.mvo.triangulation_mode=RANSAC_TOPK_BASELINES",
    "scene_optimizer.mvo.rotation.weight_by_inliers=false",
    "scene_optimizer.mvo.translation.reject_outliers=false",
    "scene_optimizer.mvo.translation.mfas_include_tracks=false",
    "scene_optimizer.mvo.translation.mfas_uniform_sampling=false",
]


def test_config_builds_every_new_option_as_the_reference():
    glue = ["matcher.name=lightglue", "matcher.use_pallas_attention=false", "matcher.num_layers=1",
            "matcher.dim=64", "matcher.num_heads=2"]
    so_t = config.build_scene_optimizer(config.load_config("unified", OPTION_OVERRIDES + glue +
                                                           ["scene_optimizer.device=cpu"]))
    so_j = j_config.build_scene_optimizer(j_config.load_config("unified", OPTION_OVERRIDES))
    _options_equal(so_t.options, so_j.options, "scene_optimizer")
    defaults = config.build_scene_optimizer(config.load_config("unified", ["scene_optimizer.device=cpu"])).options
    for ov in OPTION_OVERRIDES:
        path = ov.partition("=")[0].split(".")[1:]
        got, default = so_t.options, defaults
        for p in path:
            got, default = getattr(got, p), getattr(default, p)
        assert got != default, ov
    assert so_t.options.mvo.triangulation_mode is TriangulationMode.RANSAC_TOPK_BASELINES
    assert so_t.matcher.options.use_pallas_attention is False
    with pytest.raises(NotImplementedError, match="MVOOptions has no option 'triangulation'"):
        config.build_scene_optimizer(config.load_config("unified", ["scene_optimizer.mvo.triangulation=x"]))


SLICE_N, SLICE_K = 8, 256


def test_two_view_and_mvo_slice_matches_reference_with_the_option_set():
    """The chip phase's options (homography and indeterminacy checks,
    LMedS, top-K triangulation, one cycle-filter pass, uniform rotation
    weights, measurement-seeded MFAS directions) through both packages'
    two-view batch and multi-view optimizer on an 8-camera ring, 24 pairs
    (i, i+1..3)."""
    n, Kp = SLICE_N, SLICE_K
    pairs = chip_smoke.ring_pairs(n)
    gt = j_ring(pairs, n)
    R, t = np.array(gt.R), np.array(gt.t)
    kp_xy, kp_mask, descs = chip_smoke.descriptor_feed(R, t, chip_smoke.FOCAL, chip_smoke.IMAGE_HW, Kp)
    i1, i2 = pairs[:, 0], pairs[:, 1]
    batch = (kp_xy[i1], kp_xy[i2], descs[i1], descs[i2], kp_mask[i1], kp_mask[i2])
    E = len(pairs)
    cal_np = {"f": np.full(n, chip_smoke.FOCAL, np.float32), "k1": np.zeros(n, np.float32),
              "k2": np.zeros(n, np.float32), "u0": np.full(n, 160.0, np.float32), "v0": np.full(n, 120.0, np.float32)}
    cal_j = JCal(**{k: jnp.asarray(v) for k, v in cal_np.items()})
    cal_t = convert.cal3_bundler(cal_np)
    tv = dict(homography_degeneracy_ratio=0.85, indeterminacy_eig_ratio=1e-5)
    j_tv = JTwoViewOptions(ransac=JRansacOptions(scoring="lmeds"), **tv)
    key = jax.random.PRNGKey(0)
    pair_cal_j = JCal(**{k: jnp.asarray(v[i1]) for k, v in cal_np.items()}), \
        JCal(**{k: jnp.asarray(v[i2]) for k, v in cal_np.items()})
    ref = jax.tree.map(np.asarray, j_two_view(*(jnp.asarray(a) for a in batch), *pair_cal_j, jnp.ones(E, bool), key,
                                              opts=j_tv, pair_ids=jnp.arange(E, dtype=jnp.int32)))
    sidx, hidx = _replayed_draws(batch, key, j_tv)
    got = run_two_view_batch(*(torch.as_tensor(a) for a in batch), cal_t.map(lambda a: a[torch.as_tensor(i1)]),
                             cal_t.map(lambda a: a[torch.as_tensor(i2)]), torch.ones(E, dtype=torch.bool),
                             opts=TwoViewOptions(ransac=RansacOptions(scoring="lmeds"), **tv),
                             sample_idx=sidx, h_sample_idx=hidx)
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    assert ref.valid.sum() >= E - 2

    j_mvo = JMVOOptions(rotation=JRAOptions(weight_by_inliers=False),
                        translation=JTAOptions(mfas_uniform_sampling=False),
                        run_view_graph_two_passes=False, triangulation_mode=JMode.RANSAC_TOPK_BASELINES)
    t_mvo = MVOOptions(rotation=RotationAveragingOptions(weight_by_inliers=False),
                       translation=TranslationAveragingOptions(mfas_uniform_sampling=False),
                       run_view_graph_two_passes=False, triangulation_mode=TriangulationMode.RANSAC_TOPK_BASELINES)
    host = {k: np.asarray(getattr(ref, k)) for k in ("corr_i1", "corr_i2", "corr_mask")}
    data_j, m_j = JMVO(j_mvo).run(n, pairs, ref.i2Ri1, ref.i2Ui1, ref.valid, ref.num_inliers, host["corr_i1"],
                                  host["corr_i2"], host["corr_mask"], kp_xy, cal_j)
    data_t, m_t = MultiViewOptimizer(t_mvo).run(
        n, pairs, got.i2Ri1, got.i2Ui1, got.valid.numpy(), got.num_inliers.numpy(), got.corr_i1.numpy(),
        got.corr_i2.numpy(), got.corr_mask.numpy(), kp_xy, cal_t)
    assert m_t["num_edges_after_cycle_filter"] == m_j["num_edges_after_cycle_filter"]
    reg_j = np.asarray(data_j.pose_mask)
    np.testing.assert_array_equal(data_t.pose_mask.numpy(), reg_j)
    assert reg_j.sum() == n
    assert _angle_rad(data_t.poses.R.numpy(), np.asarray(data_j.poses.R)).max() < 5e-3
