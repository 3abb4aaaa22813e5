"""The port's bundle adjustment against the JAX reference, the scenarios
of tests/bundle/test_ba.py on a Cal3Bundler ring (8 cameras, 60 points,
0.5 px noise, perturbed start), each in one layout and held against the
same layout of the reference: Huber with gross outliers and frozen
cameras, GNC with the weight filter, per-camera intrinsics under the
calibration prior. Final cost, poses, points and calibrations agree to 1e-4
relative + 1e-4 absolute (points 1e-3): float32 sums in another order
through a 30-40 step LM. The pose priors and gauges are in
test_torch_ba_priors.py, the shared calibration and the other models in
test_torch_ba_models.py, the layouts and fallbacks in
test_torch_ba_layouts.py. Each reference solve compiles anew (about 7 s on
the CPU), so each scenario holds several features.
"""

import numpy as np

from tests.torch_ba_scenes import assert_same_solve, ring_scene, solve_both, with_uv
from tests.torch_threads import cap_threads

cap_threads()


def test_huber_with_outliers_and_frozen_cameras_matches_reference():
    data = with_uv(ring_scene(seed=2, pose_sigma=0.01, point_sigma=0.02, n_anchors=2),
                   lambda uv: uv.__setitem__(slice(None, None, 29), uv[::29] + 80.0))
    fixed = np.zeros(8, bool)
    fixed[[0, 5]] = True
    ref, port = solve_both(data, fixed, max_iterations=30, robust_huber_px=2.0, layout="scatter")
    assert_same_solve(ref, port)
    out_t = port[0]
    for name in ("R", "t"):  # frozen cameras do not move
        np.testing.assert_array_equal(getattr(out_t.poses, name).numpy()[fixed], np.asarray(getattr(data.poses, name))[fixed])


def test_gnc_weight_filter_matches_reference():
    data = with_uv(ring_scene(seed=7, pose_sigma=0.01, point_sigma=0.02),
                   lambda uv: uv.__setitem__(slice(None, None, 13), uv[::13] + 120.0))
    fixed = np.zeros(8, bool)
    fixed[0] = True
    ref, port = solve_both(data, fixed, max_iterations=40, robust_mode="gnc_gm", robust_huber_px=3.0,
                           gnc_weight_threshold=0.25, layout="entry")
    assert_same_solve(ref, port)
    (out_j, m_j), (out_t, m_t) = ref, port
    np.testing.assert_array_equal(out_t.meas_mask.numpy(), np.asarray(out_j.meas_mask))
    np.testing.assert_array_equal(out_t.track_mask.numpy(), np.asarray(out_j.track_mask))
    assert m_t["gnc_measurements_removed"] == m_j["gnc_measurements_removed"] >= len(range(0, 13 * 10, 13)) // 2
    assert not out_t.meas_mask.numpy()[::13].any()


def test_intrinsics_with_calibration_prior_match_reference():
    # noise-free, poses and points at the truth, as the reference's intrinsics
    # tests: the focal and the radial terms are then determined (with noise
    # their near-degeneracy leaves a flat valley that float32 stops in
    # anywhere); the calibration prior holds the focals partway
    data = ring_scene(seed=11, noise=0.0, pose_sigma=0.0, point_sigma=0.0, n_anchors=8)
    data = data.replace(cal=data.cal.replace(f=data.cal.f * 1.03))
    fixed = np.zeros(8, bool)
    fixed[:2] = True
    ref, port = solve_both(data, fixed, max_iterations=40, optimize_intrinsics=True, cal_prior_weight=1.0,
                           layout="dense")
    assert_same_solve(ref, port, cal=True)
    f0, f = np.asarray(data.cal.f), port[0].cal.f.numpy()
    np.testing.assert_array_equal(f[:2], f0[:2])  # frozen cameras keep theirs
    assert np.all(f[2:] < f0[2:])  # moved toward the true 500, held by the prior
