"""The port's bundle adjustment on the other calibration models, against
the JAX reference, each with one shared calibration optimized (an exact
Schur variable): Cal3DS2 and Cal3Fisheye in entry, Cal3_S2 in dense.
Final cost, poses, points and calibrations agree to 1e-4 relative + 1e-4
absolute (points 1e-3). The
fisheye's k3 and k4 move a pixel by under 1e-4 px at this field of view,
so its calibration is compared through the pixels it gives (uncalibrate on
a grid, 1e-4 relative). Per-camera intrinsics of these models are too
ill-conditioned on an 8-camera ring to compare (the solves stall in a flat
valley at different points); Cal3Bundler's are compared in
test_torch_ba.py. Asking for dense with Cal3DS2 runs entry
(``layout_counts``), with the result of asking for entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gtsfm_tpu_torch.bundle import ba
from tests.torch_ba_scenes import assert_same_solve, ring_scene, solve_both, to_port
from tests.torch_threads import cap_threads

cap_threads()

FIXED = np.arange(8) == 0


def _shared_cal_scene(model, seed, **scale):
    """Poses and points at the truth, noise-free, the calibration of every
    camera scaled by ``scale`` (the reference's intrinsics scenario)."""
    data = ring_scene(model, seed=seed, noise=0.0, pose_sigma=0.0, point_sigma=0.0, n_anchors=8)
    return data.replace(cal=data.cal.replace(**{k: getattr(data.cal, k) * v for k, v in scale.items()}))


def test_cal3ds2_with_shared_calibration_matches_reference():
    data = _shared_cal_scene("Cal3DS2", 21, fx=1.02, k1=0.8)
    ref, port = solve_both(data, np.arange(8) < 2, max_iterations=20, optimize_intrinsics=True,
                           shared_intrinsics=True, layout="entry")
    assert_same_solve(ref, port, cal=True)


def test_cal3ds2_dense_request_runs_entry():
    data = to_port(ring_scene("Cal3DS2", seed=21))
    fixed = torch.as_tensor(FIXED)
    ba.layout_counts.clear()
    out_d, m_d = ba.BundleAdjustment(ba.BAOptions(max_iterations=5, layout="dense")).run(data, fixed_cam=fixed)
    assert dict(ba.layout_counts) == {"entry": 1}
    out_e, m_e = ba.BundleAdjustment(ba.BAOptions(max_iterations=5, layout="entry")).run(data, fixed_cam=fixed)
    assert m_d["final_cost"] == m_e["final_cost"] and torch.equal(out_d.poses.t, out_e.poses.t)


def test_cal3_s2_with_shared_calibration_matches_reference():
    data = _shared_cal_scene("Cal3_S2", 22, fx=1.02, fy=0.99)
    ref, port = solve_both(data, np.arange(8) < 2, max_iterations=25, optimize_intrinsics=True,
                           shared_intrinsics=True, layout="dense")
    assert_same_solve(ref, port, cal=True)


def test_cal3_fisheye_with_intrinsics_matches_reference():
    data = _shared_cal_scene("Cal3Fisheye", 23, fx=1.02)
    ref, port = solve_both(data, np.arange(8) < 2, max_iterations=25, optimize_intrinsics=True,
                           shared_intrinsics=True, layout="entry")
    assert_same_solve(ref, port)
    grid = np.stack(np.meshgrid(np.linspace(-0.4, 0.4, 9), np.linspace(-0.3, 0.3, 7)), -1).reshape(-1, 2)
    q = grid.astype(np.float32)[None]
    uv_j = np.asarray(jax.tree.map(lambda a: a[:, None], ref[0].cal).uncalibrate(jnp.asarray(q)))
    uv_t = port[0].cal.map(lambda a: a[:, None]).uncalibrate(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(uv_t, uv_j, rtol=1e-4)
