"""The port's bundle-adjustment layouts against the JAX reference, and
its layout fallbacks.

- Each layout (scatter, entry, dense) on a padded Cal3Bundler ring against
  the same reference layout: final cost, poses and points to 1e-4
  relative + 1e-4 absolute (points 1e-3).
- Asking for dense with a track longer than 128 runs entry
  (``layout_counts``), with the result of asking for entry.
- ``run_compact`` leaves dense for scatter above 96 live cameras on the
  CPU, as the reference does there.
- ``densify_problem`` lays measurements out as the reference does, and
  raises the reference's ValueError past 128.
- The closed-form Jacobians of every model equal the port's own
  forward-mode autodiff of the residual to 1e-5 relative, and the stacked
  jvp of the pose priors equals the per-column one to 1e-6.
"""

import numpy as np
import pytest
import torch

from gtsfm_tpu.bundle.ba import densify_problem as j_densify, problem_from_sfm_data as j_problem
from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.geometry import PinholeCamera
from gtsfm_tpu_torch.utils.numerics import jacobian_fwd
from tests.torch_ba_scenes import assert_same_solve, ring_scene, solve_both, to_port
from tests.torch_threads import cap_threads

cap_threads()

FIXED = np.arange(8) == 0


@pytest.mark.parametrize("layout", ["scatter", "entry", "dense"])
def test_layouts_match_reference(layout):
    data = ring_scene(seed=7, pad_tracks=10, pad_meas=7)
    ref, port = solve_both(data, FIXED, max_iterations=20, cg_iterations=40, robust_huber_px=0.0, layout=layout)
    assert_same_solve(ref, port)


def _long_track_scene(n_cams: int) -> "ba.SfmData":
    """The port's SfmData of a ring of n_cams with one track seen by every
    camera (longer than the dense cap when n_cams > 128)."""
    data = ring_scene(n_cams=n_cams, n_tracks=40, seed=31, visible=0.1)
    meas_cam = np.concatenate([np.asarray(data.meas_cam), np.arange(n_cams)])
    meas_track = np.concatenate([np.asarray(data.meas_track), np.zeros(n_cams, np.int32)])
    port = to_port(data)
    pose, cal = port.poses, port.cal
    uv, _ = PinholeCamera(pose=pose, cal=cal).project(port.points[0].expand(n_cams, 3))
    return port.replace(meas_cam=torch.as_tensor(meas_cam), meas_track=torch.as_tensor(meas_track),
                        meas_uv=torch.cat([port.meas_uv, uv]),
                        meas_mask=torch.cat([port.meas_mask, torch.ones(n_cams, dtype=torch.bool)]))


def test_dense_falls_back_to_entry_above_128():
    data = _long_track_scene(140)
    fixed = torch.arange(140) == 0
    ba.layout_counts.clear()
    out_d, m_d = ba.BundleAdjustment(ba.BAOptions(max_iterations=3, layout="dense")).run(data, fixed_cam=fixed)
    assert dict(ba.layout_counts) == {"entry": 1}
    out_e, m_e = ba.BundleAdjustment(ba.BAOptions(max_iterations=3, layout="entry")).run(data, fixed_cam=fixed)
    assert m_d["final_cost"] == m_e["final_cost"] < m_d["initial_cost"]
    assert torch.equal(out_d.points, out_e.points)


@pytest.mark.parametrize("n_cams, layout", [(97, "scatter"), (96, "dense")])
def test_run_compact_switches_layout_by_size_on_the_cpu(n_cams, layout):
    data = to_port(ring_scene(n_cams=n_cams, n_tracks=40, seed=32, visible=0.1))
    ba.layout_counts.clear()
    _, m = ba.BundleAdjustment(ba.BAOptions(max_iterations=2, layout="dense")).run_compact(
        data, fixed_cam=torch.arange(n_cams) == 0)
    assert dict(ba.layout_counts) == {layout: 1} and m["final_cost"] <= m["initial_cost"]


def test_densify_problem_matches_reference():
    data = ring_scene(seed=33, pad_tracks=5, pad_meas=9)
    prob_j, L_j = j_densify(j_problem(data))
    prob_t, L_t = ba.densify_problem(ba.problem_from_sfm_data(to_port(data)))
    assert L_t == L_j
    for k in ("meas_cam", "meas_track", "meas_uv", "meas_w"):
        np.testing.assert_array_equal(getattr(prob_t, k).numpy(), np.asarray(getattr(prob_j, k)), err_msg=k)
    with pytest.raises(ValueError, match="exceeds dense layout"):
        ba.densify_problem(ba.problem_from_sfm_data(_long_track_scene(130)))


@pytest.mark.parametrize("model", ["Cal3Bundler", "Cal3_S2", "Cal3DS2", "Cal3Fisheye"])
def test_closed_form_jacobians_equal_autodiff(model):
    prob = ba.problem_from_sfm_data(to_port(ring_scene(model, seed=34, n_tracks=20)))
    J_c, J_p = ba._jacobians(prob, True)
    pose, cal = ba._cameras_at(prob, prob.meas_cam)
    X = prob.points[prob.meas_track]
    dc = prob.cal_params.shape[-1]

    def resid(x):
        c = cal.with_params(cal.to_params() + x[:, 6 : 6 + dc])
        return PinholeCamera(pose=pose.retract(x[:, :6]), cal=c).project(X + x[:, 6 + dc :])[0]

    J = jacobian_fwd(resid, X.new_zeros((X.shape[0], 9 + dc)))
    want = torch.cat([J[..., : 6 + dc], J[..., 6 + dc :]], -1)
    got = torch.cat([J_c, J_p], -1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * want.abs().max().item())


def test_stacked_jacobian_equals_per_column_jacobian():
    """numerics.jacobian_fwd_stacked (one jvp on the stacked batch, used for
    the pose priors' SE3 logs) equals jacobian_fwd (one jvp a column)."""
    from gtsfm_tpu_torch.utils.numerics import jacobian_fwd_stacked

    data = to_port(ring_scene(seed=35, n_tracks=4))
    prior = data.poses.map(lambda a: a.flip(0))

    def resid(x):
        return ba._abs_resid(x, data.poses, prior)

    x = torch.zeros(data.max_cameras, 6)
    torch.testing.assert_close(jacobian_fwd_stacked(resid, x), jacobian_fwd(resid, x), rtol=1e-6, atol=1e-6)
