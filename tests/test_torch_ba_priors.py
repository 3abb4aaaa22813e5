"""The port's bundle adjustment priors and gauges against the JAX
reference, on the Cal3Bundler ring of tests/torch_ba_scenes.py (the
scenarios of tests/bundle/test_ba.py): rig between factors with absolute
pose priors, the Karcher gauge with the first-point prior, and
``run_compact`` remapping rig edges and pose priors onto the live cameras
(the calibration prior is in test_torch_ba.py). Each runs in one layout against the
same layout of the reference; final cost, poses and points agree to 1e-4
relative + 1e-4 absolute (points 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np

from tests.torch_ba_scenes import assert_same_solve, close, gt_poses, ring_scene, solve_both
from tests.torch_threads import cap_threads

cap_threads()


def _rel(poses, edges):
    pa = jax.tree.map(lambda x: x[jnp.asarray(edges[:, 0])], poses)
    pb = jax.tree.map(lambda x: x[jnp.asarray(edges[:, 1])], poses)
    return pb.inverse().compose(pa)  # bTa


def test_rig_between_factors_and_absolute_priors_match_reference():
    data = ring_scene(seed=7, pose_sigma=0.03)
    edges = np.array([[0, 1], [2, 3], [4, 5]], np.int64)
    fixed = np.zeros(8, bool)
    fixed[0] = True
    prior_w = np.zeros(8, np.float32)
    prior_w[5:] = 10.0  # soft absolute priors on the last three cameras
    ref, port = solve_both(data, fixed, max_iterations=30, layout="scatter", rel_edges=edges,
                           rel_meas=_rel(gt_poses(), edges), rel_weight=np.full(3, 1e5, np.float32),
                           prior_pose=gt_poses(), prior_weight=prior_w)
    assert_same_solve(ref, port)


def test_karcher_gauge_and_first_point_prior_match_reference():
    data = ring_scene(seed=3, pose_sigma=0.02, point_sigma=0.05, n_anchors=0)
    fixed = np.zeros(8, bool)
    fixed[0] = True  # with the first point anchored, this fixes the scale too: a determined gauge
    ref, port = solve_both(data, fixed, max_iterations=25, cg_iterations=40, gauge="karcher",
                           first_point_prior_weight=10.0, layout="entry")
    assert_same_solve(ref, port)


def test_run_compact_remaps_rig_edges_and_pose_priors_like_reference():
    """Cameras 6-7 dead (unposed, unmeasured): the rig edge (5, 6) must get
    weight 0 and the pose priors follow their cameras into the compacted
    problem, as in the reference."""
    data = ring_scene(n_cams=10, seed=5, pose_sigma=0.02)
    pm = np.ones(10, bool)
    pm[[6, 7]] = False
    mm = np.asarray(data.meas_mask) & pm[np.asarray(data.meas_cam)]
    data = data.replace(pose_mask=jnp.asarray(pm), meas_mask=jnp.asarray(mm))
    edges = np.array([[0, 1], [5, 6], [8, 9]], np.int64)
    prior_w = np.where(pm, 5.0, 0.0).astype(np.float32)
    fixed = np.zeros(10, bool)
    fixed[0] = True
    ref, port = solve_both(data, fixed, method="run_compact", max_iterations=15, cg_iterations=30, layout="dense",
                           rel_edges=edges, rel_meas=_rel(gt_poses(10), edges), rel_weight=np.full(3, 1e3, np.float32),
                           prior_pose=gt_poses(10), prior_weight=prior_w)
    assert_same_solve(ref, port)
    (out_j, _), (out_t, _) = ref, port
    close(out_t.poses.t.numpy()[~pm], np.asarray(data.poses.t)[~pm], 0.0, "dead cameras")
