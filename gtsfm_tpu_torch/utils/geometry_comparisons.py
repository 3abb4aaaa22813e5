"""Pose-set comparison.

Port of ``compare_global_poses`` from gtsfm_tpu/utils/geometry_comparisons.py
(the integration-test criterion reported in the ``ba_pose_metrics`` group).
"""

from __future__ import annotations

import numpy as np

from gtsfm_tpu_torch.geometry import SE3, so3
from gtsfm_tpu_torch.geometry.sim3 import align_poses_sim3


def compare_global_poses(
    wTi_a: SE3,
    wTi_b: SE3,
    rot_threshold_deg: float = 5.0,
    trans_err_atol: float = 1.0,
    trans_err_rtol: float = 0.1,
) -> bool:
    """Sim3-align a to b and check every pose within the tolerances."""
    sim = align_poses_sim3(wTi_a, wTi_b)
    aligned = sim.transform_pose(wTi_a)
    rot_err = so3.relative_angle_deg(aligned.R, wTi_b.R).cpu().numpy()
    if np.any(rot_err > rot_threshold_deg):
        return False
    return bool(np.allclose(aligned.t.cpu().numpy(), wTi_b.t.cpu().numpy(),
                            atol=trans_err_atol, rtol=trans_err_rtol))
