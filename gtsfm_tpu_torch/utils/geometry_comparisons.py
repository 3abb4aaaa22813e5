"""Rotation, translation and pose-set comparison.

Port of gtsfm_tpu/utils/geometry_comparisons.py. ``compare_global_poses``
is the integration-test criterion reported in the ``ba_pose_metrics``
group. Inputs are tensors or numpy arrays; a numpy array becomes a tensor
of its own dtype on the CPU, a tensor stays on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import SE3, so3
from gtsfm_tpu_torch.geometry.sim3 import align_poses_sim3


def compute_relative_rotation_angle(R1, R2) -> float:
    """Geodesic angle between two rotations in degrees."""
    R1 = torch.as_tensor(R1)
    return float(so3.relative_angle_deg(R1, torch.as_tensor(R2, device=R1.device)))


def compute_relative_unit_translation_angle(u1, u2) -> float:
    """Angle between two translation directions (sign-invariant), degrees."""
    u1, u2 = (np.asarray(torch.as_tensor(u).cpu(), np.float64) for u in (u1, u2))
    c = abs(np.dot(u1, u2)) / max(np.linalg.norm(u1) * np.linalg.norm(u2), 1e-12)
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def pose_distance(aTb: SE3, aTc: SE3) -> tuple:
    """(rotation deg, translation L2) between two poses in the same frame."""
    rot = float(so3.relative_angle_deg(aTb.R, aTc.R))
    trans = float(torch.linalg.vector_norm(aTb.t - aTc.t))
    return rot, trans


def compare_rotations(wRi_a, wRi_b, angular_error_threshold_deg: float = 5.0) -> bool:
    """True when the two global-rotation sets (N, 3, 3) agree up to one
    global rotation (the Karcher mean of Rb Ra^T) within the threshold."""
    Ra = torch.as_tensor(wRi_a)
    Rb = torch.as_tensor(wRi_b, device=Ra.device)
    G = so3.karcher_mean(torch.einsum("nij,nkj->nik", Rb, Ra))
    aligned = torch.einsum("ij,njk->nik", G, Ra)
    errs = so3.relative_angle_deg(aligned, Rb).cpu().numpy()
    return bool(np.all(errs < angular_error_threshold_deg))


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
