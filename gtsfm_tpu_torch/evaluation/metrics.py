"""Metrics containers and pose metrics.

Port of gtsfm_tpu/evaluation/metrics.py: ``Metric``, ``MetricsGroup``,
``pose_auc`` (host numpy, unchanged) and ``relative_pose_errors`` on port
tensors. The JSON summaries and export of the reference are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import SE3, so3
from gtsfm_tpu_torch.geometry.sim3 import align_poses_sim3_robust

POSE_AUC_THRESHOLDS_DEG = (1.0, 2.5, 5.0, 10.0, 20.0)


class Metric:
    """Scalar (``scalar``) or 1D-distribution (``dist``) metric."""

    def __init__(self, name: str, data):
        self.name = name
        arr = np.asarray(data, dtype=np.float64)
        if arr.ndim == 0:
            self.scalar = float(arr)
            self.dist = None
        else:
            self.scalar = None
            self.dist = arr


class MetricsGroup:
    def __init__(self, name: str, metrics: Optional[Sequence[Metric]] = None):
        self.name = name
        self.metrics = list(metrics or [])


def pose_auc(errors_deg: np.ndarray, thresholds_deg=POSE_AUC_THRESHOLDS_DEG) -> dict:
    """Area under the pose-error recall curve up to each threshold."""
    errs = np.sort(np.asarray(errors_deg, np.float64))
    errs = errs[np.isfinite(errs)]
    n = len(errs)
    if n == 0:
        return {f"pose_auc_@{t}_deg": 0.0 for t in thresholds_deg}
    recall = (np.arange(n) + 1) / n
    e = np.concatenate([[0.0], errs])
    r = np.concatenate([[0.0], recall])
    out = {}
    for t in thresholds_deg:
        last = np.searchsorted(e, t)
        rr = np.concatenate([r[:last], [r[min(last, len(r) - 1)]]])
        ee = np.concatenate([e[:last], [t]])
        out[f"pose_auc_@{t}_deg"] = float(np.trapezoid(rr, ee) / t)
    return out


def relative_pose_errors(wTi_est: SE3, wTi_gt: SE3, mask: np.ndarray) -> tuple:
    """Per-camera rotation error (deg) and center error after robust Sim3
    alignment of est onto GT. Returns (rot_err (N,), t_err (N,), Sim3)."""
    mask_t = torch.as_tensor(np.asarray(mask), device=wTi_est.t.device)
    sim = align_poses_sim3_robust(wTi_est, wTi_gt, mask=mask_t)
    aligned = sim.transform_pose(wTi_est)
    rot_err = so3.relative_angle_deg(aligned.R, wTi_gt.R).cpu().numpy()
    t_err = np.linalg.norm(aligned.t.cpu().numpy() - wTi_gt.t.cpu().numpy(), axis=-1)
    rot_err = np.where(mask, rot_err, np.inf)
    t_err = np.where(mask, t_err, np.inf)
    return rot_err, t_err, sim
