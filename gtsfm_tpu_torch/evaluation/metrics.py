"""Metrics containers and pose metrics.

Port of gtsfm_tpu/evaluation/metrics.py: ``Metric``, ``MetricsGroup``,
``pose_auc`` and ``precision_recall_from_errors`` (host numpy, unchanged),
``relative_pose_errors`` on port tensors, and the relative pair errors of
``evaluation/compare.py`` (``relative_rotation_angular_errors``,
``translation_direction_errors_deg``, host numpy). The JSON summaries and export of the reference are not ported.
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


def relative_rotation_angular_errors(wRi_est: np.ndarray, wRi_gt: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """Angular error of relative rotations over the given pairs (deg)."""
    i1, i2 = pairs[:, 0], pairs[:, 1]
    wRi_est, wRi_gt = np.asarray(wRi_est), np.asarray(wRi_gt)
    rel_est = np.einsum("eji,ejk->eik", wRi_est[i2], wRi_est[i1])
    rel_gt = np.einsum("eji,ejk->eik", wRi_gt[i2], wRi_gt[i1])
    return so3.relative_angle_deg(torch.as_tensor(rel_est), torch.as_tensor(rel_gt)).numpy()


def translation_direction_errors_deg(wti_est: np.ndarray, wti_gt: np.ndarray, wRi_gt: np.ndarray,
                                     pairs: np.ndarray) -> np.ndarray:
    """Angle between the estimated and GT relative translation directions
    per pair (deg), sign-free."""
    i1, i2 = pairs[:, 0], pairs[:, 1]
    d_est = np.asarray(wti_est)[i1] - np.asarray(wti_est)[i2]
    d_gt = np.asarray(wti_gt)[i1] - np.asarray(wti_gt)[i2]
    num = np.abs(np.sum(d_est * d_gt, axis=-1))
    den = np.linalg.norm(d_est, axis=-1) * np.linalg.norm(d_gt, axis=-1)
    return np.degrees(np.arccos(np.clip(num / np.maximum(den, 1e-12), -1.0, 1.0)))


def precision_recall_from_errors(positive_errors, negative_errors, max_positive_error: float) -> tuple:
    """Precision and recall when predictions are split into accepted
    (positive) and rejected (negative) sets and a prediction is correct when
    its error is <= the threshold."""
    pos = np.asarray(list(positive_errors), np.float64)
    neg = np.asarray(list(negative_errors), np.float64)
    tp = float(np.sum(pos <= max_positive_error))
    fp = float(np.sum(pos > max_positive_error))
    fn = float(np.sum(neg <= max_positive_error))
    eps = 1e-12
    return tp / (tp + fp + eps), tp / (tp + fn + eps)
