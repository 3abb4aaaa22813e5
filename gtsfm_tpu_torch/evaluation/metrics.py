"""Metrics containers and pose metrics.

Port of gtsfm_tpu/evaluation/metrics.py: ``Metric`` and ``MetricsGroup``
with their summaries and JSON round trip, ``pose_auc``,
``intrinsics_error_metrics`` and ``precision_recall_from_errors`` (host
numpy, unchanged), ``relative_pose_errors`` on port tensors, and the
relative pair errors of ``evaluation/compare.py``
(``relative_rotation_angular_errors``, ``translation_direction_errors_deg``,
host numpy).
"""

from __future__ import annotations

import json
import os
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

    def summary(self) -> dict:
        if self.dist is None:
            return {self.name: self.scalar}
        d = self.dist[np.isfinite(self.dist)]
        if d.size == 0:
            return {self.name: {"count": 0}}
        return {
            self.name: {
                "count": int(d.size),
                "min": float(d.min()),
                "max": float(d.max()),
                "mean": float(d.mean()),
                "median": float(np.median(d)),
                "stddev": float(d.std()),
                "quartiles": [float(q) for q in np.percentile(d, [0, 25, 50, 75, 100])],
            }
        }

    def to_dict(self) -> dict:
        if self.dist is None:
            return {self.name: self.scalar}
        return {self.name: {"summary": self.summary()[self.name], "full_data": self.dist.tolist()}}


class MetricsGroup:
    def __init__(self, name: str, metrics: Optional[Sequence[Metric]] = None):
        self.name = name
        self.metrics = list(metrics or [])

    def add(self, metric: Metric):
        self.metrics.append(metric)

    def to_dict(self) -> dict:
        out = {}
        for m in self.metrics:
            out.update(m.to_dict())
        return {self.name: out}

    def save_json(self, dirpath: str):
        os.makedirs(dirpath, exist_ok=True)
        with open(os.path.join(dirpath, f"{self.name}.json"), "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "MetricsGroup":
        with open(path) as f:
            d = json.load(f)
        name = list(d.keys())[0]
        g = cls(name)
        for k, v in d[name].items():
            g.add(Metric(k, v["full_data"] if isinstance(v, dict) and "full_data" in v else v))
        return g


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


def intrinsics_error_metrics(est_cal, gt_cal, valid_mask=None) -> MetricsGroup:
    """Per-camera intrinsics errors against GT: the focal length's absolute
    and percentage error, and the radial k1 / k2 absolute errors where the
    model has them."""
    fx_est = np.atleast_1d(est_cal.fx.cpu().numpy().astype(np.float64))
    fx_gt = np.atleast_1d(gt_cal.fx.cpu().numpy().astype(np.float64))
    m = np.ones(fx_est.shape[0], bool) if valid_mask is None else np.asarray(valid_mask)
    abs_err = np.abs(fx_est - fx_gt)[m]
    with np.errstate(divide="ignore", invalid="ignore"):
        pct = np.where(fx_gt > 0, np.abs(fx_est - fx_gt) / np.maximum(fx_gt, 1e-12) * 100.0, np.nan)[m]
    g = MetricsGroup("intrinsics_metrics", [Metric("focal_length_error_px", abs_err),
                                            Metric("focal_length_error_pct", pct[np.isfinite(pct)])])
    for k in ("k1", "k2"):
        if hasattr(est_cal, k) and hasattr(gt_cal, k):
            e = np.abs(np.atleast_1d(getattr(est_cal, k).cpu().numpy().astype(np.float64))
                       - np.atleast_1d(getattr(gt_cal, k).cpu().numpy().astype(np.float64)))[m]
            g.add(Metric(f"{k}_error", e))
    return g


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
