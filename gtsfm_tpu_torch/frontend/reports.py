"""Two-view estimation reports and the front end's metrics against GT.

Port of gtsfm_tpu/frontend/reports.py: per-pair rotation and direction
errors against GT, pose error = max(R error, U error), success counts at a
threshold, inlier statistics and the accept decision's precision and
recall: the ``verifier_summary`` group. Host numpy on the two-view result's
host copies; the angles run through the port's SO(3) helpers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gtsfm_tpu_torch.evaluation.metrics import Metric, MetricsGroup, precision_recall_from_errors
from gtsfm_tpu_torch.geometry import SE3, so3


@dataclasses.dataclass
class TwoViewEstimationReport:
    """Per-pair report record (host-side)."""

    i1: int
    i2: int
    num_matches: int
    num_inliers: int
    inlier_ratio: float
    valid: bool
    R_error_deg: Optional[float] = None
    U_error_deg: Optional[float] = None

    @property
    def pose_error_deg(self) -> Optional[float]:
        if self.R_error_deg is None or self.U_error_deg is None:
            return None
        return max(self.R_error_deg, self.U_error_deg)


def make_reports(pairs: np.ndarray, tvr: dict, gt_poses: Optional[SE3]) -> list:
    """Per-pair reports from a two-view result (mapping of numpy arrays);
    with GT poses, with the R and U angular errors."""
    pairs = np.asarray(pairs)
    R_err = U_err = None
    if gt_poses is not None:
        R = gt_poses.R.detach().cpu().numpy()
        t = gt_poses.t.detach().cpu().numpy()
        i1, i2 = pairs[:, 0], pairs[:, 1]
        gt_rel = np.einsum("eji,ejk->eik", R[i2], R[i1])
        R_err = so3.relative_angle_deg(torch.as_tensor(gt_rel),
                                       torch.as_tensor(np.asarray(tvr["i2Ri1"]))).numpy()
        d_gt = np.einsum("eji,ej->ei", R[i2], t[i1] - t[i2])
        nrm = np.linalg.norm(d_gt, axis=-1)
        d_gt = d_gt / np.maximum(nrm[:, None], 1e-12)
        dot = np.abs(np.sum(d_gt * np.asarray(tvr["i2Ui1"]), axis=-1))
        U_err = np.degrees(np.arccos(np.clip(dot, -1, 1)))
        # pairs with ~zero GT baseline have an undefined direction
        U_err = np.where(nrm < 1e-6, 0.0, U_err)
    return [
        TwoViewEstimationReport(
            i1=int(a), i2=int(b),
            num_matches=int(tvr["num_matches"][e]),
            num_inliers=int(tvr["num_inliers"][e]),
            inlier_ratio=float(tvr["inlier_ratio"][e]),
            valid=bool(tvr["valid"][e]),
            R_error_deg=float(R_err[e]) if R_err is not None else None,
            U_error_deg=float(U_err[e]) if U_err is not None else None,
        )
        for e, (a, b) in enumerate(pairs)
    ]


def aggregate_frontend_metrics(reports: list, angular_err_threshold_deg: float = 5.0) -> MetricsGroup:
    """The ``verifier_summary`` group of a list of reports."""
    valid = [r for r in reports if r.valid]
    with_gt = bool(valid) and valid[0].R_error_deg is not None
    g = MetricsGroup("verifier_summary")
    g.metrics.append(Metric("num_total_image_pairs", len(reports)))
    g.metrics.append(Metric("num_valid_image_pairs", len(valid)))
    th = angular_err_threshold_deg
    if with_gt:
        R_errs = np.array([r.R_error_deg for r in valid])
        U_errs = np.array([r.U_error_deg for r in valid])
        pose_errs = np.maximum(R_errs, U_errs)
        g.metrics += [
            Metric("rotation_success_count", int((R_errs < th).sum())),
            Metric("translation_success_count", int((U_errs < th).sum())),
            Metric("pose_success_count", int((pose_errs < th).sum())),
            Metric("rotation_angular_errors_deg", R_errs),
            Metric("translation_angular_errors_deg", U_errs),
            Metric("pose_errors_deg", pose_errs),
        ]
    if valid:
        g.metrics += [
            Metric("inlier_ratio_per_pair", np.array([r.inlier_ratio for r in valid])),
            Metric("num_inliers_per_pair", np.array([r.num_inliers for r in valid])),
        ]
    if with_gt:
        # a pair the verifier accepted is correct when its GT pose error is
        # within the threshold
        neg = [r.pose_error_deg for r in reports if not r.valid and r.R_error_deg is not None]
        precision, recall = precision_recall_from_errors([r.pose_error_deg for r in valid], neg, th)
        g.metrics += [Metric("pose_precision", precision), Metric("pose_recall", recall)]
    return g
