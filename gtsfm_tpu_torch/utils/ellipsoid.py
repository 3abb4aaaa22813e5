"""Ellipsoid (PCA) axis alignment of a reconstruction.

Port of gtsfm_tpu/utils/ellipsoid.py: rotate the scene so that the
principal axes of its point cloud lie along the world axes, with the
centroid at the origin. The scene optimizer applies it when there is no
GT frame to align to. The eigen-decomposition is host numpy in float64,
as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.geometry.sim3 import Sim3


def get_alignment_transform(points: np.ndarray, device=None) -> Sim3:
    """The Sim3 (unit scale) that centers the cloud and turns its axes of
    decreasing variance into x, y, z (right-handed)."""
    pts = np.asarray(points, np.float64)
    center = pts.mean(axis=0)
    d = pts - center
    cov = d.T @ d / max(len(pts) - 1, 1)
    vals, vecs = np.linalg.eigh(cov)
    R = vecs[:, np.argsort(-vals)].T
    if np.linalg.det(R) < 0:
        R[2] *= -1
    return Sim3(R=torch.as_tensor(R, dtype=torch.float32, device=device),
                t=torch.as_tensor(-R @ center, dtype=torch.float32, device=device),
                s=torch.ones((), dtype=torch.float32, device=device))


def align_scene_to_axes(data: SfmData) -> SfmData:
    pts = data.points[data.track_mask].cpu().numpy()
    if len(pts) < 3:
        return data
    return data.transform(get_alignment_transform(pts, device=data.points.device))
