"""View-frustum overlap of two cameras.

Port of gtsfm_tpu/utils/overlap_frustums.py: sample one camera's frustum
on a grid of pixels and depths, and count the share of the samples inside
a second camera's frustum. ``points_in_view`` is the batched in-view mask
of already projected points (the synthetic correspondence generator's).
Host numpy around the port's camera models.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import SE3


def sample_frustum_points(wTc: SE3, cal, width: int, height: int, z_min: float, z_max: float,
                          samples_per_axis: int = 6) -> np.ndarray:
    """World-space grid samples inside one camera's frustum,
    (samples_per_axis^3, 3): pixels strictly inside the image (so a
    camera's overlap with itself is 1.0) at geometric depths in (z_min,
    z_max)."""
    us = np.linspace(0.5, width - 1.5, samples_per_axis)
    vs = np.linspace(0.5, height - 1.5, samples_per_axis)
    zs = np.geomspace(max(z_min, 1e-3) * 1.02, z_max * 0.98, samples_per_axis)
    uv = torch.as_tensor(np.array(list(itertools.product(us, vs)), np.float32), device=wTc.R.device)
    return np.concatenate([_backproject(wTc, cal, uv, float(z)).cpu().numpy() for z in zs])


def _backproject(wTc: SE3, cal, uv: torch.Tensor, z: float) -> torch.Tensor:
    """Pixels (N, 2) at depth z -> world points (N, 3)."""
    p = cal.calibrate(uv)
    ray = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1) * z
    return wTc.transform(ray)


def points_in_view(uv: np.ndarray, z: np.ndarray, wh: np.ndarray, z_min: float = 1e-6) -> np.ndarray:
    """Batched in-view mask from already-projected points.

    uv: (..., K, 2) pixel coords; z: (..., K) depths; wh: (..., 2) per-view
    (width, height). The projection itself is the caller's (batched, on the
    device)."""
    uv = np.asarray(uv)
    z = np.asarray(z)
    wh = np.asarray(wh, np.float32)
    return (
        (z > z_min)
        & (uv[..., 0] >= 0) & (uv[..., 0] < wh[..., None, 0])
        & (uv[..., 1] >= 0) & (uv[..., 1] < wh[..., None, 1])
    )


def in_frustum(points: np.ndarray, wTc: SE3, cal, width: int, height: int, z_min: float,
               z_max: float) -> np.ndarray:
    """Containment of world points (N, 3) in a camera's frustum, (N,) bool."""
    dev = wTc.R.device
    p_cam = wTc.transform_to(torch.as_tensor(np.asarray(points, np.float32), device=dev)).cpu().numpy()
    z = p_cam[:, 2]
    uv = cal.uncalibrate(torch.as_tensor(p_cam[:, :2] / np.maximum(z[:, None], 1e-9), device=dev)).cpu().numpy()
    return (
        (z > z_min) & (z < z_max)
        & (uv[:, 0] >= 0) & (uv[:, 0] < width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    )


def frustum_overlap_fraction(wTc_a: SE3, cal_a, wTc_b: SE3, cal_b, width: int, height: int, z_min: float = 0.5,
                             z_max: float = 20.0, samples_per_axis: int = 6) -> float:
    """Share of camera a's frustum samples inside camera b's frustum."""
    pts = sample_frustum_points(wTc_a, cal_a, width, height, z_min, z_max, samples_per_axis)
    return float(in_frustum(pts, wTc_b, cal_b, width, height, z_min, z_max).mean())
