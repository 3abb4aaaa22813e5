"""Synthetic correspondence generation from ground truth.

Port of gtsfm_tpu/frontend/synthetic.py: sample a GT surface in front of
the cameras (or take an explicit point set), project it into every camera
and emit the correspondences of each pair with the GT relative poses, in
the batched pair currency (padded keypoints per image, per-pair index
arrays) that the two-view batch and the back end consume.

The projection is one batched ``PinholeCamera.project`` over all cameras
on the device of the GT poses. The numpy ``default_rng(seed)`` stream is
consumed in the reference's order (surface points, pixel noise, outlier
flips), so every index array equals the reference's and ``kp_xy`` differs
only by the projection's float32 round-off.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import SE3, PinholeCamera
from gtsfm_tpu_torch.utils.numerics import precise
from gtsfm_tpu_torch.utils.overlap_frustums import points_in_view


class SyntheticOptions(NamedTuple):
    num_points: int = 500
    noise_px: float = 0.0
    outlier_fraction: float = 0.0
    seed: int = 0


class SyntheticCorrespondenceGenerator:
    # SceneOptimizer routes generators with this marker through the GT-driven
    # synthetic branch instead of the image-matcher path
    requires_gt = True

    def __init__(self, options: SyntheticOptions = SyntheticOptions()):
        self.options = options

    def generate(
        self,
        gt_poses: SE3,  # [N]
        cal,  # batched calibration [N]
        pairs: np.ndarray,  # (E, 2)
        image_sizes,  # list of (w, h)
        surface_points: Optional[np.ndarray] = None,
    ) -> dict:
        """-> dict of numpy arrays: keypoints_xy (N, K, 2), kp_mask (N, K),
        per-pair corr_i1 / corr_i2 / corr_mask (E, K), i2Ri1 / i2Ui1 / valid /
        num_inliers from GT, and the surface points (K, 3)."""
        opts = self.options
        rng = np.random.default_rng(opts.seed)
        R = gt_poses.R.detach().cpu().numpy()
        t = gt_poses.t.detach().cpu().numpy()
        K = opts.num_points

        if surface_points is None:
            # points in front of the camera ring: around the centroid of
            # the look-at targets
            fwd = R[:, :, 2]
            target = (t + fwd * np.linalg.norm(np.ptp(t, 0)) * 0.8).mean(0)
            spread = max(np.ptp(t, axis=0).max() * 0.4, 1.0)
            surface_points = target + rng.uniform(-spread, spread, (K, 3))
        pts = np.asarray(surface_points[:K], np.float32)
        K = len(pts)

        with precise():
            cams = PinholeCamera(pose=gt_poses.map(lambda a: a[:, None]), cal=cal.map(lambda a: a[:, None]))
            uv_t, z_t = cams.project(torch.as_tensor(pts, device=gt_poses.t.device))
        uv = uv_t.cpu().numpy()
        kp_mask = points_in_view(uv, z_t.cpu().numpy(), np.asarray(image_sizes, np.float32))
        if opts.noise_px > 0:
            uv = uv + rng.normal(0, opts.noise_px, uv.shape).astype(np.float32)
        kp_xy = uv.astype(np.float32)

        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        E = len(pairs)
        i1, i2 = pairs[:, 0], pairs[:, 1]
        corr_i1 = np.tile(np.arange(K, dtype=np.int32), (E, 1))
        corr_i2 = corr_i1.copy()
        if opts.outlier_fraction > 0:
            # one draw per pair, in pair order, as the reference's loop
            for e in range(E):
                flip = rng.uniform(size=K) < opts.outlier_fraction
                corr_i2[e, flip] = rng.integers(0, K, flip.sum())
        corr_mask = kp_mask[i1] & kp_mask[i2]
        i2Ri1 = np.einsum("eji,ejk->eik", R[i2], R[i1]).astype(np.float32)
        d = np.einsum("eji,ej->ei", R[i2], t[i1] - t[i2])
        i2Ui1 = (d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)).astype(np.float32)
        num_inliers = corr_mask.sum(axis=1)
        return {
            "keypoints_xy": kp_xy,
            "kp_mask": kp_mask,
            "corr_i1": corr_i1,
            "corr_i2": corr_i2,
            "corr_mask": corr_mask,
            "i2Ri1": i2Ri1,
            "i2Ui1": i2Ui1,
            "valid": num_inliers >= 8,
            "num_inliers": num_inliers.astype(np.int32),
            "points": pts,
        }
