"""Pinhole camera = SE3 pose (wTc) + calibration.

Port of gtsfm_tpu/geometry/cameras.py.
"""

from __future__ import annotations

import dataclasses

import torch

from gtsfm_tpu_torch.geometry.se3 import SE3
from gtsfm_tpu_torch.utils.numerics import TensorStruct


@dataclasses.dataclass(frozen=True)
class PinholeCamera(TensorStruct):
    pose: SE3  # wTc
    cal: object  # a calibration model

    def project(self, p_world: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """World points (..., 3) -> (pixels (..., 2), depth (...)). Points
        behind the camera keep their negative depth; callers mask them."""
        p_cam = self.pose.transform_to(p_world)
        z = p_cam[..., 2]
        z_safe = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        return self.cal.uncalibrate(p_cam[..., :2] / z_safe[..., None]), z

    def backproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) at depths (...) -> world points (..., 3)."""
        p = self.cal.calibrate(uv)
        ray = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1) * depth[..., None]
        return self.pose.transform(ray)

    def center(self) -> torch.Tensor:
        return self.pose.t

    def reprojection_error(self, p_world: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
        proj, _ = self.project(p_world)
        return torch.linalg.vector_norm(proj - uv, dim=-1)
