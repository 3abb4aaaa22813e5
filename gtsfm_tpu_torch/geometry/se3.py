"""SE(3) rigid transforms as a dataclass of tensors.

Port of gtsfm_tpu/geometry/se3.py. A camera pose ``wTi`` maps camera-frame
points to world: ``p_w = wTi * p_i``; ``i2Ti1`` maps frame i1 into i2. All
operations broadcast over leading batch dimensions.
"""

from __future__ import annotations

import dataclasses

import torch

from gtsfm_tpu_torch.geometry import so3
from gtsfm_tpu_torch.utils.numerics import TensorStruct, mm


@dataclasses.dataclass(frozen=True)
class SE3(TensorStruct):
    """Rigid transform: rotation R (..., 3, 3) and translation t (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @classmethod
    def identity(cls, batch_shape: tuple = (), dtype=torch.float32, device=None) -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(tuple(batch_shape) + (3, 3)).clone()
        t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        return cls(R=R, t=t)

    def compose(self, other: "SE3") -> "SE3":
        """self * other (apply other first)."""
        return SE3(R=mm(self.R, other.R), t=so3.rotate(self.R, other.t) + self.t)

    def inverse(self) -> "SE3":
        Rinv = self.R.transpose(-1, -2)
        return SE3(R=Rinv, t=-so3.rotate(Rinv, self.t))

    def transform(self, p: torch.Tensor) -> torch.Tensor:
        return so3.rotate(self.R, p) + self.t

    def transform_to(self, p: torch.Tensor) -> torch.Tensor:
        """World -> local frame."""
        return so3.rotate(self.R.transpose(-1, -2), p - self.t)

    @classmethod
    def exp(cls, xi: torch.Tensor) -> "SE3":
        """Exponential map of the twist xi = (omega, v), (..., 6), rotation
        first (gtsam.Pose3.Expmap ordering)."""
        w = xi[..., :3]
        v = xi[..., 3:]
        R = so3.expmap(w)
        theta2 = torch.sum(w * w, dim=-1)
        small = theta2 < 1e-8
        theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
        theta = torch.sqrt(theta2_safe)
        W = so3.hat(w)
        b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
        c = torch.where(
            small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2_safe * theta)
        )
        eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
        V = eye + b[..., None, None] * W + c[..., None, None] * mm(W, W)
        return cls(R=R, t=torch.einsum("...ij,...j->...i", V, v))

    def log(self) -> torch.Tensor:
        """Log map to the twist (omega, v), (..., 6)."""
        w = so3.logmap(self.R)
        theta2 = torch.sum(w * w, dim=-1)
        small = theta2 < 1e-8
        theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
        theta = torch.sqrt(theta2_safe)
        W = so3.hat(w)
        half = 0.5 * theta
        cot_term = half * torch.cos(half) / torch.where(small, torch.ones_like(theta), torch.sin(half))
        coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - cot_term) / theta2_safe)
        eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
        Vinv = eye - 0.5 * W + coef[..., None, None] * mm(W, W)
        v = torch.einsum("...ij,...j->...i", Vinv, self.t)
        return torch.cat([w, v], dim=-1)

    def retract(self, xi: torch.Tensor) -> "SE3":
        """Right retraction: self * Exp(xi)."""
        return self.compose(SE3.exp(xi))

    def __getitem__(self, idx) -> "SE3":
        return SE3(R=self.R[idx], t=self.t[idx])
