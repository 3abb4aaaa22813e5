"""Camera calibration models.

Port of gtsfm_tpu/geometry/calibration.py, ``Cal3Bundler`` only (the model
the reconstruction path and its synthetic loader use; Cal3_S2, Cal3DS2 and
Cal3Fisheye are still to be ported). ``uncalibrate`` maps intrinsic
(normalized image-plane) coordinates to pixels, ``calibrate`` inverts it by
fixed-point iteration. All ops broadcast over leading batch dimensions.
"""

from __future__ import annotations

import dataclasses

import torch

from gtsfm_tpu_torch.utils.numerics import TensorStruct

_NEWTON_ITERS = 10


@dataclasses.dataclass(frozen=True)
class Cal3Bundler(TensorStruct):
    """Single focal length + two radial coefficients; fixed principal point."""

    f: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor

    @classmethod
    def create(cls, f, k1=0.0, k2=0.0, u0=0.0, v0=0.0, device=None) -> "Cal3Bundler":
        args = [torch.as_tensor(a, dtype=torch.float32, device=device) for a in (f, k1, k2, u0, v0)]
        return cls(*torch.broadcast_tensors(*args))

    def uncalibrate(self, p: torch.Tensor) -> torch.Tensor:
        """Intrinsic coords (..., 2) -> pixels (..., 2)."""
        r2 = torch.sum(p * p, dim=-1)
        g = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        return (self.f * g)[..., None] * p + torch.stack([self.u0, self.v0], dim=-1)

    def calibrate(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels -> intrinsic coords."""
        pi = (uv - torch.stack([self.u0, self.v0], dim=-1)) / self.f[..., None]
        p = pi
        for _ in range(_NEWTON_ITERS):
            r2 = torch.sum(p * p, dim=-1)
            g = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
            p = pi / g[..., None]
        return p

    def K(self) -> torch.Tensor:
        """Intrinsic matrices (..., 3, 3)."""
        z = torch.zeros_like(self.f)
        o = torch.ones_like(self.f)
        return torch.stack(
            [
                torch.stack([self.f, z, self.u0], -1),
                torch.stack([z, self.f, self.v0], -1),
                torch.stack([z, z, o], -1),
            ],
            dim=-2,
        )

    @property
    def fx(self) -> torch.Tensor:
        return self.f

    @property
    def fy(self) -> torch.Tensor:
        return self.f

    def to_params(self) -> torch.Tensor:
        return torch.stack([self.f, self.k1, self.k2], dim=-1)

    def with_params(self, params: torch.Tensor) -> "Cal3Bundler":
        return self.replace(f=params[..., 0], k1=params[..., 1], k2=params[..., 2])
