"""Camera calibration models.

Port of gtsfm_tpu/geometry/calibration.py: ``Cal3Bundler``, ``Cal3_S2``,
``Cal3DS2`` and ``Cal3Fisheye`` (gtsam's models). ``uncalibrate`` maps
intrinsic (normalized image-plane) coordinates to pixels, ``calibrate``
inverts it (fixed-point or Newton steps for the distortion models, a fixed
count of them). All ops broadcast over leading batch dimensions.

For bundle adjustment every model has ``dof`` (its optimizable parameter
count), ``to_params() -> (..., dof)`` and ``with_params(params)``, so the
solver dispatches on the type alone.
"""

from __future__ import annotations

import dataclasses

import torch

from gtsfm_tpu_torch.utils.numerics import TensorStruct

_NEWTON_ITERS = 10
_R2_SMALL = 1e-18  # the fisheye's r < 1e-9, squared


@dataclasses.dataclass(frozen=True)
class Cal3Bundler(TensorStruct):
    """Single focal length + two radial coefficients; fixed principal point."""

    f: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor

    dof = 3  # f, k1, k2 (u0, v0 fixed, as in gtsam.Cal3Bundler)

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
        return _K(self.f, self.f, torch.zeros_like(self.f), self.u0, self.v0)

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


def _K(fx, fy, s, u0, v0) -> torch.Tensor:
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([fx, s, u0], -1),
            torch.stack([z, fy, v0], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )


class _SkewModel(TensorStruct):
    """What the models with (fx, fy, s, u0, v0) share: K, the map between
    (distorted) intrinsic coords and pixels, and the parameter vector, every
    field in declaration order."""

    @classmethod
    def _create(cls, values, device):
        args = [torch.as_tensor(a, dtype=torch.float32, device=device) for a in values]
        return cls(*torch.broadcast_tensors(*args))

    def _names(self) -> list:
        return [f.name for f in dataclasses.fields(self)]

    def _pixels(self, d: torch.Tensor) -> torch.Tensor:
        """Distorted intrinsic coords (..., 2) -> pixels."""
        u = self.fx * d[..., 0] + self.s * d[..., 1] + self.u0
        v = self.fy * d[..., 1] + self.v0
        return torch.stack([u, v], dim=-1)

    def _unpixels(self, uv: torch.Tensor) -> tuple:
        """Pixels (..., 2) -> distorted intrinsic coords (x, y)."""
        y = (uv[..., 1] - self.v0) / self.fy
        x = (uv[..., 0] - self.u0 - self.s * y) / self.fx
        return x, y

    def K(self) -> torch.Tensor:
        return _K(self.fx, self.fy, self.s, self.u0, self.v0)

    def to_params(self) -> torch.Tensor:
        return torch.stack([getattr(self, n) for n in self._names()], dim=-1)

    def with_params(self, params: torch.Tensor):
        return self.replace(**{n: params[..., i] for i, n in enumerate(self._names())})


@dataclasses.dataclass(frozen=True)
class Cal3_S2(_SkewModel):
    """Pinhole with skew, no distortion."""

    fx: torch.Tensor
    fy: torch.Tensor
    s: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor

    dof = 5

    @classmethod
    def create(cls, fx, fy=None, s=0.0, u0=0.0, v0=0.0, device=None) -> "Cal3_S2":
        fy = fx if fy is None else fy
        return cls._create((fx, fy, s, u0, v0), device)

    def uncalibrate(self, p: torch.Tensor) -> torch.Tensor:
        return self._pixels(p)

    def calibrate(self, uv: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._unpixels(uv), dim=-1)



@dataclasses.dataclass(frozen=True)
class Cal3DS2(_SkewModel):
    """Pinhole with skew + radial (k1, k2) and tangential (p1, p2)
    distortion (OpenCV's model)."""

    fx: torch.Tensor
    fy: torch.Tensor
    s: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    dof = 9

    @classmethod
    def create(cls, fx, fy=None, s=0.0, u0=0.0, v0=0.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
               device=None) -> "Cal3DS2":
        fy = fx if fy is None else fy
        return cls._create((fx, fy, s, u0, v0, k1, k2, p1, p2), device)

    def _distort(self, p: torch.Tensor) -> torch.Tensor:
        x, y = p[..., 0], p[..., 1]
        r2 = x * x + y * y
        g = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return torch.stack([g * x + dx, g * y + dy], dim=-1)

    def uncalibrate(self, p: torch.Tensor) -> torch.Tensor:
        return self._pixels(self._distort(p))

    def calibrate(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels -> intrinsic coords: the fixed point p = pd - (distort(p)
        - p), _NEWTON_ITERS steps from the distorted coords."""
        pd = torch.stack(self._unpixels(uv), dim=-1)
        p = pd
        for _ in range(_NEWTON_ITERS):
            p = p + (pd - self._distort(p))
        return p



@dataclasses.dataclass(frozen=True)
class Cal3Fisheye(_SkewModel):
    """Equidistant fisheye with k1..k4 (gtsam's Cal3Fisheye, OpenCV's
    fisheye model)."""

    fx: torch.Tensor
    fy: torch.Tensor
    s: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor

    dof = 9

    @classmethod
    def create(cls, fx, fy=None, s=0.0, u0=0.0, v0=0.0, k1=0.0, k2=0.0, k3=0.0, k4=0.0,
               device=None) -> "Cal3Fisheye":
        fy = fx if fy is None else fy
        return cls._create((fx, fy, s, u0, v0, k1, k2, k3, k4), device)

    def _theta_d(self, theta: torch.Tensor) -> torch.Tensor:
        t2 = theta * theta
        return theta * (1.0 + self.k1 * t2 + self.k2 * t2**2 + self.k3 * t2**3 + self.k4 * t2**4)

    def _dtheta_d(self, theta: torch.Tensor) -> torch.Tensor:
        t2 = theta * theta
        return 1.0 + 3.0 * self.k1 * t2 + 5.0 * self.k2 * t2**2 + 7.0 * self.k3 * t2**3 + 9.0 * self.k4 * t2**4

    def uncalibrate(self, p: torch.Tensor) -> torch.Tensor:
        # the radius comes from a guarded square: at p = 0 both the value
        # and its forward-mode tangent stay finite (a norm's tangent there
        # is 0/0)
        r2 = torch.sum(p * p, dim=-1)
        small = r2 < _R2_SMALL
        r_safe = torch.sqrt(torch.where(small, torch.ones_like(r2), r2))
        scale = torch.where(small, torch.ones_like(r2), self._theta_d(torch.atan(r_safe)) / r_safe)
        return self._pixels(scale[..., None] * p)

    def calibrate(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels -> intrinsic coords: _NEWTON_ITERS Newton steps on
        theta_d(theta) = r_d, then r = tan(theta)."""
        xd, yd = self._unpixels(uv)
        rd2 = xd * xd + yd * yd
        small = rd2 < _R2_SMALL
        rd_safe = torch.sqrt(torch.where(small, torch.ones_like(rd2), rd2))
        rd = torch.where(small, torch.zeros_like(rd2), rd_safe)
        theta = rd
        for _ in range(_NEWTON_ITERS):
            theta = theta - (self._theta_d(theta) - rd) / torch.clamp(self._dtheta_d(theta), min=1e-9)
        scale = torch.where(small, torch.ones_like(rd2), torch.tan(theta) / rd_safe)
        return scale[..., None] * torch.stack([xd, yd], dim=-1)



CALIBRATION_TYPES = (Cal3Bundler, Cal3_S2, Cal3DS2, Cal3Fisheye)
