"""Sim(3) similarity transforms + Umeyama / robust pose alignment.

Port of gtsfm_tpu/geometry/sim3.py.
"""

from __future__ import annotations

import dataclasses

import torch

from gtsfm_tpu_torch.geometry import so3
from gtsfm_tpu_torch.geometry.se3 import SE3
from gtsfm_tpu_torch.utils.numerics import TensorStruct, mm, svd


@dataclasses.dataclass(frozen=True)
class Sim3(TensorStruct):
    """p' = s * R @ p + t."""

    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor

    @classmethod
    def identity(cls, batch_shape: tuple = (), dtype=torch.float32, device=None) -> "Sim3":
        shape = tuple(batch_shape)
        return cls(
            R=torch.eye(3, dtype=dtype, device=device).expand(shape + (3, 3)).clone(),
            t=torch.zeros(shape + (3,), dtype=dtype, device=device),
            s=torch.ones(shape, dtype=dtype, device=device),
        )

    def transform(self, p: torch.Tensor) -> torch.Tensor:
        return self.s[..., None] * so3.rotate(self.R, p) + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(
            R=mm(self.R, other.R),
            t=self.s[..., None] * so3.rotate(self.R, other.t) + self.t,
            s=self.s * other.s,
        )

    def inverse(self) -> "Sim3":
        Rinv = self.R.transpose(-1, -2)
        sinv = 1.0 / self.s
        return Sim3(R=Rinv, t=-sinv[..., None] * so3.rotate(Rinv, self.t), s=sinv)

    def transform_pose(self, wTi: SE3) -> SE3:
        """aSb * bTi -> aTi: rotation R_sim @ R, center s R_sim c + t."""
        return SE3(R=mm(self.R, wTi.R), t=self.transform(wTi.t))


def align_points_umeyama(
    source: torch.Tensor,
    target: torch.Tensor,
    weights: torch.Tensor | None = None,
    estimate_scale: bool = True,
) -> Sim3:
    """Weighted Umeyama: the Sim3 minimizing ||target - T(source)||^2 over
    (..., N, 3) point sets with weights (..., N); leading dimensions batch
    independent fits (the merge scores its LMedS hypotheses as one batch)."""
    if weights is None:
        weights = torch.ones(source.shape[:-1], dtype=source.dtype, device=source.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    mu_s = torch.sum(source * w[..., None], dim=-2)
    mu_t = torch.sum(target * w[..., None], dim=-2)
    ds = source - mu_s[..., None, :]
    dt = target - mu_t[..., None, :]
    cov = mm((dt * w[..., None]).transpose(-1, -2), ds)
    U, D, Vt = svd(cov)
    det = torch.linalg.det(mm(U, Vt))
    S = torch.cat([torch.ones(det.shape + (2,), dtype=source.dtype, device=source.device), det[..., None]], dim=-1)
    R = mm(U * S[..., None, :], Vt)
    var_s = torch.sum(w * torch.sum(ds * ds, dim=-1), dim=-1)
    if estimate_scale:
        scale = torch.sum(D * S, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        scale = torch.ones(det.shape, dtype=source.dtype, device=source.device)
    t = mu_t - scale[..., None] * so3.rotate(R, mu_s)
    return Sim3(R=R, t=t, s=scale)


def align_poses_sim3(
    source: SE3, target: SE3, mask: torch.Tensor | None = None, estimate_scale: bool = True
) -> Sim3:
    """Umeyama on camera centers, rotation refined by the Karcher mean of
    the relative rotations."""
    if mask is None:
        mask = torch.ones(source.t.shape[0], dtype=torch.bool, device=source.t.device)
    w = mask.to(source.t.dtype)
    sim = align_points_umeyama(source.t, target.t, weights=w, estimate_scale=estimate_scale)
    rel = mm(target.R, source.R.transpose(-1, -2))
    R_refined = so3.karcher_mean(rel, mask=mask)
    wsum = torch.clamp(torch.sum(w), min=1e-12)
    mu_s = torch.sum(source.t * w[:, None], dim=0) / wsum
    mu_t = torch.sum(target.t * w[:, None], dim=0) / wsum
    return Sim3(R=R_refined, t=mu_t - sim.s * so3.rotate(R_refined, mu_s), s=sim.s)


def align_poses_sim3_robust(
    source: SE3,
    target: SE3,
    mask: torch.Tensor | None = None,
    iters: int = 5,
    sigma: float = 0.5,
) -> Sim3:
    """IRLS-robust Sim3 alignment on camera centers (Geman-McClure weights)."""
    if mask is None:
        mask = torch.ones(source.t.shape[0], dtype=torch.bool, device=source.t.device)
    base_w = mask.to(source.t.dtype)
    w = base_w
    for _ in range(iters):
        sim = align_points_umeyama(source.t, target.t, weights=w)
        resid = torch.linalg.vector_norm(target.t - sim.transform(source.t), dim=-1)
        med = _masked_median(resid, mask)
        scale = torch.clamp(sigma * torch.clamp(med, min=1e-6), min=1e-6)
        w = base_w * (scale**2) / (scale**2 + resid**2)
    sim = align_points_umeyama(source.t, target.t, weights=w)
    rel = mm(target.R, source.R.transpose(-1, -2))
    R_refined = so3.karcher_mean(rel, mask=mask)
    wsum = torch.clamp(torch.sum(w), min=1e-12)
    mu_s = torch.sum(source.t * w[:, None], dim=0) / wsum
    mu_t = torch.sum(target.t * w[:, None], dim=0) / wsum
    return Sim3(R=R_refined, t=mu_t - sim.s * so3.rotate(R_refined, mu_s), s=sim.s)


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median of x over mask along the last dimension (the
    reference's convention); leading dimensions batch."""
    order = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=-1).values
    k = torch.clamp(torch.sum(mask.to(torch.int64), dim=-1, keepdim=True), min=1)
    return torch.gather(order, -1, (k - 1) // 2).squeeze(-1)
