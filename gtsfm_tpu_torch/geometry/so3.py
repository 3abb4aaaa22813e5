"""SO(3) operations on batched rotation matrices.

Port of gtsfm_tpu/geometry/so3.py. Rotations are (..., 3, 3) float32
tensors; every function broadcasts over leading batch dimensions and keeps
the reference's safe-where guards, so forward-mode Jacobians
(``numerics.jacobian_fwd``) stay finite at theta = 0 and theta = pi.
"""

from __future__ import annotations

import torch

from gtsfm_tpu_torch.utils.numerics import mm

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix from axis vector. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def expmap(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis-angle (..., 3) -> rotation (..., 3, 3), with
    Taylor series near theta = 0 (double-where guarded)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * mm(W, W)


def logmap(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3) through the quaternion
    (stable at every angle, including theta = pi)."""
    q = to_quat(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    vn2 = torch.sum(qv * qv, dim=-1)
    small = vn2 < 1e-14
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    theta = 2.0 * torch.atan2(torch.where(small, torch.zeros_like(vn), vn), qw)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=0.5), theta / vn)
    return scale[..., None] * qv


def project(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation (Frobenius) of (..., 3, 3) via SVD with the
    determinant fix R = U diag(1, 1, det(U V^T)) V^T."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(mm(U, Vt))
    D = torch.ones(M.shape[:-2] + (3,), dtype=M.dtype, device=M.device)
    D = torch.cat([D[..., :2], det[..., None]], dim=-1)
    return mm(U * D[..., None, :], Vt)


def to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> quaternion (w, x, y, z) with w >= 0, by the
    branch-free Shepperd method (all four candidates, best-conditioned
    one selected)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = torch.clamp(1.0 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    def safe_div(a, b):
        return a / torch.where(b < 1e-12, torch.ones_like(b), b)

    sw = torch.sqrt(torch.clamp(qw2, min=1e-9))
    cand_w = torch.stack([0.5 * sw, safe_div(m21 - m12, 2 * sw), safe_div(m02 - m20, 2 * sw), safe_div(m10 - m01, 2 * sw)], -1)
    sx = torch.sqrt(torch.clamp(qx2, min=1e-9))
    cand_x = torch.stack([safe_div(m21 - m12, 2 * sx), 0.5 * sx, safe_div(m01 + m10, 2 * sx), safe_div(m02 + m20, 2 * sx)], -1)
    sy = torch.sqrt(torch.clamp(qy2, min=1e-9))
    cand_y = torch.stack([safe_div(m02 - m20, 2 * sy), safe_div(m01 + m10, 2 * sy), 0.5 * sy, safe_div(m12 + m21, 2 * sy)], -1)
    sz = torch.sqrt(torch.clamp(qz2, min=1e-9))
    cand_z = torch.stack([safe_div(m10 - m01, 2 * sz), safe_div(m02 + m20, 2 * sz), safe_div(m12 + m21, 2 * sz), 0.5 * sz], -1)

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(mags, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # (..., 4, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def angle_rad(R: torch.Tensor) -> torch.Tensor:
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def relative_angle_rad(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    return angle_rad(mm(R1.transpose(-1, -2), R2))


def relative_angle_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    return torch.rad2deg(relative_angle_rad(R1, R2))


def rotate(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", R, p)


def karcher_mean(Rs: torch.Tensor, mask: torch.Tensor | None = None, iters: int = 10) -> torch.Tensor:
    """Karcher (geodesic L2) mean of rotations (N, 3, 3) -> (3, 3), fixed
    iterations of tangent-space Gauss-Newton; masked entries ignored."""
    if mask is None:
        mask = torch.ones(Rs.shape[0], dtype=torch.bool, device=Rs.device)
    w = mask.to(Rs.dtype)
    denom = torch.clamp(torch.sum(w), min=1.0)
    mean = project(torch.sum(Rs * w[:, None, None], dim=0) / denom)
    for _ in range(iters):
        tangents = logmap(mm(mean.transpose(-1, -2)[None], Rs))
        delta = torch.sum(tangents * w[:, None], dim=0) / denom
        mean = mm(mean, expmap(delta))
    return mean
