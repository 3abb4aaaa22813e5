"""Plain numerical helpers of the reference: frozen copies of the plain
PyTorch code that the two-view verifier needs (TF32 control, NaN-safe
decompositions, forward-mode Jacobians, the pinned nullvector, the
counter-based draws, SO(3)), and the precisions the control drops to.

Imports nothing of the program: a change to the program cannot change
what the reference computes.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """TF32 off (the configurations' float32) or on (the control's step
    below float32) for matmuls and convolutions; bf16 products summed in
    float32. Restores the flags on exit."""
    mat = torch.backends.cuda.matmul
    prev = (mat.allow_tf32, torch.backends.cudnn.allow_tf32, mat.allow_bf16_reduced_precision_reduction)
    mat.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    mat.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mat.allow_tf32, torch.backends.cudnn.allow_tf32, mat.allow_bf16_reduced_precision_reduction = prev


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale per tensor (its
    largest magnitude onto e4m3's 448), back in x's dtype: the control's
    step below bfloat16."""
    scale = torch.clamp(x.detach().abs().amax().float(), min=1e-12) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _nan_where_nonfinite(M: torch.Tensor):
    bad = ~torch.isfinite(M).flatten(-2).all(-1)
    return torch.where(bad[..., None, None], 0.0, M), torch.where(bad, torch.nan, 0.0).to(M.dtype)


def svd(M: torch.Tensor):
    """Reduced SVD with NaN factors for a matrix holding a non-finite value."""
    M, nan = _nan_where_nonfinite(M)
    U, S, Vh = torch.linalg.svd(M)
    return U + nan[..., None, None], S + nan[..., None], Vh + nan[..., None, None]


def eigh(M: torch.Tensor):
    """eigh with NaN eigenpairs for a matrix holding a non-finite value."""
    M, nan = _nan_where_nonfinite(M)
    w, V = torch.linalg.eigh(M)
    return w + nan[..., None], V + nan[..., None, None]


def jacobian_fwd(fn, x: torch.Tensor) -> torch.Tensor:
    """Per-row forward-mode Jacobian (B, ..., n) of fn: (B, n) -> (B, ...)."""
    cols = []
    for i in range(x.shape[-1]):
        tangent = torch.zeros_like(x)
        tangent[..., i] = 1.0
        cols.append(torch.func.jvp(fn, (x,), (tangent,))[1])
    return torch.stack(cols, dim=-1)


def nullvec_pinned_scalarized(AtA: torch.Tensor) -> torch.Tensor:
    """Nullvector of (..., n, n) normal matrices: the last coordinate
    pinned to 1, the leading system eliminated unpivoted entry by entry."""
    n = AtA.shape[-1]
    m = n - 1
    M = [[AtA[..., i, j] for j in range(m)] + [-AtA[..., i, m]] for i in range(m)]
    for k in range(m):
        piv = M[k][k]
        inv = torch.where(piv.abs() > 1e-30, 1.0 / torch.where(piv == 0, torch.ones_like(piv), piv),
                          torch.full_like(piv, 1e30))
        row_k = [M[k][j] * inv for j in range(m + 1)]
        for i in range(m):
            if i == k:
                M[i] = row_k
            else:
                f = M[i][k]
                M[i] = [M[i][j] - f * row_k[j] for j in range(m + 1)]
    y = torch.stack([M[i][m] for i in range(m)], dim=-1)
    e = torch.cat([y, torch.ones_like(y[..., :1])], dim=-1)
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-20)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def counter_uniform(seed: int, tag: int, stream: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
                    maxval: float = 1.0) -> torch.Tensor:
    """Uniform float32 draws (stream.shape + shape): element c of stream s
    is murmur3's finalizer of (seed, tag, s, c)."""
    dev = stream.device
    s = stream.to(torch.int64) & _M32
    base = _mix32(s ^ _mix32(torch.tensor((seed * 0x9E3779B1 + tag) & _M32, device=dev)))
    n = 1
    for d in shape:
        n *= int(d)
    ctr = torch.arange(n, dtype=torch.int64, device=dev)
    h = _mix32((base[..., None] + _mul32(ctr + 1, 0x9E3779B9)) & _M32)
    h = _mix32(h ^ base[..., None])
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    u = minval + (maxval - minval) * u
    return u.reshape(tuple(stream.shape) + tuple(shape))


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> skew-symmetric (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def expmap(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with Taylor terms near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    W = hat(w)
    eye = torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * torch.matmul(W, W)
