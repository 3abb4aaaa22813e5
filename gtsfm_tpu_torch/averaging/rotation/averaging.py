"""Global rotation averaging: chordal initialization, the SO(p) staircase
with its optimality certificate, then robust tangent-space Gauss-Newton.

Port of gtsfm_tpu/averaging/rotation/averaging.py (default options:
staircase_p_max=6, 30 robust GN iterations, re-refine after dropping edges
whose residual exceeds 10 degrees). Dense linear algebra runs on the device
of ``i2Ri1``; the certificate's eigendecomposition and the staircase's
bookkeeping stay on the host in float64, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import so3
from gtsfm_tpu_torch.utils.numerics import SegmentSum, jacobian_fwd, mm, precise


class RotationAveragingOptions(NamedTuple):
    max_iterations: int = 30
    robust_huber_rad: float = 0.1
    init_lambda: float = 1e-6
    rerefine_reject_deg: float = 10.0
    staircase_p_max: int = 6


def _spd_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cholesky solve with no host sync; a non-PD H yields NaN (the
    callers' accept tests then reject the step), as the reference's
    ``solve(assume_a="pos")`` does."""
    L, _ = torch.linalg.cholesky_ex(H)
    return torch.cholesky_solve(b, L)


def _edge_assembly(n: int, i1: torch.Tensor, i2: torch.Tensor) -> SegmentSum:
    """The block positions (i1, i1), (i2, i2), (i1, i2), (i2, i1) of every
    edge in an (n, n) block matrix, for ``_edge_blocks``."""
    return SegmentSum((n, n), torch.cat([i1, i2, i1, i2]), torch.cat([i1, i2, i2, i1]))


def _edge_blocks(asm: SegmentSum, b11, b22, b12, b21) -> torch.Tensor:
    """Dense (3n, 3n) matrix from per-edge 3x3 blocks at the positions of
    ``asm`` (``_edge_assembly``)."""
    n = asm.shape[0]
    H = asm(torch.cat([b11, b22, b12, b21]))
    return H.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)


def chordal_init(
    num_images: int,
    edges: torch.Tensor,  # i64 (E, 2) (i1, i2)
    i2Ri1: torch.Tensor,  # (E, 3, 3)
    edge_weight: torch.Tensor,  # (E,) (0 = masked out)
    anchor: int = 0,
) -> torch.Tensor:
    """Chordal relaxation: min sum_e w_e ||Y_i1 - i2Ri1^T Y_i2||_F^2 with
    Y_i = wRi^T and Y_anchor = I, one (3N-3) SPD solve; projected to SO(3)."""
    n = num_images
    dev, dt = i2Ri1.device, i2Ri1.dtype
    i1, i2 = edges[:, 0], edges[:, 1]
    w = edge_weight
    A = i2Ri1.transpose(-1, -2)
    eyeE = torch.eye(3, dtype=dt, device=dev) * w[:, None, None]
    Hd = _edge_blocks(_edge_assembly(n, i1, i2), eyeE, eyeE,
                      -w[:, None, None] * A, -w[:, None, None] * A.transpose(-1, -2))
    idx = torch.tensor([i for i in range(n) if i != anchor], dtype=torch.int64, device=dev)
    rows = (idx[:, None] * 3 + torch.arange(3, device=dev)[None, :]).reshape(-1)
    anchor_cols = anchor * 3 + torch.arange(3, device=dev)
    H_red = Hd[rows][:, rows] + 1e-6 * torch.eye(rows.shape[0], dtype=dt, device=dev)
    B = -Hd[rows][:, anchor_cols]
    Y = _spd_solve(H_red, B)
    Yt = torch.zeros((n, 3, 3), dtype=dt, device=dev)
    Yt[anchor] = torch.eye(3, dtype=dt, device=dev)
    Yt[idx] = Y.reshape(n - 1, 3, 3)
    return so3.project(Yt.transpose(-1, -2))


def _build_cost_matrix(num_images, edges, i2Ri1, edge_weight) -> np.ndarray:
    """Dense (3N, 3N) float64 block cost matrix Q of the chordal objective."""
    n = num_images
    i1 = np.asarray(edges[:, 0], int)
    i2 = np.asarray(edges[:, 1], int)
    w = np.asarray(edge_weight, np.float64)
    A = np.transpose(np.asarray(i2Ri1, np.float64), (0, 2, 1))
    Q = np.zeros((n, n, 3, 3))
    eye = np.eye(3)
    np.add.at(Q, (i1, i1), w[:, None, None] * eye)
    np.add.at(Q, (i2, i2), w[:, None, None] * eye)
    np.add.at(Q, (i1, i2), -w[:, None, None] * A)
    np.add.at(Q, (i2, i1), -w[:, None, None] * np.transpose(A, (0, 2, 1)))
    return Q.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)


def _qf_retract(G: torch.Tensor) -> torch.Tensor:
    """Block-wise Q factor (positive-diagonal R) onto St(3, p): G (p, 3n).
    Gram-Schmidt on the three columns of each (p, 3) block gives the
    unique positive-diagonal QR, the sign-fixed Householder Q of the
    reference, without a batched LAPACK call."""
    p = G.shape[0]
    n = G.shape[1] // 3
    B = G.reshape(p, n, 3).permute(1, 0, 2)  # (n, p, 3)

    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)

    b1, b2, b3 = B[..., 0], B[..., 1], B[..., 2]
    q1 = unit(b1)
    q2 = unit(b2 - torch.sum(q1 * b2, -1, keepdim=True) * q1)
    v3 = b3 - torch.sum(q1 * b3, -1, keepdim=True) * q1
    q3 = unit(v3 - torch.sum(q2 * v3, -1, keepdim=True) * q2)
    q = torch.stack([q1, q2, q3], dim=-1)  # (n, p, 3)
    return q.permute(1, 0, 2).reshape(p, 3 * n)


def _stiefel_descend(Q: torch.Tensor, G0: torch.Tensor, iters: int = 150):
    """Riemannian gradient descent of tr(G Q G^T) over St(3, p)^n with an
    adaptive accept/reject step (no host sync). Returns (G, cost)."""
    p = G0.shape[0]
    n = G0.shape[1] // 3

    def cost(G):
        return torch.sum(mm(G, Q) * G)

    def rgrad(G):
        E = 2.0 * mm(G, Q)
        Gb = G.reshape(p, n, 3)
        Eb = E.reshape(p, n, 3)
        M = torch.einsum("pni,pnj->nij", Gb, Eb)
        M = 0.5 * (M + M.transpose(-1, -2))
        return (Eb - torch.einsum("pni,nij->pnj", Gb, M)).reshape(p, 3 * n)

    gnorm = torch.linalg.vector_norm(rgrad(G0)) + 1e-12
    step = 0.1 / gnorm * float(np.sqrt(3.0 * n))
    G, f = G0, cost(G0)
    for _ in range(iters):
        cand = _qf_retract(G - step * rgrad(G))
        f_cand = cost(cand)
        accept = f_cand < f
        G = torch.where(accept, cand, G)
        step = torch.clamp(torch.where(accept, step * 1.4, step * 0.4), 1e-14, 1e6)
        f = torch.where(accept, f_cand, f)
    return G, f


def _certificate_from_G(Q64: np.ndarray, G: np.ndarray, tol: float):
    """(certified, min_eig, eigvec) of S = Q - blockdiag(Lambda) at G."""
    n = Q64.shape[0] // 3
    G = np.asarray(G, np.float64)
    M = Q64 @ (G.T @ G)
    S = Q64.copy()
    for i in range(n):
        blk = M[3 * i : 3 * i + 3, 3 * i : 3 * i + 3]
        S[3 * i : 3 * i + 3, 3 * i : 3 * i + 3] -= 0.5 * (blk + blk.T)
    vals, vecs = np.linalg.eigh(S)
    scale = max(1.0, abs(vals[-1]))
    return vals[0] >= -tol * scale, float(vals[0]), vecs[:, 0]


def _round_to_so3(G: np.ndarray, device) -> np.ndarray:
    """Round a rank-p staircase solution to SO(3)^n: top-3 SVD, majority
    determinant reflection fix, per-block projection."""
    n = G.shape[1] // 3
    _, s, Vt = np.linalg.svd(np.asarray(G, np.float64), full_matrices=False)
    Gh = (s[:3, None] * Vt[:3]).reshape(3, n, 3).transpose(1, 0, 2)
    if np.median(np.linalg.det(Gh)) < 0:
        Gh = Gh * np.array([1.0, 1.0, -1.0])[None, :, None]
    return so3.project(torch.as_tensor(Gh, dtype=torch.float32, device=device)).cpu().numpy()


def shonan_staircase(
    num_images: int,
    edges: np.ndarray,
    i2Ri1: np.ndarray,
    edge_weight: np.ndarray,
    wRi_init: np.ndarray,
    p_max: int = 6,
    descent_iters: int = 150,
    tol: float = 1e-6,
    device=None,
) -> tuple:
    """SO(p) Riemannian staircase: descend at rank p, certify, lift along
    the certificate's negative eigenvector if uncertified, round back to
    SO(3). Returns (wRi float32 numpy (N, 3, 3), certified, min_eig)."""
    Q64 = _build_cost_matrix(num_images, edges, i2Ri1, edge_weight)
    Q32 = torch.as_tensor(Q64, dtype=torch.float32, device=device)
    G = np.asarray(wRi_init, np.float64).transpose(1, 0, 2).reshape(3, 3 * num_images)

    def descend(G_np):
        G_t, _ = _stiefel_descend(Q32, torch.as_tensor(G_np, dtype=torch.float32, device=device),
                                  iters=descent_iters)
        return G_t.cpu().numpy().astype(np.float64)

    certified, min_eig = False, -np.inf
    for p in range(3, p_max + 1):
        G = descend(G)
        certified, min_eig, v = _certificate_from_G(Q64, G, tol)
        if certified or p == p_max:
            break
        G_lift = np.vstack([G, np.zeros(3 * num_images)])
        D = np.zeros_like(G_lift)
        D[-1] = v
        best, best_f = G_lift, float(np.sum((G_lift @ Q64) * G_lift))
        for t in np.geomspace(1e-3, 10.0, 12):
            for sgn in (1.0, -1.0):
                cand = _qf_retract(
                    torch.as_tensor(G_lift + sgn * t * D, dtype=torch.float32, device=device)
                ).cpu().numpy().astype(np.float64)
                f = float(np.sum((cand @ Q64) * cand))
                if f < best_f:
                    best, best_f = cand, f
        G = best

    wRi = _round_to_so3(G, device)
    if G.shape[0] > 3:
        G3 = descend(wRi.astype(np.float64).transpose(1, 0, 2).reshape(3, 3 * num_images))
        certified, min_eig, _ = _certificate_from_G(Q64, G3, tol)
        wRi = _round_to_so3(G3, device)
    wRi = np.einsum("ij,njk->nik", wRi[0].T.copy(), wRi).astype(np.float32)
    return so3.project(torch.as_tensor(wRi, device=device)).cpu().numpy(), certified, min_eig


def _edge_residual(wRi1, wRi2, R_e):
    """Log((wRi2 i2Ri1)^T wRi1): zero when consistent."""
    return so3.logmap(mm(mm(wRi2, R_e).transpose(-1, -2), wRi1))


def _local_residual(xi, R1, R2, Re):
    """Edge residual at R1 exp(xi[:3]), R2 exp(xi[3:]); xi (E, 6)."""
    return _edge_residual(mm(R1, so3.expmap(xi[..., :3])), mm(R2, so3.expmap(xi[..., 3:])), Re)


def _refine(
    num_images: int,
    wRi0: torch.Tensor,
    edges: torch.Tensor,
    i2Ri1: torch.Tensor,
    edge_weight: torch.Tensor,
    opts: RotationAveragingOptions,
) -> torch.Tensor:
    """Robust (Huber-IRLS) Levenberg-Marquardt on the tangent space; node 0
    is the gauge anchor. Returns refined wRi (N, 3, 3)."""
    n = num_images
    dev, dt = wRi0.device, wRi0.dtype
    i1, i2 = edges[:, 0], edges[:, 1]
    k = opts.robust_huber_rad
    z6 = torch.zeros((edges.shape[0], 6), dtype=dt, device=dev)
    eye = torch.eye(3 * n, dtype=dt, device=dev)
    asm = _edge_assembly(n, i1, i2)
    grad_sum = SegmentSum((n,), torch.cat([i1, i2]))

    def cost_of(wRi):
        nrm = torch.linalg.vector_norm(_edge_residual(wRi[i1], wRi[i2], i2Ri1), dim=-1)
        rho = torch.where(nrm <= k, 0.5 * nrm**2, k * (nrm - 0.5 * k)) if k > 0 else 0.5 * nrm**2
        return torch.sum(edge_weight * rho)

    def system(wRi):
        R1, R2 = wRi[i1], wRi[i2]
        r = _edge_residual(R1, R2, i2Ri1)
        J = jacobian_fwd(lambda xi: _local_residual(xi, R1, R2, i2Ri1), z6)  # (E, 3, 6)
        J1, J2 = J[..., :3], J[..., 3:]
        nrm = torch.linalg.vector_norm(r, dim=-1)
        w_rob = torch.clamp(k / torch.clamp(nrm, min=1e-12), max=1.0) if k > 0 else torch.ones_like(nrm)
        w = edge_weight * w_rob
        wJ1 = J1 * w[:, None, None]
        wJ2 = J2 * w[:, None, None]
        Hd = _edge_blocks(
            asm,
            torch.einsum("eri,erj->eij", wJ1, J1), torch.einsum("eri,erj->eij", wJ2, J2),
            torch.einsum("eri,erj->eij", wJ1, J2), torch.einsum("eri,erj->eij", wJ2, J1),
        )
        g = grad_sum(torch.cat([
            torch.einsum("eri,er->ei", wJ1, r), torch.einsum("eri,er->ei", wJ2, r)]))
        return Hd, g

    wRi = wRi0
    lam = torch.tensor(opts.init_lambda, dtype=dt, device=dev)
    cost = cost_of(wRi)
    keep = torch.ones((n, 1), dtype=dt, device=dev)
    keep[0] = 0.0  # gauge: node 0 stays put
    for _ in range(opts.max_iterations):
        Hd, g = system(wRi)
        Hd = Hd + lam * torch.diag(torch.diagonal(Hd)) + (lam + 1e-8) * eye
        delta = _spd_solve(Hd, -g.reshape(-1, 1)).reshape(n, 3) * keep
        cand = mm(wRi, so3.expmap(delta))
        new_cost = cost_of(cand)
        accept = new_cost < cost
        wRi = torch.where(accept, cand, wRi)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-10, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return wRi


class RotationAveraging:
    """run(num_images, edges, i2Ri1, num_inliers, edge_mask) ->
    (wRi (N, 3, 3) tensor on i2Ri1's device, valid bool numpy (N,))."""

    def __init__(self, options: RotationAveragingOptions = RotationAveragingOptions()):
        self.options = options

    def run(
        self,
        num_images: int,
        edges: np.ndarray,
        i2Ri1: torch.Tensor,
        num_inliers: np.ndarray | None = None,
        edge_mask: np.ndarray | None = None,
    ):
        dev = i2Ri1.device
        edges = np.asarray(edges, np.int64)
        E = len(edges)
        eye_n = torch.eye(3, device=dev).expand(num_images, 3, 3).clone()
        if E == 0:
            return eye_n, np.zeros(num_images, bool)
        if edge_mask is None:
            edge_mask = np.ones(E, bool)
        if num_inliers is None:
            w = edge_mask.astype(np.float32)
        else:
            w = edge_mask * np.asarray(num_inliers, np.float32)
            w = (w / max(w.max(), 1e-9)).astype(np.float32)

        valid = np.zeros(num_images, bool)
        np.logical_or.at(valid, edges[edge_mask][:, 0], True)
        np.logical_or.at(valid, edges[edge_mask][:, 1], True)
        anchor = int(np.argmax(valid))

        with precise():
            R_e = i2Ri1.to(torch.float32)
            edges_t = torch.as_tensor(edges, device=dev)
            w_t = torch.as_tensor(w, device=dev)
            wRi0 = chordal_init(num_images, edges_t, R_e, w_t, anchor=anchor)
            self.last_certified = None
            if self.options.staircase_p_max > 3:
                wRi_st, certified, min_eig = shonan_staircase(
                    num_images, edges, R_e.cpu().numpy(), w, wRi0.cpu().numpy(),
                    p_max=self.options.staircase_p_max, device=dev,
                )
                wRi0 = torch.as_tensor(wRi_st, device=dev)
                self.last_certified = (certified, min_eig)
            wRi = _refine(num_images, wRi0, edges_t, R_e, w_t, self.options)
            if self.options.rerefine_reject_deg > 0:
                res = _edge_residual(wRi[edges_t[:, 0]], wRi[edges_t[:, 1]], R_e)
                ang = np.degrees(np.linalg.norm(res.cpu().numpy(), axis=-1))
                w2 = w * (ang <= self.options.rerefine_reject_deg)
                if w2.sum() >= num_images - 1 and (w2 > 0).sum() < (w > 0).sum():
                    wRi = _refine(num_images, wRi, edges_t, R_e,
                                  torch.as_tensor(w2, dtype=torch.float32, device=dev), self.options)
        wRi = torch.where(torch.as_tensor(valid, device=dev)[:, None, None], wRi, eye_n)
        return wRi, valid
