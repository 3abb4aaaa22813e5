"""Fundamental-matrix RANSAC with Degensac's plane-and-parallax recovery,
homography RANSAC and the H-vs-F degeneracy rule, batched over pairs.

Port of gtsfm_tpu/frontend/verifiers/fundamental.py. Every function takes
a leading pair axis: uv1, uv2 (P, K, 2) pixels, mask (P, K). Hypotheses
are solved from the gathered rows of each minimal set (8 correspondences
for F, 4 for H) instead of the reference's full-K weighted sum with four
or eight non-zero weights: the same normal matrix up to summation order.

Random draws come from counter streams keyed by ``stream_ids`` (the
pairs' global ids), one tag per stage, or are passed in: ``sample_idx``
replays the minimal sets, ``degensac_uniforms`` the uniforms of the
Degensac stage (its draws depend on the F inliers, so the tests replay
the uniforms rather than the indices).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gtsfm_tpu_torch.frontend.verifiers.essential import _homog, _normal_matrix
from gtsfm_tpu_torch.geometry import so3
from gtsfm_tpu_torch.utils.numerics import counter_uniform, mm, nullvec_pinned, precise

# stage tags of the counter-based random streams (essential.py uses 1-2,
# triangulation.py 3)
TAG_F_SAMPLE = 4
TAG_H_SAMPLE = 5
TAG_DEGENSAC_H = 6
TAG_DEGENSAC_PP = 7


class FundamentalOptions(NamedTuple):
    num_hypotheses: int = 512
    lo_rounds: int = 3
    min_inliers: int = 8
    # Degensac: when a homography explains >= degensac_h_ratio of the F
    # inliers, re-estimate F = [e']_x H with the epipole voted by the
    # off-plane points and keep it if it scores better
    degensac: bool = False
    degensac_h_ratio: float = 0.7
    degensac_h_hypotheses: int = 128


def _hartley_normalize(x: torch.Tensor, w: torch.Tensor):
    """Similarity making the weighted points (..., K, 2) zero-mean with
    sqrt(2) rms distance: (normalized points, T (..., 3, 3))."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    mu = torch.sum(x * w[..., None], dim=-2) / wsum[..., None]
    d = torch.sqrt(torch.sum(torch.sum((x - mu[..., None, :]) ** 2, -1) * w, -1) / wsum)
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-9)
    z, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, z, -s * mu[..., 0]], -1),
        torch.stack([z, s, -s * mu[..., 1]], -1),
        torch.stack([z, z, one], -1),
    ], -2)
    return (x - mu[..., None, :]) * s[..., None, None], T


def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return mm(U * S[..., None, :], Vt)


def _sampson_f(F, x1, x2) -> torch.Tensor:
    """Sampson error (..., K) of F (..., 3, 3) on x (..., K, 2)."""
    p1, p2 = _homog(x1), _homog(x2)
    Fx1 = torch.einsum("...ij,...kj->...ki", F, p1)
    Ftx2 = torch.einsum("...ji,...kj->...ki", F, p2)
    num = torch.sum(p2 * Fx1, -1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _f_rows(x1, x2) -> torch.Tensor:
    """Row-normalized 8-point rows (..., K, 9)."""
    p1, p2 = _homog(x1), _homog(x2)
    A = (p2[..., :, :, None] * p1[..., :, None, :]).flatten(-2)
    return A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)


def _h_rows(x1, x2) -> torch.Tensor:
    """Row-normalized homography DLT rows (..., K, 2, 9) for x2 ~ H x1."""
    p1 = _homog(x1)
    zeros = torch.zeros_like(p1)
    r1 = torch.cat([p1, zeros, -x2[..., 0:1] * p1], -1)
    r2 = torch.cat([zeros, p1, -x2[..., 1:2] * p1], -1)
    A = torch.stack([r1, r2], -2)
    return A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)


def _h_normal_matrix(x1, x2, w) -> torch.Tensor:
    """Weighted homography DLT normal matrix (..., 9, 9)."""
    A = _h_rows(x1, x2)
    return torch.einsum("...kri,...krj->...ij", A * w[..., None, None], A)


def _h_transfer_err(H, x1, x2) -> torch.Tensor:
    """Squared transfer error (..., K) of x1 through H (..., 3, 3)."""
    q = torch.einsum("...ij,...kj->...ki", H, _homog(x1))
    z = q[..., 2:]
    q = q[..., :2] / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return torch.sum((q - x2) ** 2, -1)


def _gather_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows (P, K, ...) at idx (P, H, m) -> (P, H, m, ...)."""
    P, H, m = idx.shape
    width = math.prod(rows.shape[2:])
    flat = torch.gather(rows.reshape(P, -1, width), 1, idx.reshape(P, H * m, 1).expand(P, H * m, width))
    return flat.reshape((P, H, m) + rows.shape[2:])


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (P, H, ...) at idx (P,) -> (P, ...)."""
    return torch.gather(x, 1, idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand((-1, 1) + x.shape[2:]))[:, 0]


def _sample_sets(weight, num_sets: int, size: int, seed: int, tag: int, stream_ids) -> torch.Tensor:
    """The reference's minimal sets (P, num_sets, size): the top ``size``
    of uniform draws times ``weight`` (P, K)."""
    u = counter_uniform(seed, tag, stream_ids, (num_sets, weight.shape[-1]))
    return torch.topk(u * weight[:, None, :], size, dim=-1).indices


def sample_fundamental_sets(mask, num_hypotheses: int, seed: int = 0, stream_ids=None) -> torch.Tensor:
    """8-point sets (P, H, 8) drawn uniformly from each pair's valid
    correspondences."""
    if stream_ids is None:
        stream_ids = torch.arange(mask.shape[0], device=mask.device)
    return _sample_sets(mask.to(torch.float32), num_hypotheses, 8, seed, TAG_F_SAMPLE, stream_ids)


def sample_homography_sets(mask, num_hypotheses: int, seed: int = 0, stream_ids=None) -> torch.Tensor:
    """4-point sets (P, H, 4) drawn uniformly from each pair's valid
    correspondences, a stream of their own."""
    if stream_ids is None:
        stream_ids = torch.arange(mask.shape[0], device=mask.device)
    return _sample_sets(mask.to(torch.float32), num_hypotheses, 4, seed, TAG_H_SAMPLE, stream_ids)


@precise()
def ransac_fundamental(
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    mask: torch.Tensor,
    threshold_px: float = 3.0,
    opts: FundamentalOptions = FundamentalOptions(),
    sample_idx: torch.Tensor | None = None,
    degensac_uniforms: tuple | None = None,
    seed: int = 0,
    stream_ids: torch.Tensor | None = None,
):
    """Pixel-space fundamental RANSAC with Hartley normalization and LO
    refits (and Degensac with ``opts.degensac``). ``sample_idx``
    (P, H, 8) and ``degensac_uniforms`` ((P, Hh, K), (P, 4 Hh, 2, K))
    replace the random draws. Returns a dict of batched F (pixels, unit
    norm), inliers, num_inliers, success."""
    P, K = mask.shape
    dev = uv1.device
    if stream_ids is None:
        stream_ids = torch.arange(P, device=dev)
    maskf = mask.to(uv1.dtype)
    x1n, T1 = _hartley_normalize(uv1, maskf)
    x2n, T2 = _hartley_normalize(uv2, maskf)
    thresh2 = (threshold_px * (0.5 * (T1[:, 0, 0] + T2[:, 0, 0]))) ** 2  # (P,)
    if sample_idx is None:
        sample_idx = sample_fundamental_sets(mask, opts.num_hypotheses, seed, stream_ids)
    A8 = _gather_rows(_f_rows(x1n, x2n) * maskf[..., None], sample_idx)  # (P, H, 8, 9)
    Fs = nullvec_pinned(torch.einsum("phkr,phks->phrs", A8, A8)).unflatten(-1, (3, 3))
    err_h = _sampson_f(Fs, x1n[:, None], x2n[:, None])
    votes = (mask[:, None] & (err_h < thresh2[:, None, None])).sum(-1)
    F_best = _pick(Fs, torch.argmax(votes, -1))

    def count(F):
        return (mask & (_sampson_f(F, x1n, x2n) < thresh2[:, None])).sum(-1)

    def lo_round(F, mult):
        err = _sampson_f(F, x1n, x2n)
        inl = mask & (err < thresh2[:, None] * mult**2)
        w_soft = inl.to(uv1.dtype) / (1.0 + err / torch.clamp(thresh2[:, None], min=1e-20))
        _, vecs = torch.linalg.eigh(_normal_matrix(x1n, x2n, w_soft))
        F_new = _rank2(vecs[..., :, 0].unflatten(-1, (3, 3)))
        better = count(F_new) >= (mask & (err < thresh2[:, None])).sum(-1)
        return torch.where(better[:, None, None], F_new, F)

    F_final = _rank2(F_best)
    for m in torch.linspace(2.0, 1.0, opts.lo_rounds, dtype=torch.float32).tolist():
        F_final = lo_round(F_final, m)

    if opts.degensac:
        Hh = opts.degensac_h_hypotheses
        if degensac_uniforms is None:
            degensac_uniforms = (
                counter_uniform(seed, TAG_DEGENSAC_H, stream_ids, (Hh, K)),
                counter_uniform(seed, TAG_DEGENSAC_PP, stream_ids, (4 * Hh, 2, K)),
            )
        F_final = _degensac_recover(x1n, x2n, mask, F_final, thresh2, opts.degensac_h_ratio, *degensac_uniforms)

    inliers = mask & (_sampson_f(F_final, x1n, x2n) < thresh2[:, None])
    F_px = mm(mm(T2.transpose(-1, -2), F_final), T1)
    F_px = F_px / torch.clamp(torch.linalg.vector_norm(F_px, dim=(-2, -1), keepdim=True), min=1e-12)
    n = inliers.sum(-1)
    return {"F": F_px, "inliers": inliers, "num_inliers": n, "success": n >= opts.min_inliers}


def _degensac_recover(x1n, x2n, mask, F, thresh2, h_ratio, u_h, u_pp):
    """Plane-and-parallax re-estimation when F was fit to a dominant plane,
    in Hartley-normalized coordinates: a homography RANSAC over the F
    inliers (draws u_h (P, Hh, K)) with 3 refits; if it explains >= h_ratio
    of them, epipole candidates from pairs of off-plane parallax lines
    (draws u_pp (P, 4 Hh, 2, K)), the best 8 refit on their off-plane
    consensus, and F_pp = [e']_x H kept if it beats F's full-set MSAC."""
    t2 = thresh2[:, None]
    f_inl = mask & (_sampson_f(F, x1n, x2n) < t2)
    w_inl = f_inl.to(x1n.dtype)

    idx = torch.topk(u_h * w_inl[:, None, :], 4, dim=-1).indices  # (P, Hh, 4)
    A = _gather_rows(_h_rows(x1n, x2n) * w_inl[..., None, None], idx).flatten(2, 3)  # (P, Hh, 8, 9)
    Hs = nullvec_pinned(torch.einsum("phkr,phks->phrs", A, A)).unflatten(-1, (3, 3))
    votes = (f_inl[:, None] & (_h_transfer_err(Hs, x1n[:, None], x2n[:, None]) < thresh2[:, None, None])).sum(-1)
    H = _pick(Hs, torch.argmax(votes, -1))
    for _ in range(3):
        e_c = _h_transfer_err(H, x1n, x2n)
        w_c = torch.where(f_inl, torch.clamp(1.0 - e_c / t2, min=0.0), torch.zeros_like(e_c))
        _, vecs = torch.linalg.eigh(_h_normal_matrix(x1n, x2n, w_c))
        H_new = vecs[..., :, 0].unflatten(-1, (3, 3))
        n_new = (f_inl & (_h_transfer_err(H_new, x1n, x2n) < t2)).sum(-1)
        n_old = (f_inl & (e_c < t2)).sum(-1)
        H = torch.where((n_new >= n_old)[:, None, None], H_new, H)
    h_err = _h_transfer_err(H, x1n, x2n)
    n_f = torch.clamp(f_inl.sum(-1), min=1)
    degenerate = (f_inl & (h_err < t2)).sum(-1) / n_f >= h_ratio

    off = mask & (h_err >= t2)
    offf = off.to(x1n.dtype)
    lines = torch.linalg.cross(_homog(x2n), torch.einsum("pij,pkj->pki", H, _homog(x1n)), dim=-1)
    lines = lines / torch.clamp(torch.linalg.vector_norm(lines, dim=-1, keepdim=True), min=1e-12)

    def off_msac(F_c):  # F_c (P, C, 3, 3)
        err_c = _sampson_f(F_c, x1n[:, None], x2n[:, None])
        return torch.sum(torch.where(off[:, None], torch.clamp(1.0 - err_c / thresh2[:, None, None], min=0.0),
                                     torch.zeros_like(err_c)), -1)

    def from_epipole(e2):  # (P, C, 3) -> unit [e']_x H, its norm
        F_c = mm(so3.hat(e2), H[:, None])
        nrm = torch.linalg.vector_norm(F_c, dim=(-2, -1), keepdim=True)
        return F_c / torch.clamp(nrm, min=1e-12), nrm[..., 0, 0]

    a = torch.argmax(u_pp[:, :, 0] * offf[:, None], -1)  # (P, C)
    ub = u_pp[:, :, 1] * offf[:, None]
    ub = ub.scatter(-1, a[..., None], -1.0)  # a distinct second point
    b = torch.argmax(ub, -1)

    def line_at(i):
        return torch.gather(lines, 1, i[..., None].expand(*i.shape, 3))

    pp_F, nrm = from_epipole(torch.linalg.cross(line_at(a), line_at(b), dim=-1))
    pp_votes = torch.where(nrm > 1e-9, off_msac(pp_F), torch.full_like(nrm, -1.0))

    def refit_epipole(F_c):
        err_c = _sampson_f(F_c, x1n[:, None], x2n[:, None])
        w_l = torch.where(off[:, None], torch.clamp(1.0 - err_c / thresh2[:, None, None], min=0.0),
                          torch.zeros_like(err_c))
        L = torch.einsum("pki,pck,pkj->pcij", lines, w_l, lines)
        _, vecs = torch.linalg.eigh(L)
        F_new, _ = from_epipole(vecs[..., :, 0])
        better = (off_msac(F_new) >= off_msac(F_c)) & ((w_l > 0).sum(-1) >= 2)
        return torch.where(better[..., None, None], F_new, F_c)

    # the best 8 candidates (equal votes lowest index first, as top_k)
    top8 = torch.sort(pp_votes, dim=-1, descending=True, stable=True).indices[:, :8]
    F_top = torch.gather(pp_F, 1, top8[..., None, None].expand(*top8.shape, 3, 3))
    for _ in range(2):
        F_top = refit_epipole(F_top)
    top_scores = off_msac(F_top)
    F_pp = refit_epipole(_pick(F_top, torch.argmax(top_scores, -1))[:, None])[:, 0]

    def full_msac(F_c):
        err_c = _sampson_f(F_c, x1n, x2n)
        return torch.sum(torch.where(mask, torch.clamp(1.0 - err_c / t2, min=0.0), torch.zeros_like(err_c)), -1)

    use_pp = (
        degenerate
        & (top_scores.amax(-1) > 0)
        & (off.sum(-1) >= 2)
        & (full_msac(F_pp) > full_msac(F))
        & torch.isfinite(F_pp).all(-1).all(-1)
    )
    return torch.where(use_pp[:, None, None], F_pp, F)


def fundamental_to_essential(F: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    """E = K2^T F K1 (..., 3, 3) projected to the essential manifold."""
    E = mm(mm(K2.transpose(-1, -2), F), K1)
    U, _, Vt = torch.linalg.svd(E)
    S = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return mm(U * S, Vt)


@precise()
def ransac_homography(
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    mask: torch.Tensor,
    threshold_px: float = 3.0,
    num_hypotheses: int = 256,
    sample_idx: torch.Tensor | None = None,
    seed: int = 0,
    stream_ids: torch.Tensor | None = None,
):
    """Homography RANSAC on pixel correspondences (4-point DLT hypotheses,
    inlier-count votes, first maximum). ``sample_idx`` (P, H, 4) replaces
    the draws. Returns H in Hartley-normalized coordinates (as the
    reference), inliers (P, K) and num_inliers (P,)."""
    maskf = mask.to(uv1.dtype)
    x1n, T1 = _hartley_normalize(uv1, maskf)
    x2n, T2 = _hartley_normalize(uv2, maskf)
    thresh2 = (threshold_px * (0.5 * (T1[:, 0, 0] + T2[:, 0, 0]))) ** 2
    if sample_idx is None:
        sample_idx = sample_homography_sets(mask, num_hypotheses, seed, stream_ids)
    A = _gather_rows(_h_rows(x1n, x2n) * maskf[..., None, None], sample_idx).flatten(2, 3)  # (P, H, 8, 9)
    Hs = nullvec_pinned(torch.einsum("phkr,phks->phrs", A, A)).unflatten(-1, (3, 3))
    err_h = _h_transfer_err(Hs, x1n[:, None], x2n[:, None])
    votes = (mask[:, None] & (err_h < thresh2[:, None, None])).sum(-1)
    H = _pick(Hs, torch.argmax(votes, -1))
    inliers = mask & (_h_transfer_err(H, x1n, x2n) < thresh2[:, None])
    return {"H": H, "inliers": inliers, "num_inliers": inliers.sum(-1)}


def gric_select_model(f_inliers: torch.Tensor, h_inliers: torch.Tensor, mask: torch.Tensor,
                      h_f_inlier_ratio_threshold: float = 0.8):
    """The degeneracy rule: a pair whose homography explains at least the
    threshold's share of the F/E inliers is planar or rotation-only.
    Returns (is_degenerate bool (P,), hf_ratio (P,))."""
    nf = torch.clamp((f_inliers & mask).sum(-1), min=1)
    ratio = (h_inliers & mask).sum(-1) / nf
    return ratio >= h_f_inlier_ratio_threshold, ratio
