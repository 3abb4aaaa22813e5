"""Batched DLT triangulation with fixed-hypothesis RANSAC over view pairs.

Port of gtsfm_tpu/bundle/triangulation.py with its four modes: NO_RANSAC
(one DLT over every observation), RANSAC_SAMPLE_UNIFORM (the default),
RANSAC_SAMPLE_BIASED_BASELINE and RANSAC_TOPK_BASELINES. Every track is a
fixed-size padded problem and all tracks are solved together; sampled
hypothesis view pairs are drawn by Gumbel-max over the valid pairs
(uniform or with the baseline as logit), the top-K mode takes the K widest
baselines (a stable sort, masked pairs last).

The uniforms behind the Gumbel draws come from a counter stream keyed by
the track index, or are passed in (``uniforms`` (T, H, K(K-1)/2); the tests
replay the reference's ``jax.random`` draws).
"""

from __future__ import annotations

import enum

import torch

from gtsfm_tpu_torch.geometry import SE3
from gtsfm_tpu_torch.utils.numerics import counter_uniform, eigh, nullvec_pinned, precise

TAG_GUMBEL = 3


class TriangulationMode(enum.Enum):
    NO_RANSAC = 0
    RANSAC_SAMPLE_UNIFORM = 1
    RANSAC_SAMPLE_BIASED_BASELINE = 2
    RANSAC_TOPK_BASELINES = 3


def _dlt_normal_matrix(R_cw, t_cw, xy, mask) -> torch.Tensor:
    """Row-normalized DLT normal matrix (..., 4, 4) from world->camera
    poses (..., K, 3, 3), (..., K, 3), normalized coords (..., K, 2)."""
    P = torch.cat([R_cw, t_cw[..., None]], dim=-1)  # (..., K, 3, 4)
    rows_u = xy[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    rows_v = xy[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 2K, 4)
    A = A * torch.cat([mask, mask], dim=-1).to(A.dtype)[..., None]
    norms = torch.linalg.vector_norm(A, dim=-1, keepdim=True)
    A = A / torch.where(norms < 1e-12, torch.ones_like(norms), norms)
    return torch.einsum("...ki,...kj->...ij", A, A)


def _dehomogenize(X_h: torch.Tensor) -> torch.Tensor:
    w = X_h[..., 3]
    tiny = torch.where(w < 0, torch.full_like(w, -1e-12), torch.full_like(w, 1e-12))
    w_safe = torch.where(w.abs() < 1e-12, tiny, w)
    return X_h[..., :3] / w_safe[..., None]


def _reproj_and_depth(R_cw, t_cw, X):
    """Normalized-plane reprojection of X (..., 3) into cameras (..., K):
    (xy_hat (..., K, 2), depth (..., K))."""
    p_cam = torch.einsum("...kij,...j->...ki", R_cw, X) + t_cw
    z = p_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return p_cam[..., :2] / z_safe[..., None], z


def _world_to_camera(wTi: SE3):
    R_cw = wTi.R.transpose(-1, -2)
    return R_cw, -torch.einsum("...ij,...j->...i", R_cw, wTi.t)


def _solve_dlt(R_cw, t_cw, xy, mask) -> torch.Tensor:
    """Exact DLT (eigh of the 4x4 normal matrix), dehomogenized (..., 3)."""
    _, vecs = eigh(_dlt_normal_matrix(R_cw, t_cw, xy, mask))
    return _dehomogenize(vecs[..., :, 0])


@precise()
def triangulate_dlt(wTi: SE3, xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Exact DLT triangulation of tracks: cameras wTi batched (..., K),
    normalized coordinates xy (..., K, 2), mask (..., K). Returns world
    points (..., 3), meaningless with fewer than two valid views."""
    return _solve_dlt(*_world_to_camera(wTi), xy, mask)


@precise()
def triangulate_dlt_fast(wTi: SE3, xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Hypothesis-grade DLT: the pinned-coordinate nullvector (a closed-form
    3x3 adjugate solve, pinning X_h[3] = 1) instead of an eigh."""
    R_cw, t_cw = _world_to_camera(wTi)
    return _dehomogenize(nullvec_pinned(_dlt_normal_matrix(R_cw, t_cw, xy, mask)))


def _inliers(R_cw, t_cw, X, xy, mask, thr):
    xy_hat, depth = _reproj_and_depth(R_cw, t_cw, X)
    err = torch.linalg.vector_norm(xy_hat - xy, dim=-1)
    return mask & (depth > 0) & (err < thr[..., None]), depth


@precise()
def triangulate_track_ransac(
    wTi: SE3,
    xy: torch.Tensor,  # (T, K, 2) normalized coordinates
    mask: torch.Tensor,  # bool (T, K)
    reproj_threshold: torch.Tensor,  # (T,) normalized units
    num_hypotheses: int = 64,
    min_triangulation_angle_deg: float = 1.0,
    mode: TriangulationMode = TriangulationMode.RANSAC_SAMPLE_UNIFORM,
    seed: int = 0,
    uniforms: torch.Tensor | None = None,
):
    """RANSAC-DLT of T tracks over 2-view hypotheses (cameras wTi batched
    (T, K)). Returns (points (T, 3), inliers bool (T, K), ok bool (T,)).
    ``uniforms`` (T, H, K(K-1)/2) replace the Gumbel draws of the two
    sampling modes."""
    dev = xy.device
    T, K = mask.shape
    R_cw, t_cw = _world_to_camera(wTi)
    thr = reproj_threshold
    if mode == TriangulationMode.NO_RANSAC:
        X = _solve_dlt(R_cw, t_cw, xy, mask)
        inliers, _ = _inliers(R_cw, t_cw, X, xy, mask, thr)
        return X, inliers, inliers.sum(-1) >= 2

    centers = wTi.t
    pair_i, pair_j = torch.triu_indices(K, K, 1, device=dev)
    n_pairs = pair_i.shape[0]
    pair_valid = mask[:, pair_i] & mask[:, pair_j]
    if mode == TriangulationMode.RANSAC_TOPK_BASELINES:
        pair_base = torch.linalg.vector_norm(centers[:, pair_i] - centers[:, pair_j], dim=-1) * pair_valid
        k_eff = min(num_hypotheses, n_pairs)
        top = torch.argsort(-pair_base, dim=-1, stable=True)[:, :k_eff]
        pad = torch.zeros((T, num_hypotheses - k_eff), dtype=torch.int64, device=dev)
        hi = torch.cat([pair_i[top], pad], -1)  # padding hypotheses (0, 0) never vote
        hj = torch.cat([pair_j[top], pad], -1)
    else:
        if mode == TriangulationMode.RANSAC_SAMPLE_BIASED_BASELINE:
            pair_base = torch.linalg.vector_norm(centers[:, pair_i] - centers[:, pair_j], dim=-1) * pair_valid
            logits = torch.where(pair_valid, pair_base, float("-inf"))
        else:
            logits = torch.where(pair_valid, 0.0, float("-inf"))
        if uniforms is None:
            uniforms = counter_uniform(seed, TAG_GUMBEL, torch.arange(T, device=dev),
                                       (num_hypotheses, n_pairs), 1e-12, 1.0)
        gumbel = -torch.log(-torch.log(uniforms))
        idx = torch.argmax(logits[:, None, :] + gumbel, dim=-1)  # (T, H)
        hi, hj = pair_i[idx], pair_j[idx]

    ar = torch.arange(K, device=dev)
    two_mask = ((ar == hi[..., None]) | (ar == hj[..., None])) & mask[:, None, :]  # (T, H, K)
    X_h = triangulate_dlt_fast(wTi.map(lambda a: a[:, None]), xy[:, None], two_mask)  # (T, H, 3)
    inl, depth = _inliers(R_cw[:, None], t_cw[:, None], X_h, xy[:, None], mask[:, None], thr[:, None])
    d_i = torch.gather(depth, 2, hi[..., None])[..., 0]
    d_j = torch.gather(depth, 2, hj[..., None])[..., 0]
    ok_h = (hi != hj) & (d_i > 0) & (d_j > 0) & mask.gather(1, hi) & mask.gather(1, hj)
    votes = torch.where(ok_h, inl.sum(-1), -1)
    best = torch.argmax(votes, dim=-1)  # (T,) first maximum, as jnp.argmax
    best_inl = torch.gather(inl, 1, best[:, None, None].expand(T, 1, K))[:, 0]
    best_votes = torch.gather(votes, 1, best[:, None])[:, 0]

    X = _solve_dlt(R_cw, t_cw, xy, best_inl)  # (T, 3)
    inliers, _ = _inliers(R_cw, t_cw, X, xy, mask, thr)
    rays = X[:, None, :] - centers
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-12)
    cosang = torch.clamp(torch.einsum("tid,tjd->tij", rays, rays), -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(cosang))
    pair_inl = inliers[:, :, None] & inliers[:, None, :]
    max_angle = torch.amax(torch.where(pair_inl, ang, torch.zeros_like(ang)), dim=(-2, -1))
    ok = (inliers.sum(-1) >= 2) & (max_angle >= min_triangulation_angle_deg) & (best_votes >= 2)
    return X, inliers, ok


def triangulate_tracks(
    wTi_all: SE3,
    cal,
    track_cam_idx: torch.Tensor,  # i64 (T, K)
    track_uv: torch.Tensor,  # (T, K, 2)
    track_mask: torch.Tensor,  # bool (T, K)
    reproj_threshold_px: float = 3.0,
    num_hypotheses: int = 64,
    mode: TriangulationMode = TriangulationMode.RANSAC_SAMPLE_UNIFORM,
    min_triangulation_angle_deg: float = 1.0,
    seed: int = 0,
    uniforms: torch.Tensor | None = None,
):
    """Triangulate a padded batch of tracks: pixels are calibrated per
    observation and the pixel threshold becomes each track's mean
    normalized one. Returns (points (T, 3), inliers bool (T, K), ok bool
    (T,))."""
    with precise():
        cal_m = cal.map(lambda a: a[track_cam_idx])
        xy = cal_m.calibrate(track_uv)
        thresh = reproj_threshold_px / torch.clamp(cal_m.fx, min=1e-6)
        mask = track_mask
        thr = torch.sum(torch.where(mask, thresh, torch.zeros_like(thresh)), -1) / torch.clamp(mask.sum(-1), min=1)
        return triangulate_track_ransac(
            wTi_all.map(lambda a: a[track_cam_idx]), xy, mask, thr, num_hypotheses=num_hypotheses,
            min_triangulation_angle_deg=min_triangulation_angle_deg, mode=mode, seed=seed, uniforms=uniforms,
        )
