"""Batched DLT triangulation with fixed-hypothesis RANSAC over view pairs.

Port of gtsfm_tpu/bundle/triangulation.py, mode RANSAC_SAMPLE_UNIFORM (the
mode the reconstruction path uses; NO_RANSAC, biased-baseline and top-K
modes are still to be ported). Every track is a fixed-size padded problem
and all tracks are solved together; hypothesis view pairs are drawn by
Gumbel-max over the valid pairs.

The uniforms behind the Gumbel draws come from a counter stream keyed by
the track index, or are passed in (``uniforms`` (T, H, K(K-1)/2); the tests
replay the reference's ``jax.random`` draws).
"""

from __future__ import annotations

import torch

from gtsfm_tpu_torch.geometry import SE3
from gtsfm_tpu_torch.utils.numerics import counter_uniform, nullvec_pinned, precise

TAG_GUMBEL = 3


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


def triangulate_tracks(
    wTi_all: SE3,
    cal,
    track_cam_idx: torch.Tensor,  # i64 (T, K)
    track_uv: torch.Tensor,  # (T, K, 2)
    track_mask: torch.Tensor,  # bool (T, K)
    reproj_threshold_px: float = 3.0,
    num_hypotheses: int = 64,
    min_triangulation_angle_deg: float = 1.0,
    seed: int = 0,
    uniforms: torch.Tensor | None = None,
):
    """Triangulate a padded batch of tracks. Returns (points (T, 3),
    inliers bool (T, K), ok bool (T,))."""
    with precise():
        dev = track_uv.device
        T, K = track_cam_idx.shape
        cal_m = cal.map(lambda a: a[track_cam_idx])
        xy = cal_m.calibrate(track_uv)
        thresh = reproj_threshold_px / torch.clamp(cal_m.fx, min=1e-6)
        mask = track_mask
        thr = torch.sum(torch.where(mask, thresh, torch.zeros_like(thresh)), -1) / torch.clamp(mask.sum(-1), min=1)

        poses = wTi_all.map(lambda a: a[track_cam_idx])  # (T, K)
        R_cw = poses.R.transpose(-1, -2)
        t_cw = -torch.einsum("...ij,...j->...i", R_cw, poses.t)
        centers = poses.t

        pair_i, pair_j = torch.triu_indices(K, K, 1, device=dev)
        n_pairs = pair_i.shape[0]
        pair_valid = mask[:, pair_i] & mask[:, pair_j]
        logits = torch.where(pair_valid, 0.0, float("-inf"))
        if uniforms is None:
            uniforms = counter_uniform(seed, TAG_GUMBEL, torch.arange(T, device=dev),
                                       (num_hypotheses, n_pairs), 1e-12, 1.0)
        gumbel = -torch.log(-torch.log(uniforms))
        idx = torch.argmax(logits[:, None, :] + gumbel, dim=-1)  # (T, H)
        hi, hj = pair_i[idx], pair_j[idx]

        ar = torch.arange(K, device=dev)
        two_mask = ((ar == hi[..., None]) | (ar == hj[..., None])) & mask[:, None, :]  # (T, H, K)
        X_h = _dehomogenize(nullvec_pinned(
            _dlt_normal_matrix(R_cw[:, None], t_cw[:, None], xy[:, None], two_mask)
        ))  # (T, H, 3)
        xy_hat, depth = _reproj_and_depth(R_cw[:, None], t_cw[:, None], X_h)  # (T, H, K)
        err = torch.linalg.vector_norm(xy_hat - xy[:, None], dim=-1)
        inl = mask[:, None] & (depth > 0) & (err < thr[:, None, None])
        d_i = torch.gather(depth, 2, hi[..., None])[..., 0]
        d_j = torch.gather(depth, 2, hj[..., None])[..., 0]
        ok_h = (hi != hj) & (d_i > 0) & (d_j > 0) & mask.gather(1, hi) & mask.gather(1, hj)
        votes = torch.where(ok_h, inl.sum(-1), -1)
        best = torch.argmax(votes, dim=-1)  # (T,)
        best_inl = torch.gather(inl, 1, best[:, None, None].expand(T, 1, K))[:, 0]
        best_votes = torch.gather(votes, 1, best[:, None])[:, 0]

        _, vecs = torch.linalg.eigh(_dlt_normal_matrix(R_cw, t_cw, xy, best_inl))
        X = _dehomogenize(vecs[..., :, 0])  # (T, 3)
        xy_hat, depth = _reproj_and_depth(R_cw, t_cw, X)
        err = torch.linalg.vector_norm(xy_hat - xy, dim=-1)
        inliers = mask & (depth > 0) & (err < thr[:, None])

        rays = X[:, None, :] - centers
        rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-12)
        cosang = torch.clamp(torch.einsum("tid,tjd->tij", rays, rays), -1.0, 1.0)
        ang = torch.rad2deg(torch.arccos(cosang))
        pair_inl = inliers[:, :, None] & inliers[:, None, :]
        max_angle = torch.amax(torch.where(pair_inl, ang, torch.zeros_like(ang)), dim=(-2, -1))
        ok = (inliers.sum(-1) >= 2) & (max_angle >= min_triangulation_angle_deg) & (best_votes >= 2)
        return X, inliers, ok
