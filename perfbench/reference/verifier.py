"""Plain reference of the two-view verifier: essential-matrix RANSAC on
counter-based weighted minimal sets (MSAC votes on a preemptive subset,
dual-start locally optimized refits, cheirality pose recovery, two
Gauss-Newton polish rounds) and the two-view refinement with its
keep-best guard and the validity rule, batched over pairs.

A frozen copy of the plain PyTorch code of the port's
``frontend/two_view.py`` and ``frontend/verifiers/essential.py`` at the
options both configurations run (RansacOptions() defaults, MSAC scoring,
the homography and indeterminacy checks off), with the draws worked out
again from the seed and the pairs' global ids. Calibration is the pinhole
of the scene's own focal length and principal point (the Olsson folder
the benchmark wrote has no distortion).
"""

from __future__ import annotations

import torch

from perfbench.reference.numerics import (
    counter_uniform,
    eigh,
    expmap,
    hat,
    jacobian_fwd,
    nullvec_pinned_scalarized,
    precision,
    svd,
)

NUM_HYPOTHESES = 512
LO_ROUNDS = 3
MIN_INLIERS = 8
POLISH_ITERATIONS = 8
POLISH_HUBER = 2.0
SCORE_SUBSET = 256
MATCHING_RATIO = 0.8
BA_ITERATIONS = 6
BA_HUBER = 2.0
TAG_POOL_TIE = 1
TAG_SAMPLE = 2


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _normal_matrix(x1, x2, w):
    p1, p2 = _homog(x1), _homog(x2)
    A = (p2[..., :, :, None] * p1[..., :, None, :]).flatten(-2)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)
    return torch.einsum("...ki,...kj->...ij", A * w[..., None], A)


def _project_essential(E):
    U, _, Vt = svd(E)
    S = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return torch.matmul(U * S, Vt)


def _eight_point(x1, x2, w):
    _, vecs = eigh(_normal_matrix(x1, x2, w))
    return _project_essential(vecs[..., :, 0].unflatten(-1, (3, 3)))


def sampson(E, x1, x2):
    """Sampson error (..., K) of E (..., 3, 3) on normalized x (..., K, 2)."""
    E = E / torch.clamp(torch.linalg.vector_norm(E, dim=(-2, -1), keepdim=True), min=1e-20)
    p1, p2 = _homog(x1), _homog(x2)
    Ex1 = torch.einsum("...ij,...kj->...ki", E, p1)
    Etx2 = torch.einsum("...ji,...kj->...ki", E, p2)
    num = torch.sum(p2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return torch.where(den > 1e-9, num / torch.clamp(den, min=1e-12), torch.full_like(num, 1e9))


def _triangulate_midpoint(R, t, x1, x2):
    f1, f2 = _homog(x1), _homog(x2)
    f1 = f1 / torch.linalg.vector_norm(f1, dim=-1, keepdim=True)
    f2 = f2 / torch.linalg.vector_norm(f2, dim=-1, keepdim=True)
    Rf1 = torch.einsum("...ij,...kj->...ki", R, f1)
    a = torch.sum(Rf1 * Rf1, dim=-1)
    b = -torch.sum(Rf1 * f2, dim=-1)
    c = torch.sum(f2 * f2, dim=-1)
    rhs1 = -torch.sum(Rf1 * t[..., None, :], dim=-1)
    rhs2 = torch.sum(f2 * t[..., None, :], dim=-1)
    det = a * c - b * b
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    d1 = (c * rhs1 - b * rhs2) / det
    d2 = (a * rhs2 - b * rhs1) / det
    return d1 * f1[..., 2], d2 * f2[..., 2]


def _recover_pose(E, x1, x2, w):
    U, _, Vt = svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    Ra = torch.matmul(torch.matmul(U, W), Vt)
    Rb = torch.matmul(torch.matmul(U, W.T), Vt)
    t = U[..., :, 2]
    cands_R = torch.stack([Ra, Ra, Rb, Rb], dim=-3)
    cands_t = torch.stack([t, -t, t, -t], dim=-2)
    z1, z2 = _triangulate_midpoint(cands_R, cands_t, x1[..., None, :, :], x2[..., None, :, :])
    votes = torch.sum(w[..., None, :] * (z1 > 0) * (z2 > 0), dim=-1)
    best = torch.argmax(votes, dim=-1)
    R_best = torch.gather(cands_R, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    t_best = torch.gather(cands_t, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    t_best = t_best / torch.clamp(torch.linalg.vector_norm(t_best, dim=-1, keepdim=True), min=1e-12)
    return R_best, t_best


def _tangent_basis(t):
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    e2 = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    a = torch.where((t[..., 0].abs() < 0.9)[..., None], e1, e2)
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1, keepdim=True), min=1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def _perturb(params, R, t):
    Rn = torch.matmul(R, expmap(params[..., :3]))
    tn = t + torch.einsum("...ij,...j->...i", _tangent_basis(t), params[..., 3:])
    tn = tn / torch.clamp(torch.linalg.vector_norm(tn, dim=-1, keepdim=True), min=1e-12)
    return Rn, tn


def _residual(params, R, t, x1, x2):
    Rn, tn = _perturb(params, R, t)
    return torch.sqrt(torch.clamp(sampson(torch.matmul(hat(tn), Rn), x1, x2), min=1e-18))


def _refine(x1, x2, w, R0, t0, iters, huber, thresh):
    P = x1.shape[0]
    dev, dt = x1.device, x1.dtype
    eye5 = torch.eye(5, dtype=dt, device=dev)
    k = (huber * thresh)[:, None]
    z5 = torch.zeros((P, 5), dtype=dt, device=dev)
    R, t = R0, t0
    lam = torch.full((P,), 1e-3, dtype=dt, device=dev)

    def cost(params):
        rr = _residual(params, R, t, x1, x2)
        rho = torch.where(rr <= k, 0.5 * rr**2, k * (rr - 0.5 * k))
        return torch.sum(w * rho, dim=-1)

    for _ in range(iters):
        r = _residual(z5, R, t, x1, x2)
        J = jacobian_fwd(lambda p: _residual(p, R, t, x1, x2), z5)
        w_rob = torch.clamp(k / torch.clamp(r, min=1e-12), max=1.0)
        Jw = J * (w * w_rob)[..., None]
        H = torch.einsum("pki,pkj->pij", Jw, J) + lam[:, None, None] * eye5 * 10.0 + 1e-9 * eye5
        g = torch.einsum("pki,pk->pi", Jw, r)
        delta = torch.linalg.solve_ex(H, -g[..., None])[0][..., 0]
        accept = (cost(delta) < cost(z5))[:, None]
        R, t = _perturb(torch.where(accept, delta, z5), R, t)
        lam = torch.clamp(torch.where(accept[:, 0], lam * 0.5, lam * 4.0), 1e-10, 1e4)
    return R, t


def _votes(E_hyps, x1, x2, mask, thresh2):
    P, K = mask.shape
    if 0 < SCORE_SUBSET < K:
        order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
        S = SCORE_SUBSET
        pos = torch.arange(S, device=mask.device)[None] * torch.clamp(mask.sum(-1), min=1)[:, None] // S
        sub = torch.gather(order, 1, pos)
        x1 = torch.gather(x1, 1, sub[..., None].expand(P, S, 2))
        x2 = torch.gather(x2, 1, sub[..., None].expand(P, S, 2))
        mask = torch.gather(mask, 1, sub)
    err_h = sampson(E_hyps, x1[:, None], x2[:, None])
    gain = torch.clamp(thresh2[:, None, None] - err_h, min=0.0)
    return torch.sum(torch.where(mask[:, None], gain, torch.zeros_like(gain)), -1)


def minimal_sets(mask, weights, seed: int, pair_ids):
    """Weighted 8-subsets (P, H, 8): a quality-ranked pool with a random
    tie-break, then the top 8 of u^(1/w) per hypothesis."""
    P, K = mask.shape
    sw = torch.clamp(weights, min=1e-6) * mask.to(torch.float32)
    pool = min(K, 256)
    tie = counter_uniform(seed, TAG_POOL_TIE, pair_ids, (K,), 0.5, 1.0)
    pool_idx = torch.topk(torch.where(mask, sw * tie, torch.full_like(sw, -1.0)), pool, dim=-1).indices
    sw_pool = torch.gather(sw, 1, pool_idx)
    mask_pool = torch.gather(mask, 1, pool_idx)
    u = counter_uniform(seed, TAG_SAMPLE, pair_ids, (NUM_HYPOTHESES, pool), 1e-12, 1.0)
    keys = torch.where(mask_pool[:, None, :], u ** (1.0 / sw_pool[:, None, :]), torch.full_like(u, -1.0))
    top8 = torch.topk(keys, 8, dim=-1).indices
    return torch.gather(pool_idx[:, None, :].expand(P, NUM_HYPOTHESES, pool), 2, top8)


def _ransac(x1, x2, mask, thresh, sample_idx):
    P, K = mask.shape
    dev = x1.device
    maskf = mask.to(x1.dtype)
    n_valid = mask.sum(-1)
    thresh2 = thresh**2
    H = sample_idx.shape[1]
    p1h, p2h = _homog(x1), _homog(x2)
    A = (p2h[..., :, None] * p1h[..., None, :]).flatten(-2)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12) * maskf[..., None]
    A8 = torch.gather(A, 1, sample_idx.reshape(P, H * 8, 1).expand(P, H * 8, 9).to(torch.int64)).reshape(P, H, 8, 9)
    E_hyps = nullvec_pinned_scalarized(torch.einsum("phkr,phks->phrs", A8, A8)).reshape(P, H, 3, 3)
    best = torch.argmax(_votes(E_hyps, x1, x2, mask, thresh2), dim=-1)
    E_best = torch.gather(E_hyps, 1, best[:, None, None, None].expand(P, 1, 3, 3))[:, 0]
    zero = torch.zeros((), dtype=x1.dtype, device=dev)

    def quality(err):
        return torch.sum(torch.where(mask, torch.clamp(thresh2[:, None] - err, min=0.0), zero), dim=-1)

    def lo_round(E, mult):
        err = sampson(E, x1, x2)
        inl = mask & (err < thresh2[:, None] * mult**2)
        w_soft = inl.to(x1.dtype) / (1.0 + err / torch.clamp(thresh2[:, None], min=1e-20))
        E_new = _eight_point(x1, x2, w_soft)
        better = quality(sampson(E_new, x1, x2)) >= quality(err)
        return torch.where(better[:, None, None], E_new, E)

    mults = torch.linspace(2.0, 1.0, LO_ROUNDS, dtype=torch.float32).tolist()
    E_a, E_b = E_best, _project_essential(E_best)
    for m in mults:
        E_a = lo_round(E_a, m)
    for m in mults:
        E_b = lo_round(E_b, m)
    E = torch.where((quality(sampson(E_a, x1, x2)) >= quality(sampson(E_b, x1, x2)))[:, None, None], E_a, E_b)
    inl = mask & (sampson(E, x1, x2) < thresh2[:, None])
    R0, t0 = _recover_pose(E, x1, x2, inl.to(x1.dtype))
    E_pre, R_pre, t_pre, inl_pre = E, R0, t0, inl
    q_pre = quality(sampson(E_pre, x1, x2))
    polish_thresh = torch.sqrt(thresh2)
    for _ in range(2):
        R0, t0 = _refine(x1, x2, inl.to(x1.dtype), R0, t0, POLISH_ITERATIONS, POLISH_HUBER, polish_thresh)
        E = torch.matmul(hat(t0), R0)
        inl = mask & (sampson(E, x1, x2) < thresh2[:, None])
    R0, t0 = _recover_pose(E, x1, x2, inl.to(x1.dtype))
    worse = quality(sampson(E, x1, x2)) < q_pre
    R0 = torch.where(worse[:, None, None], R_pre, R0)
    t0 = torch.where(worse[:, None], t_pre, t0)
    inl = torch.where(worse[:, None], inl_pre, inl)
    return R0, t0, inl, (inl.sum(-1) >= MIN_INLIERS) & (n_valid >= 8)


def calibrate(uv, focal, center):
    """Pixels (P, K, 2) -> normalized coordinates of pinholes (P,) focal,
    (P, 2) principal point."""
    return (uv - center[:, None, :]) / focal[:, None, None]


def verify(kp_xy1, kp_xy2, match_idx, match_mask, match_score, focal1, focal2, center1, center2, pair_ids,
           seed: int, two_view: dict, tf32: bool = False) -> dict:
    """The verifier on given matches (match_idx (P, K1) into image 2's
    keypoints where match_mask): -> {"R", "t", "inliers", "valid",
    "num_inliers"} batched over pairs. ``two_view`` holds the
    configuration's threshold_px, min_num_inliers and min_inlier_ratio."""
    with precision(tf32):
        P, K = match_mask.shape
        corr_i2 = torch.where(match_mask, match_idx, 0).to(torch.int64)
        uv2 = torch.gather(kp_xy2, 1, corr_i2[..., None].expand(P, K, 2))
        x1 = calibrate(kp_xy1, focal1, center1)
        x2 = calibrate(uv2, focal2, center2)
        thresh = two_view["threshold_px"] / torch.clamp(0.5 * (focal1 + focal2), min=1e-6)
        sw = torch.clamp((match_score + 1.0) * 0.5, 1e-3, 1.0) ** 4
        sample_idx = minimal_sets(match_mask, sw, seed, pair_ids)
        R, t, inl, success = _ransac(x1, x2, match_mask, thresh, sample_idx)

        def quality(R_, t_):
            err = sampson(torch.matmul(hat(t_), R_), x1, x2)
            gain = torch.clamp(thresh[:, None] ** 2 - err, min=0.0)
            return torch.sum(torch.where(match_mask, gain, torch.zeros_like(gain)), dim=-1)

        q_pre, R_pre, t_pre, inl_pre = quality(R, t), R, t, inl
        R, t = _refine(x1, x2, inl.to(x1.dtype), R, t, BA_ITERATIONS, BA_HUBER, thresh)
        E = torch.matmul(hat(t), R)
        inl = match_mask & (sampson(E, x1, x2) < thresh[:, None] ** 2)
        R, t = _recover_pose(E, x1, x2, inl.to(x1.dtype))
        worse = quality(R, t) < q_pre
        R = torch.where(worse[:, None, None], R_pre, R)
        t = torch.where(worse[:, None], t_pre, t)
        inl = torch.where(worse[:, None], inl_pre, inl)
        n_match = match_mask.sum(-1)
        n_inl = inl.sum(-1)
        ratio = n_inl / torch.clamp(n_match, min=1)
        valid = success & (n_inl >= two_view["min_num_inliers"]) & (ratio >= two_view["min_inlier_ratio"])
        return {"R": R, "t": t, "inliers": inl & valid[:, None], "valid": valid, "num_inliers": n_inl}
