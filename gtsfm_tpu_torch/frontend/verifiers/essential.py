"""Essential-matrix estimation: fixed-hypothesis 8-point RANSAC with
locally-optimized refits, cheirality pose recovery and a Gauss-Newton
polish on the essential manifold — batched over pairs.

Port of gtsfm_tpu/frontend/verifiers/essential.py: MSAC (the default),
LMedS or inlier-count scoring on a preemptive subset, LO refits, two
polish rounds, the pixel-space wrapper and the relative pose's
information spectrum (the two-view indeterminacy check). Where the
reference vmaps one pair, every function here takes a leading pair axis:
x1, x2 (P, K, 2), mask (P, K).

Hypotheses are solved as the reference's CPU branch does on every device:
the einsum normal matrix and the unstacked pinned-nullvector elimination
(``nullvec_pinned_scalarized``). The minimal sets are drawn from a
counter-based stream keyed by each pair's global id
(``numerics.counter_uniform``), or passed in as ``sample_idx`` (the tests
replay the reference's ``jax.random`` draws that way).

Conventions: x2^T E x1 = 0 for normalized homogeneous x; the recovered pose
is i2Ti1 = (i2Ri1, i2Ui1) with x2 = R x1 + t and unit t.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gtsfm_tpu_torch.geometry import so3
from gtsfm_tpu_torch.utils import numerics
from gtsfm_tpu_torch.utils.numerics import (
    counter_uniform,
    jacobian_fwd,
    jacobian_fwd_stacked,
    mm,
    nullvec_pinned_scalarized,
    precise,
)
from gtsfm_tpu_torch.utils.tracing import span

# stage tags of the counter-based random streams
TAG_POOL_TIE = 1
TAG_SAMPLE = 2


class RansacOptions(NamedTuple):
    num_hypotheses: int = 512
    lo_rounds: int = 3
    min_inliers: int = 8
    polish_iterations: int = 8
    polish_huber: float = 2.0
    # "msac": truncated-residual gain; "inliers": count voting; "lmeds":
    # least median of squares. LMedS votes by the median but, as "msac",
    # keeps the MSAC gain for LO and the dual-start pick.
    scoring: str = "msac"
    score_subset: int = 256


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _normal_matrix(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Row-normalized weighted 8-point normal matrix (..., 9, 9)."""
    p1, p2 = _homog(x1), _homog(x2)
    A = (p2[..., :, :, None] * p1[..., :, None, :]).flatten(-2)  # (..., K, 9)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)
    return torch.einsum("...ki,...kj->...ij", A * w[..., None], A)


def _project_essential(E: torch.Tensor) -> torch.Tensor:
    """Singular values (1, 1, 0)."""
    U, _, Vt = numerics.svd(E)
    S = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return mm(U * S, Vt)


def _eight_point(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact weighted 8-point (eigh) with manifold projection."""
    _, vecs = numerics.eigh(_normal_matrix(x1, x2, w))
    return _project_essential(vecs[..., :, 0].unflatten(-1, (3, 3)))


def _sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Sampson error (..., K) of E (..., 3, 3) on x (..., K, 2); huge where
    the (scale-normalized) model gives no constraint."""
    E = E / torch.clamp(torch.linalg.vector_norm(E, dim=(-2, -1), keepdim=True), min=1e-20)
    p1, p2 = _homog(x1), _homog(x2)
    Ex1 = torch.einsum("...ij,...kj->...ki", E, p1)
    Etx2 = torch.einsum("...ji,...kj->...ki", E, p2)
    num = torch.sum(p2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return torch.where(den > 1e-9, num / torch.clamp(den, min=1e-12), torch.full_like(num, 1e9))


def _triangulate_midpoint(R, t, x1, x2):
    """Two-ray least-squares depths (z1, z2) (..., K); camera 1 at the
    origin, x2 = R x1 + t."""
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


def recover_pose_from_essential(E, x1, x2, w):
    """The four (R, t) decompositions of E (..., 3, 3), picked by a
    weighted cheirality vote. Returns (i2Ri1 (..., 3, 3), i2Ui1 (..., 3))."""
    U, _, Vt = numerics.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    Ra = mm(mm(U, W), Vt)
    Rb = mm(mm(U, W.T), Vt)
    t = U[..., :, 2]
    cands_R = torch.stack([Ra, Ra, Rb, Rb], dim=-3)  # (..., 4, 3, 3)
    cands_t = torch.stack([t, -t, t, -t], dim=-2)  # (..., 4, 3)
    z1, z2 = _triangulate_midpoint(cands_R, cands_t, x1[..., None, :, :], x2[..., None, :, :])
    votes = torch.sum(w[..., None, :] * (z1 > 0) * (z2 > 0), dim=-1)  # (..., 4)
    best = torch.argmax(votes, dim=-1)
    R_best = torch.gather(cands_R, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    t_best = torch.gather(cands_t, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    t_best = t_best / torch.clamp(torch.linalg.vector_norm(t_best, dim=-1, keepdim=True), min=1e-12)
    return R_best, t_best


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 2): two unit vectors orthogonal to t."""
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    e2 = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    a = torch.where((t[..., 0].abs() < 0.9)[..., None], e1, e2)
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1, keepdim=True), min=1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def _perturb(params, R, t):
    """R exp(w_r), normalize(t + B dt) for params (..., 5) = (w_r, dt)."""
    Rn = mm(R, so3.expmap(params[..., :3]))
    tn = t + torch.einsum("...ij,...j->...i", _tangent_basis(t), params[..., 3:])
    tn = tn / torch.clamp(torch.linalg.vector_norm(tn, dim=-1, keepdim=True), min=1e-12)
    return Rn, tn


def _essential_residual(params, R, t, x1, x2):
    """First-order geometric error (..., K) at the perturbed pose."""
    Rn, tn = _perturb(params, R, t)
    err2 = _sampson_error(mm(so3.hat(tn), Rn), x1, x2)
    return torch.sqrt(torch.clamp(err2, min=1e-18))


@precise()
def essential_information_spectrum(x1, x2, w, R, t):
    """(min, max) eigenvalue (P,) of the 5-dof relative-pose Gauss-Newton
    information J^T W J of the Sampson residual at (R, t): a near-zero
    minimum against the maximum means the matches do not determine the
    pose (the two-view indeterminacy check). x (P, K, 2), w (P, K),
    R (P, 3, 3), t (P, 3). The Jacobian is one stacked jvp; a residual
    below the 1e-18 floor has zero derivative, as in the reference."""
    z5 = torch.zeros(x1.shape[:-2] + (5,), dtype=x1.dtype, device=x1.device)
    J = jacobian_fwd_stacked(lambda p: _essential_residual(p, R, t, x1, x2), z5)  # (P, K, 5)
    H = torch.einsum("pki,pkj->pij", J * w[..., None], J)
    eigs = torch.linalg.eigvalsh(H)
    return eigs[..., 0], eigs[..., -1]


def _refine_essential(x1, x2, w, R0, t0, iters: int, huber: float, thresh):
    """Huber-weighted Gauss-Newton/LM on the 5-dof essential manifold,
    batched over pairs: x (P, K, 2), w (P, K), R0 (P, 3, 3), t0 (P, 3),
    thresh (P,)."""
    P = x1.shape[0]
    dev, dt = x1.device, x1.dtype
    eye5 = torch.eye(5, dtype=dt, device=dev)
    k = (huber * thresh)[:, None]
    z5 = torch.zeros((P, 5), dtype=dt, device=dev)
    R, t = R0, t0
    lam = torch.full((P,), 1e-3, dtype=dt, device=dev)

    def cost(params):
        rr = _essential_residual(params, R, t, x1, x2)
        rho = torch.where(rr <= k, 0.5 * rr**2, k * (rr - 0.5 * k))
        return torch.sum(w * rho, dim=-1)

    for _ in range(iters):
        r = _essential_residual(z5, R, t, x1, x2)  # (P, K)
        J = jacobian_fwd(lambda p: _essential_residual(p, R, t, x1, x2), z5)  # (P, K, 5)
        w_rob = torch.clamp(k / torch.clamp(r, min=1e-12), max=1.0)
        Jw = J * (w * w_rob)[..., None]
        H = torch.einsum("pki,pkj->pij", Jw, J) + lam[:, None, None] * eye5 * 10.0 + 1e-9 * eye5
        g = torch.einsum("pki,pk->pi", Jw, r)
        delta = torch.linalg.solve_ex(H, -g[..., None])[0][..., 0]
        accept = (cost(delta) < cost(z5))[:, None]
        R, t = _perturb(torch.where(accept, delta, z5), R, t)
        lam = torch.clamp(torch.where(accept[:, 0], lam * 0.5, lam * 4.0), 1e-10, 1e4)
    return R, t


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last dimension: the mean of the two middle
    order statistics when the count is even (``torch.median`` returns the
    lower one)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def hypothesis_votes(E_hyps, x1, x2, mask, thresh2, opts: RansacOptions = RansacOptions()) -> torch.Tensor:
    """Votes (P, H) of hypotheses E (P, H, 3, 3) under ``opts.scoring``
    (larger is better) on the preemptive subset of ``opts.score_subset``
    points, a deterministic spread over each pair's valid set; thresh2
    (P,) is the squared Sampson threshold."""
    P, K = mask.shape
    if 0 < opts.score_subset < K:
        order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)  # valid first
        S = opts.score_subset
        pos = torch.arange(S, device=mask.device)[None] * torch.clamp(mask.sum(-1), min=1)[:, None] // S
        sub = torch.gather(order, 1, pos)
        x1 = torch.gather(x1, 1, sub[..., None].expand(P, S, 2))
        x2 = torch.gather(x2, 1, sub[..., None].expand(P, S, 2))
        mask = torch.gather(mask, 1, sub)
    err_h = _sampson_error(E_hyps, x1[:, None], x2[:, None])  # (P, H, S)
    ms = mask[:, None]
    if opts.scoring == "lmeds":
        return -_median(torch.where(ms, err_h, torch.full_like(err_h, float("inf"))))
    if opts.scoring == "msac":
        gain = torch.clamp(thresh2[:, None, None] - err_h, min=0.0)
        return torch.sum(torch.where(ms, gain, torch.zeros_like(gain)), -1)
    return (ms & (err_h < thresh2[:, None, None])).sum(-1).to(x1.dtype)


def sample_minimal_sets(mask, sample_weights, num_hypotheses: int, seed: int, stream_ids):
    """PROSAC-style weighted 8-subsets (P, H, 8), as the reference draws
    them: a quality-ranked pool (random tie-break), then top-8 of
    u^(1/w) per hypothesis. The draws come from counter streams keyed by
    ``stream_ids`` (the pairs' global ids)."""
    P, K = mask.shape
    maskf = mask.to(torch.float32)
    sw = maskf if sample_weights is None else torch.clamp(sample_weights, min=1e-6) * maskf
    pool = min(K, max(256, 4 * 8))
    tie = counter_uniform(seed, TAG_POOL_TIE, stream_ids, (K,), 0.5, 1.0)
    pool_idx = torch.topk(torch.where(mask, sw * tie, torch.full_like(sw, -1.0)), pool, dim=-1).indices
    sw_pool = torch.gather(sw, 1, pool_idx)
    mask_pool = torch.gather(mask, 1, pool_idx)
    u = counter_uniform(seed, TAG_SAMPLE, stream_ids, (num_hypotheses, pool), 1e-12, 1.0)
    keys_w = torch.where(mask_pool[:, None, :], u ** (1.0 / sw_pool[:, None, :]), torch.full_like(u, -1.0))
    top8 = torch.topk(keys_w, 8, dim=-1).indices  # (P, H, 8)
    return torch.gather(pool_idx[:, None, :].expand(P, num_hypotheses, pool), 2, top8)


def ransac_essential(
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    threshold: torch.Tensor,
    opts: RansacOptions = RansacOptions(),
    sample_weights: torch.Tensor | None = None,
    sample_idx: torch.Tensor | None = None,
    seed: int = 0,
    stream_ids: torch.Tensor | None = None,
):
    """Fixed-hypothesis essential RANSAC on normalized correspondences.

    x1, x2 (P, K, 2); mask (P, K); threshold (P,) Sampson threshold in
    normalized units. ``sample_idx`` (P, H, 8) replaces the random draws;
    otherwise they come from ``sample_minimal_sets`` with ``stream_ids``
    (default 0..P-1). Returns a dict of batched i2Ri1, i2Ui1, E, inliers,
    num_inliers, success.
    """
    P, K = mask.shape
    dev = x1.device
    maskf = mask.to(x1.dtype)
    n_valid = mask.sum(-1)
    thresh2 = torch.as_tensor(threshold, dtype=x1.dtype, device=dev) ** 2  # (P,)
    if sample_idx is None:
        if stream_ids is None:
            stream_ids = torch.arange(P, device=dev)
        sample_idx = sample_minimal_sets(mask, sample_weights, opts.num_hypotheses, seed, stream_ids)
    H = sample_idx.shape[1]

    with span("ransac.hypotheses"):
        p1h, p2h = _homog(x1), _homog(x2)
        A_rows = (p2h[..., :, None] * p1h[..., None, :]).flatten(-2)  # (P, K, 9)
        A_rows = A_rows / torch.clamp(torch.linalg.vector_norm(A_rows, dim=-1, keepdim=True), min=1e-12)
        A_rows = A_rows * maskf[..., None]
        A8 = torch.gather(A_rows, 1, sample_idx.reshape(P, H * 8, 1).expand(P, H * 8, 9).to(torch.int64))
        A8 = A8.reshape(P, H, 8, 9)
        AtA_h = torch.einsum("phkr,phks->phrs", A8, A8)
        E_hyps = nullvec_pinned_scalarized(AtA_h).reshape(P, H, 3, 3)

    with span("ransac.score"):
        votes = hypothesis_votes(E_hyps, x1, x2, mask, thresh2, opts)
        best = torch.argmax(votes, dim=-1)  # first maximum, as jnp.argmax
        E_best = torch.gather(E_hyps, 1, best[:, None, None, None].expand(P, 1, 3, 3))[:, 0]

    # full-set model quality of LO and the dual-start pick: the inlier
    # count under "inliers", the MSAC gain otherwise
    zero = torch.zeros((), dtype=x1.dtype, device=dev)
    if opts.scoring == "inliers":
        def quality(err):
            return (mask & (err < thresh2[:, None])).sum(-1).to(x1.dtype)
    else:
        def quality(err):
            return torch.sum(torch.where(mask, torch.clamp(thresh2[:, None] - err, min=0.0), zero), dim=-1)

    def lo_round(E, mult):
        err = _sampson_error(E, x1, x2)
        inl = mask & (err < thresh2[:, None] * mult**2)
        w_soft = inl.to(x1.dtype) / (1.0 + err / torch.clamp(thresh2[:, None], min=1e-20))
        E_new = _eight_point(x1, x2, w_soft)
        better = quality(_sampson_error(E_new, x1, x2)) >= quality(err)
        return torch.where(better[:, None, None], E_new, E)

    if opts.lo_rounds > 1:
        mults = torch.linspace(2.0, 1.0, opts.lo_rounds, dtype=torch.float32).tolist()
    else:
        mults = [1.0] * opts.lo_rounds
    with span("ransac.lo"):
        # dual-start LO: the raw hypothesis and its manifold projection
        E_a = E_best
        E_b = _project_essential(E_best)
        for m in mults:
            E_a = lo_round(E_a, m)
        for m in mults:
            E_b = lo_round(E_b, m)
        q_a = quality(_sampson_error(E_a, x1, x2))
        q_b = quality(_sampson_error(E_b, x1, x2))
        E_final = torch.where((q_a >= q_b)[:, None, None], E_a, E_b)
        inliers = mask & (_sampson_error(E_final, x1, x2) < thresh2[:, None])

    with span("ransac.pose"):
        R0, t0 = recover_pose_from_essential(E_final, x1, x2, inliers.to(x1.dtype))
    if opts.polish_iterations > 0:
        with span("ransac.polish"):
            thresh = torch.sqrt(thresh2)
            E_pre, R_pre, t_pre, inl_pre = E_final, R0, t0, inliers
            q_pre = quality(_sampson_error(E_pre, x1, x2))
            for _ in range(2):
                R0, t0 = _refine_essential(
                    x1, x2, inliers.to(x1.dtype), R0, t0,
                    opts.polish_iterations, opts.polish_huber, thresh,
                )
                E_final = mm(so3.hat(t0), R0)
                inliers = mask & (_sampson_error(E_final, x1, x2) < thresh2[:, None])
            R0, t0 = recover_pose_from_essential(E_final, x1, x2, inliers.to(x1.dtype))
            worse = quality(_sampson_error(E_final, x1, x2)) < q_pre
            E_final = torch.where(worse[:, None, None], E_pre, E_final)
            R0 = torch.where(worse[:, None, None], R_pre, R0)
            t0 = torch.where(worse[:, None], t_pre, t0)
            inliers = torch.where(worse[:, None], inl_pre, inliers)
    num_inliers = inliers.sum(-1)
    return {
        "i2Ri1": R0,
        "i2Ui1": t0,
        "E": E_final,
        "inliers": inliers,
        "num_inliers": num_inliers,
        "success": (num_inliers >= opts.min_inliers) & (n_valid >= 8),
    }


@precise()
def ransac_essential_pixels(uv1, uv2, mask, cal1, cal2, threshold_px: float = 4.0,
                            opts: RansacOptions = RansacOptions(), **kwargs):
    """``ransac_essential`` on pixel correspondences uv (P, K, 2): each
    pair's calibrations (batched (P,)) normalize them, and the pixel
    threshold becomes a normalized one through the pair's mean focal.
    Keyword arguments (``sample_idx``, ``seed``, ``stream_ids``,
    ``sample_weights``) pass through."""
    x1 = cal1.map(lambda a: a[:, None]).calibrate(uv1)
    x2 = cal2.map(lambda a: a[:, None]).calibrate(uv2)
    thresh = threshold_px / torch.clamp(0.5 * (cal1.fx + cal2.fx), min=1e-6)
    return ransac_essential(x1, x2, mask, thresh, opts=opts, **kwargs)
