"""Bundle adjustment: Levenberg-Marquardt with a Schur complement.

Port of gtsfm_tpu/bundle/ba.py: Huber IRLS or graduated non-convexity
(Geman-McClure) weights, frozen cameras or the Karcher gauge, intrinsics
(per camera or one shared calibration), relative (rig) and absolute pose
priors, a calibration prior and a first-point prior, for any calibration
model. The fixed-count LM loop accepts or rejects with ``torch.where`` and
never reads a value back to the host. Three layout names, as in the
reference:

- ``dense``: ``densify_problem`` re-lays measurements track-major to
  (T, L); ``_dense_linearize`` gives residuals and closed-form Jacobians
  of the right retraction (Cal3Bundler and Cal3_S2); ``_schur_solve_dense``
  forms the reduced camera system S = Hcc - W Hpp^-1 W^T and solves it
  exactly each step.
- ``entry`` and ``scatter``: one solver, ``_schur_solve``. Per-measurement
  Jacobians come from batched ``jvp`` (any calibration); PCG with a fixed
  ``cg_iterations`` applies the Schur complement matrix-free; every camera
  and track reduction is a ``numerics.SegmentSum`` (sorted keys, summed in
  a fixed order). The reference lays this same math out two ways for the
  TPU's lanes (``entry``: lane cumsums over track-sorted measurements and
  one-hot (N, M) camera matmuls; ``scatter``: segment sums). On a GPU both
  are the same gathers and segmented sums, so both names run this one
  solver; the tests hold it against each reference layout.

``BundleAdjustment.run`` falls back from ``dense`` to ``entry`` for a model
without closed-form Jacobians and for a track longer than the dense cap
(128), as the reference does; ``run_compact`` leaves ``dense`` above 1024
live cameras, or above 96 on the CPU. ``layout_counts`` counts the layout
each solve actually ran.

``BundleAdjustment(options, mesh)`` on a (data, model) mesh of ranks
(parallel/sharding.py) pads the measurements to a multiple of ``data`` with
rows of weight 0, keeps this rank's consecutive share of them, cameras and
points whole, and runs ``scatter`` whatever ``options.layout`` says, as the
reference does: every measurement -> camera or track sum (the normal
equations' blocks, each PCG product, the back-substitution) and the cost's
measurement sum are ``all_reduce``d over ``data``, so every rank takes the
same step. There is no float atomic anywhere: a fixed world gives
bit-identical repeat runs.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.geometry import SE3, PinholeCamera, so3
from gtsfm_tpu_torch.parallel.sharding import ReducedSum, all_reduce_sum, shard_ba_problem
from gtsfm_tpu_torch.utils.numerics import SegmentSum, TensorStruct, jacobian_fwd_stacked, precise, where_struct

# solves per layout actually run (after the fallbacks), like
# dog_sift.calls_by_device; tests and chip_smoke.py reset and read it
layout_counts: collections.Counter = collections.Counter()


class BAOptions(NamedTuple):
    max_iterations: int = 30
    cg_iterations: int = 40
    robust_huber_px: float = 1.345  # Huber threshold in pixels (0 = disabled)
    # "huber" = IRLS Huber; "gnc_gm" = graduated non-convexity with the
    # Geman-McClure loss
    robust_mode: str = "huber"
    gnc_mu_init: float = 64.0
    gnc_gamma: float = 0.5  # mu <- mu * gamma each outer iteration, floor 1
    # after a GNC solve, drop measurements whose final robust weight falls
    # below this (0 = off), then tracks shorter than min_track_length
    gnc_weight_threshold: float = 0.0
    min_track_length: int = 2
    optimize_intrinsics: bool = False
    # one calibration shared by every camera (an exact Schur variable)
    shared_intrinsics: bool = False
    # absolute pose priors (the weights come with problem_from_sfm_data)
    pose_prior_weight: float = 0.0
    # soft prior pulling optimized intrinsics toward their initial values
    cal_prior_weight: float = 0.0
    # anchor the best-constrained point at its initial value (scale gauge)
    first_point_prior_weight: float = 0.0
    # "fixed" = freeze fixed_cam cameras; "karcher" = also anchor the mean
    # rotation of the free cameras at its initial value
    gauge: str = "fixed"
    karcher_weight: float = 1e4
    init_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    lambda_down: float = 0.5
    lambda_up: float = 4.0
    # measurement noise sigma in pixels (scales the cost)
    measurement_sigma_px: float = 1.0
    # inner-solve layout: "dense", "entry" or "scatter" (module docstring)
    layout: str = "entry"
    # measurements-per-track padding of the "dense" layout; 0 = the next
    # power of two >= the longest track
    dense_track_len: int = 0


@dataclasses.dataclass(frozen=True)
class BAProblem(TensorStruct):
    poses: SE3  # [N]
    cal: object  # batched calibration [N] (keeps the non-optimized fields)
    cal_params: torch.Tensor  # [N, dc] the optimizable calibration vector
    points: torch.Tensor  # [T, 3]
    meas_cam: torch.Tensor  # i64 [M]
    meas_track: torch.Tensor  # i64 [M]
    meas_uv: torch.Tensor  # [M, 2]
    meas_w: torch.Tensor  # [M] base weights (0 = padding/invalid)
    fixed_cam: torch.Tensor  # bool [N]
    # relative-pose (between) priors, e.g. camera rigs: for edge f the
    # residual is w * Log(meas_bTa^-1 * (wTb^-1 wTa))
    rel_edges: torch.Tensor  # i64 [F, 2] (a, b); F >= 1 (padded, weight 0)
    rel_meas: SE3  # [F] measured bTa
    rel_weight: torch.Tensor  # [F]
    # absolute pose priors: residual w * Log(prior^-1 wTi)
    prior_pose: SE3  # [N]
    prior_weight: torch.Tensor  # [N] (0 = no prior)


def problem_from_sfm_data(data: SfmData, fixed_cam=None, rel_edges=None, rel_meas: SE3 | None = None,
                          rel_weight=None, prior_pose: SE3 | None = None, prior_weight=None) -> BAProblem:
    n = data.max_cameras
    dev = data.points.device
    if fixed_cam is None:
        fixed_cam = torch.zeros(n, dtype=torch.bool, device=dev)
    base_w = data.meas_mask & data.track_mask[data.meas_track] & data.pose_mask[data.meas_cam]
    if rel_edges is None:
        rel_edges = torch.zeros((1, 2), dtype=torch.int64, device=dev)
        rel_meas = SE3.identity((1,), device=dev)
        rel_weight = torch.zeros(1, device=dev)
    if prior_pose is None:
        prior_pose = data.poses
        prior_weight = torch.zeros(n, device=dev)
    return BAProblem(
        poses=data.poses, cal=data.cal, cal_params=data.cal.to_params(), points=data.points,
        meas_cam=data.meas_cam, meas_track=data.meas_track, meas_uv=data.meas_uv,
        meas_w=base_w.to(torch.float32), fixed_cam=torch.as_tensor(fixed_cam, device=dev),
        rel_edges=torch.as_tensor(rel_edges, dtype=torch.int64, device=dev), rel_meas=rel_meas,
        rel_weight=torch.as_tensor(rel_weight, dtype=torch.float32, device=dev),
        prior_pose=prior_pose, prior_weight=torch.as_tensor(prior_weight, dtype=torch.float32, device=dev),
    )


def problem_to_sfm_data(prob: BAProblem, data: SfmData) -> SfmData:
    return data.replace(poses=prob.poses, cal=prob.cal.with_params(prob.cal_params), points=prob.points)


def _cameras_at(prob: BAProblem, idx: torch.Tensor) -> tuple:
    """Poses and calibrations (with the current parameters) gathered at
    camera indices ``idx``."""
    return (prob.poses.map(lambda a: a[idx]),
            prob.cal.map(lambda a: a[idx]).with_params(prob.cal_params[idx]))


def _residuals(prob: BAProblem) -> tuple:
    """Per-measurement residual (M, 2) and depth (M,)."""
    pose, cal = _cameras_at(prob, prob.meas_cam)
    uv_hat, depth = PinholeCamera(pose=pose, cal=cal).project(prob.points[prob.meas_track])
    return uv_hat - prob.meas_uv, depth


def _robust_weights(r, depth, base_w, opts: BAOptions, mu):
    """IRLS robust weights on the 2D residual norm; behind-camera => 0."""
    nrm = torch.linalg.vector_norm(r, dim=-1)
    return base_w * _robust_w_from_nrm(nrm, opts, mu) * (depth > 1e-6) / (opts.measurement_sigma_px**2)


def _robust_w_from_nrm(nrm, opts: BAOptions, mu):
    """huber: min(1, k/|r|); gnc_gm: (mu c^2 / (r^2 + mu c^2))^2, mu
    annealed toward 1."""
    k = opts.robust_huber_px
    if opts.robust_mode == "gnc_gm" and k > 0:
        c2 = k * k
        return (mu * c2 / (nrm**2 + mu * c2)) ** 2
    if k > 0:
        return torch.clamp(k / torch.clamp(nrm, min=1e-12), max=1.0)
    return torch.ones_like(nrm)


def _mat2(a, b, c, d) -> torch.Tensor:
    """(..., 2, 2) from its four entries."""
    return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -2)


def _uncalibrate_jac(cal, q: torch.Tensor, want_cal: bool) -> tuple:
    """Closed-form Jacobians of ``cal.uncalibrate`` at intrinsic coords q
    (..., 2): duv/dq (..., 2, 2) and, with ``want_cal``, duv/dparams
    (..., 2, dof) in ``to_params`` order (else None)."""
    x, y = q[..., 0], q[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    name = type(cal).__name__
    if name == "Cal3Bundler":
        f, k1, k2 = cal.f, cal.k1, cal.k2
        r2 = x * x + y * y
        g = 1.0 + k1 * r2 + k2 * r2 * r2
        gp2 = 2.0 * (k1 + 2.0 * k2 * r2)  # 2 g'(r2)
        D = f[..., None, None] * _mat2(g + gp2 * x * x, gp2 * x * y, gp2 * x * y, g + gp2 * y * y)
        Jcal = torch.stack([g[..., None] * q, (f * r2)[..., None] * q, (f * r2 * r2)[..., None] * q], -1)
        return D, Jcal if want_cal else None
    K2 = _mat2(cal.fx, cal.s, zero, cal.fy)
    if name == "Cal3_S2":
        d, Dd, Jk = q, None, []
    elif name == "Cal3DS2":
        k1, k2, p1, p2 = cal.k1, cal.k2, cal.p1, cal.p2
        r2 = x * x + y * y
        g = 1.0 + k1 * r2 + k2 * r2 * r2
        gp2 = 2.0 * (k1 + 2.0 * k2 * r2)
        d = cal._distort(q)
        off = gp2 * x * y + 2.0 * p1 * x + 2.0 * p2 * y
        Dd = _mat2(g + gp2 * x * x + 2.0 * p1 * y + 6.0 * p2 * x, off, off,
                   g + gp2 * y * y + 6.0 * p1 * y + 2.0 * p2 * x)
        Jk = [r2[..., None] * q, (r2 * r2)[..., None] * q,
              torch.stack([2.0 * x * y, r2 + 2.0 * y * y], -1), torch.stack([r2 + 2.0 * x * x, 2.0 * x * y], -1)]
    elif name == "Cal3Fisheye":
        # d = s(r) q with s = theta_d(atan r) / r; at r < 1e-9 the model
        # takes s = 1 (a constant: no tangent), as does the reference
        r2 = x * x + y * y
        small = r2 < 1e-18
        r = torch.sqrt(torch.where(small, one, r2))
        theta = torch.atan(r)
        td = cal._theta_d(theta)
        sc = torch.where(small, one, td / r)
        ds_r = torch.where(small, zero, (cal._dtheta_d(theta) * r / (1.0 + r * r) - td) / (r * r2))  # s'(r) / r
        d = sc[..., None] * q
        Dd = sc[..., None, None] * torch.eye(2, dtype=q.dtype, device=q.device) + ds_r[..., None, None] * (
            q[..., :, None] * q[..., None, :])
        t2 = theta * theta
        Jk = [torch.where(small, zero, theta * t2**i / r)[..., None] * q for i in (1, 2, 3, 4)]
    else:
        raise ValueError(f"unsupported calibration {name}")
    D = K2 if Dd is None else K2 @ Dd
    if not want_cal:
        return D, None
    d0, d1 = d[..., 0], d[..., 1]
    cols = [torch.stack([d0, zero], -1), torch.stack([zero, d1], -1), torch.stack([d1, zero], -1),
            torch.stack([one, zero], -1), torch.stack([zero, one], -1)]
    cols += [(K2 @ j[..., None])[..., 0] for j in Jk]
    return D, torch.stack(cols, -1)


def _jacobians(prob: BAProblem, optimize_intrinsics: bool) -> tuple:
    """Per-measurement Jacobians of the residual at the current state, in
    closed form for the right retraction: with p = R^T (X - t),
    dp/dw = hat(p), dp/dv = -I, dp/dX = R^T, times dq/dp of q = p_xy / z
    and the model's duv/dq. Returns J_c (M, 2, 6 [+ dc], the calibration
    columns with ``optimize_intrinsics``) and J_p (M, 2, 3)."""
    pose, cal = _cameras_at(prob, prob.meas_cam)
    p = so3.rotate(pose.R.transpose(-1, -2), prob.points[prob.meas_track] - pose.t)
    z = p[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    q = p[:, :2] / zs[:, None]
    D, Jcal = _uncalibrate_jac(cal, q, optimize_intrinsics)
    inv_z = 1.0 / zs
    zero = torch.zeros_like(inv_z)
    Jq = torch.stack([torch.stack([inv_z, zero, -q[:, 0] * inv_z], -1),
                      torch.stack([zero, inv_z, -q[:, 1] * inv_z], -1)], -2)  # dq/dp (M, 2, 3)
    P = D @ Jq
    J_c = torch.cat([P @ so3.hat(p), -P], dim=-1)
    if optimize_intrinsics:
        J_c = torch.cat([J_c, Jcal], dim=-1)
    return J_c, P @ pose.R.transpose(-1, -2)


def _rel_resid(x, pa: SE3, pb: SE3, pm: SE3) -> torch.Tensor:
    """Between-factor residual at increments x (..., F, 12) = (xa, xb)."""
    rel = pb.retract(x[..., 6:]).inverse().compose(pa.retract(x[..., :6]))
    return pm.inverse().compose(rel).log()


def _abs_resid(x, p: SE3, pp: SE3) -> torch.Tensor:
    return pp.inverse().compose(p.retract(x)).log()


def _pose_prior_terms(prob: BAProblem, d: int, rel_sum: SegmentSum, priors=(True, True)) -> tuple:
    """Gauss-Newton contributions of the relative and absolute pose priors:
    (H_diag [N, d, d], g [N, d], (a_idx, b_idx, Hab [F, 6, 6]) or None), the
    cross term J_a^T W J_b kept for the matvec. ``priors`` (relative,
    absolute) leaves out a kind whose weights are all 0: its terms would be
    exact zeros."""
    n = prob.fixed_cam.shape[0]
    H6 = prob.points.new_zeros((n, 6, 6))
    g6 = prob.points.new_zeros((n, 6))
    rel = None
    if priors[0]:
        H6, g6, rel = _rel_prior_terms(prob, rel_sum)
    if priors[1]:
        zn = prob.points.new_zeros((n, 6))
        r_abs = _abs_resid(zn, prob.poses, prob.prior_pose)
        J_abs = jacobian_fwd_stacked(lambda x: _abs_resid(x, prob.poses, prob.prior_pose), zn)  # (N, 6, 6)
        wp = prob.prior_weight[:, None, None]
        H6 = H6 + torch.einsum("nri,nrj->nij", J_abs * wp, J_abs)
        g6 = g6 + torch.einsum("nri,nr->ni", J_abs * wp, r_abs)
    # lift the 6-dof blocks into the d-dof camera parameterization
    return torch.nn.functional.pad(H6, (0, d - 6, 0, d - 6)), torch.nn.functional.pad(g6, (0, d - 6)), rel


def _rel_prior_terms(prob: BAProblem, rel_sum: SegmentSum) -> tuple:
    a_idx, b_idx = prob.rel_edges[:, 0], prob.rel_edges[:, 1]
    pa, pb = prob.poses.map(lambda x: x[a_idx]), prob.poses.map(lambda x: x[b_idx])
    zf = prob.points.new_zeros((a_idx.shape[0], 12))
    r_rel = _rel_resid(zf, pa, pb, prob.rel_meas)  # (F, 6)
    J = jacobian_fwd_stacked(lambda x: _rel_resid(x, pa, pb, prob.rel_meas), zf)  # (F, 6, 12)
    Ja, Jb = J[..., :6], J[..., 6:]
    wf = prob.rel_weight[:, None, None]
    Haa = torch.einsum("fri,frj->fij", Ja * wf, Ja)
    Hbb = torch.einsum("fri,frj->fij", Jb * wf, Jb)
    Hab = torch.einsum("fri,frj->fij", Ja * wf, Jb)
    ga = torch.einsum("fri,fr->fi", Ja * wf, r_rel)
    gb = torch.einsum("fri,fr->fi", Jb * wf, r_rel)
    return rel_sum(torch.cat([Haa, Hbb])), rel_sum(torch.cat([ga, gb])), (a_idx, b_idx, Hab)


def _prior_cost(prob: BAProblem, priors=(True, True)) -> torch.Tensor:
    c = prob.points.new_zeros(())
    if priors[0]:
        a_idx, b_idx = prob.rel_edges[:, 0], prob.rel_edges[:, 1]
        pa, pb = prob.poses.map(lambda x: x[a_idx]), prob.poses.map(lambda x: x[b_idx])
        r_rel = prob.rel_meas.inverse().compose(pb.inverse().compose(pa)).log()
        c = c + 0.5 * torch.sum(prob.rel_weight * torch.sum(r_rel**2, dim=-1))
    if priors[1]:
        r_abs = prob.prior_pose.inverse().compose(prob.poses).log()
        c = c + 0.5 * torch.sum(prob.prior_weight * torch.sum(r_abs**2, dim=-1))
    return c


def _add_cols(y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y (N, d) with v (N, k) added to its first k columns."""
    k = v.shape[-1]
    return torch.cat([y[:, :k] + v, y[:, k:]], dim=-1)


def _onehot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(n,) 1 at the 0-dim index ``idx``, else 0 (no read-back of idx)."""
    return (torch.arange(n, device=idx.device) == idx).to(dtype)


def _damp(H: torch.Tensor, lam, eye: torch.Tensor) -> torch.Tensor:
    """Marquardt damping lam * (diag + eps I): keeps frozen or empty blocks
    SPD."""
    return H + lam * (H.abs() * eye) + (lam + 1e-8) * eye


def _pcg(op, precond, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Preconditioned conjugate gradients for op(x) = b from x = 0, a fixed
    number of steps."""
    x = torch.zeros_like(b)
    rr = b
    z = precond(rr)
    p = z
    rz = torch.sum(rr * z)
    for _ in range(iters):
        Ap = op(p)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(denom.abs() < 1e-20, torch.full_like(denom, 1e-20), denom)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = precond(rr)
        rz_new = torch.sum(rr * z)
        beta = rz_new / torch.where(rz.abs() < 1e-20, torch.full_like(rz, 1e-20), rz)
        p = z + beta * p
        rz = rz_new
    return x


def _shared_cal_solve(S_apply, b: torch.Tensor, Hcc_d: torch.Tensor, dc: int, iters: int) -> torch.Tensor:
    """PCG on the shared-calibration system: unknowns (N * dp pose | dc
    calibration), the trailing dc columns of every camera one variable;
    preconditioned by the per-camera pose blocks and the pooled calibration
    block."""
    n, d = b.shape
    dp = d - dc

    def expand(xt):
        return torch.cat([xt[: n * dp].reshape(n, dp), xt[n * dp :][None].expand(n, dc)], dim=-1)

    def reduce_(z):
        return torch.cat([z[:, :dp].reshape(-1), torch.sum(z[:, dp:], dim=0)])

    Mp_inv = torch.linalg.inv_ex(Hcc_d[:, :dp, :dp])[0]
    Mc_inv = torch.linalg.inv_ex(torch.sum(Hcc_d[:, dp:, dp:], dim=0))[0]

    def precond(xt):
        xp = xt[: n * dp].reshape(n, dp)
        return torch.cat([torch.einsum("nij,nj->ni", Mp_inv, xp).reshape(-1), Mc_inv @ xt[n * dp :]])

    return expand(_pcg(lambda xt: reduce_(S_apply(expand(xt))), precond, reduce_(b), iters))


def _schur_solve(J_c, J_p, r, w, ix, fixed_cam, lam, cg_iters: int, prior_terms=None,
                 shared_cal_dims: int = 0, point_prior=None, karcher=None) -> tuple:
    """Damped normal equations by the Schur complement and PCG, the layouts
    ``entry`` and ``scatter``. ``ix`` holds the solve's fixed index
    structure (``_Index``). Returns (delta_c [N, d], delta_p [T, 3]).

    shared_cal_dims > 0 solves the shared calibration exactly: the trailing
    dc columns of every camera block are one variable, and PCG runs on
    N * 6 + dc unknowns."""
    d = J_c.shape[-1]
    dc = shared_cal_dims
    dt = J_c.dtype
    sw = torch.sqrt(w)[:, None, None]
    Jc = J_c * sw
    Jp = J_p * sw
    rw = r * torch.sqrt(w)[:, None]
    # frozen cameras: zero their Jacobian columns (the pose ones only when
    # the calibration is shared: a frozen pose still constrains it)
    free = (~fixed_cam).to(dt)
    free_m = free[ix.meas_cam][:, None, None]
    Jc = torch.cat([Jc[..., : d - dc] * free_m, Jc[..., d - dc :]], dim=-1) if dc else Jc * free_m

    Hcc = ix.cam_sum(torch.einsum("mri,mrj->mij", Jc, Jc))
    Hpp = ix.trk_sum(torch.einsum("mri,mrj->mij", Jp, Jp))
    g_c = ix.cam_sum(torch.einsum("mri,mr->mi", Jc, rw))
    g_p = ix.trk_sum(torch.einsum("mri,mr->mi", Jp, rw))
    freeN = free[:, None]
    rel_coupling = None
    if prior_terms is not None:
        H_prior, g_prior, rel_coupling = prior_terms
        Hcc = Hcc + H_prior * freeN[..., None] * freeN[:, None, :]
        g_c = g_c + g_prior * freeN

    Hcc_d = _damp(Hcc, lam, torch.eye(d, dtype=dt, device=Hcc.device))
    Hpp_d = _damp(Hpp, lam, torch.eye(3, dtype=dt, device=Hpp.device))
    if point_prior is not None:
        pp_idx, pp_w2, pp_res = point_prior
        hot = _onehot(pp_idx, Hpp_d.shape[0], dt)
        Hpp_d = Hpp_d + hot[:, None, None] * (pp_w2 * torch.eye(3, dtype=dt, device=Hpp_d.device))
        g_p = g_p + hot[:, None] * pp_res
    Hpp_inv = _inv3_lanes(Hpp_d.permute(1, 2, 0)).permute(2, 0, 1)
    W = torch.einsum("mri,mrj->mij", Jc, Jp)  # (M, d, 3)

    n_free = torch.clamp(torch.sum(freeN), min=1.0)
    if karcher is not None:
        # rank-3 coupling of the mean-rotation residual: the Jacobian of
        # camera i's share is R0_i / N (right retraction)
        k_w2, mean_dev, R0g = karcher
        g_c = _add_cols(g_c, (k_w2 / n_free) * torch.einsum("nji,j->ni", R0g, mean_dev) * freeN)

    def S_apply(x):  # x: [N, d]
        y = torch.einsum("nij,nj->ni", Hcc_d, x)
        if karcher is not None:
            mean3 = torch.sum(torch.einsum("nij,nj->ni", R0g, x[:, :3]) * freeN, dim=0) / n_free
            y = _add_cols(y, (k_w2 / n_free) * torch.einsum("nji,j->ni", R0g, mean3) * freeN)
        s = ix.trk_sum(torch.einsum("mij,mi->mj", W, x[ix.meas_cam]))  # sum_track W^T x
        v = torch.einsum("tij,tj->ti", Hpp_inv, s)
        y = y - ix.cam_sum(torch.einsum("mij,mj->mi", W, v[ix.meas_track]))
        if rel_coupling is not None:
            # off-diagonal camera-camera coupling of the between factors
            a_idx, b_idx, Hab = rel_coupling
            xf = x * freeN
            ya = torch.einsum("fij,fj->fi", Hab, xf[b_idx][:, :6])
            yb = torch.einsum("fji,fj->fi", Hab, xf[a_idx][:, :6])
            y = _add_cols(y, ix.rel_sum(torch.cat([ya, yb])) * freeN)
        return y

    # rhs: -g_c + W Hpp^-1 g_p, reduced onto cameras
    hv = torch.einsum("tij,tj->ti", Hpp_inv, g_p)
    b = -g_c + ix.cam_sum(torch.einsum("mij,mj->mi", W, hv[ix.meas_track]))
    if dc:
        delta_c = _shared_cal_solve(S_apply, b, Hcc_d, dc, cg_iters)
    else:
        M_inv = torch.linalg.inv_ex(Hcc_d)[0]  # block-Jacobi preconditioner
        delta_c = _pcg(S_apply, lambda x: torch.einsum("nij,nj->ni", M_inv, x), b, cg_iters)

    # back-substitute points: delta_p = -Hpp^-1 (g_p + W^T delta_c)
    s = ix.trk_sum(torch.einsum("mij,mi->mj", W, delta_c[ix.meas_cam]))
    return delta_c, -torch.einsum("tij,tj->ti", Hpp_inv, g_p + s)


def _inv3_lanes(H: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (3, 3, T) blocks."""
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e, f = H[1, 0], H[1, 1], H[1, 2]
    g, h, i = H[2, 0], H[2, 1], H[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    Hc = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    return torch.stack([torch.stack([A, B, C]), torch.stack([D, E, F]), torch.stack([G, Hc, I])]) * inv_det


def densify_problem(prob: BAProblem, L: int = 0) -> tuple:
    """Re-layout measurements track-major, padded to (T, L) and flattened
    (host numpy, once per solve). Row t*L+l holds the l-th measurement of
    track t; padding rows point at their track with camera 0 and weight 0.
    L = 0 takes the next power of two >= the longest track. Raises
    ValueError for a track longer than L or L above 128: such problems
    belong to the iterative layouts."""
    dev = prob.points.device
    trk = prob.meas_track.cpu().numpy()
    cam = prob.meas_cam.cpu().numpy()
    uv = prob.meas_uv.cpu().numpy()
    w = prob.meas_w.cpu().numpy()
    T = prob.points.shape[0]
    counts = np.bincount(trk[w > 0], minlength=T)
    max_len = int(counts.max()) if counts.size else 1
    if L <= 0:
        L = 1 << max(0, int(np.ceil(np.log2(max(max_len, 2)))))
    if max_len > L or L > 128:
        raise ValueError(f"track length {max_len} exceeds dense layout L={L}")
    new_cam = np.zeros(T * L, np.int64)
    new_trk = np.repeat(np.arange(T, dtype=np.int64), L)
    new_uv = np.zeros((T * L, 2), np.float32)
    new_w = np.zeros(T * L, np.float32)
    valid = np.flatnonzero(w > 0)
    order = valid[np.argsort(trk[valid], kind="stable")]
    if len(order):
        t_sorted = trk[order]
        starts = np.r_[0, np.flatnonzero(np.diff(t_sorted)) + 1]
        lens = np.diff(np.r_[starts, len(order)])
        slot = np.arange(len(order)) - np.repeat(starts, lens)
        dst = t_sorted.astype(np.int64) * L + slot
        new_cam[dst] = cam[order]
        new_uv[dst] = uv[order]
        new_w[dst] = w[order]
    return prob.replace(
        meas_cam=torch.as_tensor(new_cam, device=dev),
        meas_track=torch.as_tensor(new_trk, device=dev),
        meas_uv=torch.as_tensor(new_uv, device=dev),
        meas_w=torch.as_tensor(new_w, device=dev),
    ), L


# models with closed-form Jacobians in the dense layout
_DENSE_CALS = ("Cal3Bundler", "Cal3_S2")


def _dense_linearize(prob: BAProblem, L: int, optimize_intrinsics: bool, want_jac: bool = True):
    """Residuals r (2, L, T), depth (L, T) and, with ``want_jac``, the
    camera Jacobian Jc (2, d, L, T) and point Jacobian Jp (2, 3, L, T) in
    the track-major layout (track axis minor), closed form: with
    p = R^T (X - t), dp/dw = hat(p), dp/dv = -I, dp/dX = R^T."""
    T = prob.points.shape[0]
    cname = type(prob.cal).__name__
    cam_lt = prob.meas_cam.reshape(T, L).T  # (L, T)
    Rg = prob.poses.R[cam_lt].permute(2, 3, 0, 1)  # (3, 3, L, T)
    tg = prob.poses.t[cam_lt].permute(2, 0, 1)  # (3, L, T)
    calg = prob.cal_params[cam_lt].permute(2, 0, 1)  # (dc, L, T)
    uv_e = prob.meas_uv.reshape(T, L, 2).permute(2, 1, 0)  # (2, L, T)

    dX = prob.points.T[:, None, :] - tg
    p_cam = torch.einsum("jilt,jlt->ilt", Rg, dX)  # R^T (X - t)
    z = p_cam[2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    q = p_cam[:2] / zs[None]
    if cname == "Cal3Bundler":
        f, k1, k2 = calg[0], calg[1], calg[2]
        cg = torch.stack([prob.cal.u0, prob.cal.v0], dim=-1)[cam_lt].permute(2, 0, 1)
        r2 = q[0] * q[0] + q[1] * q[1]
        g = 1.0 + k1 * r2 + k2 * r2 * r2
        uv_hat = (f * g)[None] * q + cg
    elif cname == "Cal3_S2":
        fx, fy, s, u0, v0 = calg[0], calg[1], calg[2], calg[3], calg[4]
        uv_hat = torch.stack([fx * q[0] + s * q[1] + u0, fy * q[1] + v0])
    else:  # guarded by BundleAdjustment.run's fallback
        raise ValueError(f"dense layout: unsupported calibration {cname}")
    r = uv_hat - uv_e
    if not want_jac:
        return r, z, None, None

    # D = duv/dq (2, 2, L, T)
    if cname == "Cal3Bundler":
        gp2 = 2.0 * (k1 + 2.0 * k2 * r2)  # 2 g'(r2)
        D00 = f * (g + gp2 * q[0] * q[0])
        D01 = f * gp2 * q[0] * q[1]
        D11 = f * (g + gp2 * q[1] * q[1])
        D = torch.stack([torch.stack([D00, D01]), torch.stack([D01, D11])])
    else:
        D = torch.stack([torch.stack([fx, s]), torch.stack([torch.zeros_like(fx), fy])])
    inv_z = 1.0 / zs
    zero = torch.zeros_like(inv_z)
    Jq = torch.stack([
        torch.stack([inv_z, zero, -q[0] * inv_z]),
        torch.stack([zero, inv_z, -q[1] * inv_z]),
    ])  # dq/dp (2, 3, L, T)
    P = torch.einsum("ablt,bclt->aclt", D, Jq)
    x_, y_, z_ = p_cam[0], p_cam[1], p_cam[2]
    hatp = torch.stack([
        torch.stack([zero, -z_, y_]),
        torch.stack([z_, zero, -x_]),
        torch.stack([-y_, x_, zero]),
    ])
    Jc = torch.cat([torch.einsum("ablt,bclt->aclt", P, hatp), -P], dim=1)  # (2, 6, L, T)
    if optimize_intrinsics:
        if cname == "Cal3Bundler":
            Jcal = torch.stack([g[None] * q, (f * r2)[None] * q, (f * r2 * r2)[None] * q], dim=1)
        else:
            one = torch.ones_like(fx)
            Jcal = torch.stack([
                torch.stack([q[0], zero]),
                torch.stack([zero, q[1]]),
                torch.stack([q[1], zero]),
                torch.stack([one, zero]),
                torch.stack([zero, one]),
            ]).transpose(0, 1)  # (2, 5, L, T)
        Jc = torch.cat([Jc, Jcal], dim=1)
    Jp = torch.einsum("ablt,cblt->aclt", P, Rg)  # P @ R^T
    return r, z, Jc, Jp


def _schur_solve_dense(Jc_e, Jp_e, r_e, w_e, A, ix, fixed_cam, lam, prior_terms=None,
                       shared_cal_dims: int = 0, point_prior=None, karcher=None) -> tuple:
    """Form S = blockdiag(Hcc_d) - sum_t W_t Hpp_t^-1 W_t^T from the
    track-major Jacobians (camera one-hot A (N, L, T)), solve the camera
    step exactly, back-substitute the points."""
    n_cam = A.shape[0]
    d = Jc_e.shape[1]
    dc = shared_cal_dims
    dt = Jc_e.dtype
    dev = Jc_e.device
    sw = torch.sqrt(w_e)
    Jp = Jp_e * sw[None, None]
    rw = r_e * sw[None]
    free = (~fixed_cam).to(dt)
    free_m = torch.einsum("nlt,n->lt", A, free)[None, None]
    Jc = Jc_e * sw[None, None]
    Jc = torch.cat([Jc[:, : d - dc] * free_m, Jc[:, d - dc :]], dim=1) if dc else Jc * free_m

    Hpp = torch.einsum("rilt,rjlt->ijt", Jp, Jp)  # (3, 3, T)
    g_p = torch.einsum("rilt,rlt->it", Jp, rw)  # (3, T)
    Wd = torch.einsum("rilt,rjlt->ijlt", Jc, Jp)  # (d, 3, L, T)
    Hcc = torch.einsum("nlt,ijlt->nij", A, torch.einsum("rilt,rjlt->ijlt", Jc, Jc))
    g_c = torch.einsum("nlt,ilt->ni", A, torch.einsum("rilt,rlt->ilt", Jc, rw))
    freeN = free[:, None]
    rel_coupling = None
    if prior_terms is not None:
        H_prior, g_prior, rel_coupling = prior_terms
        Hcc = Hcc + H_prior * freeN[..., None] * freeN[:, None, :]
        g_c = g_c + g_prior * freeN

    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hcc_d = _damp(Hcc, lam, torch.eye(d, dtype=dt, device=dev))
    Hpp_d = _damp(Hpp, lam, eye3[:, :, None])
    if point_prior is not None:
        pp_idx, pp_w2, pp_res = point_prior
        hot = _onehot(pp_idx, Hpp_d.shape[-1], dt)
        Hpp_d = Hpp_d + (pp_w2 * eye3)[:, :, None] * hot
        g_p = g_p + pp_res[:, None] * hot
    Hpp_inv = _inv3_lanes(Hpp_d)

    Y = torch.einsum("nlt,iklt->iknt", A, Wd)  # (d, 3, N, T)
    Y2 = torch.einsum("kqt,jqnt->jknt", Hpp_inv, Y)
    S = -torch.einsum("iknt,jkmt->nimj", Y, Y2)  # (N, d, N, d)
    ar = torch.arange(n_cam, device=dev)
    S[ar, :, ar, :] += Hcc_d
    if rel_coupling is not None:
        # H_ab at (a, b) and H_ab^T at (b, a), for the pairs of free cameras
        a_idx, b_idx, Hab = rel_coupling
        wab = (free[a_idx] * free[b_idx])[:, None, None]
        C = ix.rel_pair_sum(torch.cat([Hab * wab, Hab.transpose(1, 2) * wab]))  # (N, N, 6, 6)
        S[:, :6, :, :6] += C.permute(0, 2, 1, 3)
    if karcher is not None:
        k_w2, mean_dev, R0g = karcher
        n_free = torch.clamp(torch.sum(free), min=1.0)
        g_c = _add_cols(g_c, (k_w2 / n_free) * torch.einsum("nji,j->ni", R0g, mean_dev) * freeN)
        K = (k_w2 / n_free**2) * torch.einsum("nji,mjk->nimk", R0g, R0g)
        S[:, :3, :, :3] += K * free[:, None, None, None] * free[None, None, :, None]

    hv = torch.einsum("ijt,jt->it", Hpp_inv, g_p)
    b = -g_c + torch.einsum("iknt,kt->ni", Y, hv)
    if dc:
        # exact shared calibration: pose blocks per camera, one pooled
        # dc-dim calibration variable (its rows and columns summed)
        dp = d - dc
        Nd = n_cam * dp
        Sp = S[:, :dp, :, :dp].reshape(Nd, Nd)
        Spc = torch.sum(S[:, :dp, :, dp:], dim=2).reshape(Nd, dc)
        Scc = torch.sum(S[:, dp:, :, dp:], dim=(0, 2))
        St = torch.cat([torch.cat([Sp, Spc], dim=1), torch.cat([Spc.T, Scc], dim=1)])
        bt = torch.cat([b[:, :dp].reshape(-1), torch.sum(b[:, dp:], dim=0)])
        xt = torch.linalg.solve_ex(St, bt[:, None])[0][:, 0]
        delta_c = torch.cat([xt[:Nd].reshape(n_cam, dp), xt[Nd:][None].expand(n_cam, dc)], dim=-1)
    else:
        Nd = n_cam * d
        delta_c = torch.linalg.solve_ex(S.reshape(Nd, Nd), b.reshape(Nd, 1))[0].reshape(n_cam, d)

    xg = torch.einsum("ni,nlt->ilt", delta_c, A)
    u2 = torch.einsum("ijlt,ilt->jt", Wd, xg)
    return delta_c, -torch.einsum("ijt,jt->it", Hpp_inv, g_p + u2).T


def _apply_step(prob: BAProblem, delta_c, delta_p, opts: BAOptions) -> BAProblem:
    free = (~prob.fixed_cam)[:, None].to(delta_c.dtype)
    new_cal = prob.cal_params
    if opts.optimize_intrinsics:
        if opts.shared_intrinsics:
            # one shared calibration step (identical on every row), applied
            # to pose-frozen cameras too
            d_cal = delta_c[:1, 6:].expand_as(delta_c[:, 6:])
        else:
            d_cal = delta_c[:, 6:] * free
        new_cal = prob.cal_params + d_cal
    return prob.replace(poses=prob.poses.retract(delta_c[:, :6] * free), cal_params=new_cal,
                        points=prob.points + delta_p)


def _robust_rho(nrm: torch.Tensor, opts: BAOptions) -> torch.Tensor:
    k = opts.robust_huber_px
    if opts.robust_mode == "gnc_gm" and k > 0:
        c2 = k * k
        return 0.5 * c2 * nrm**2 / (nrm**2 + c2)  # Geman-McClure
    if k > 0:
        return torch.where(nrm <= k, 0.5 * nrm**2, k * (nrm - 0.5 * k))
    return 0.5 * nrm**2


def _karcher_dev(poses: SE3, R0: torch.Tensor, fixed_cam: torch.Tensor) -> torch.Tensor:
    """Mean over the free cameras of Log(R_i R0_i^T)."""
    dev = so3.logmap(torch.einsum("nij,nkj->nik", poses.R, R0))
    freeN = (~fixed_cam).to(dev.dtype)[:, None]
    return torch.sum(dev * freeN, dim=0) / torch.clamp(torch.sum(freeN), min=1.0)


def _extras_cost(prob: BAProblem, opts: BAOptions, extras) -> torch.Tensor:
    calp0, aidx, aval, R0 = extras
    c = prob.points.new_zeros(())
    if opts.cal_prior_weight > 0 and opts.optimize_intrinsics:
        c = c + 0.5 * opts.cal_prior_weight**2 * torch.sum((prob.cal_params - calp0) ** 2)
    if opts.first_point_prior_weight > 0:
        c = c + 0.5 * opts.first_point_prior_weight**2 * torch.sum(
            (torch.index_select(prob.points, 0, aidx.reshape(1))[0] - aval) ** 2)
    if opts.gauge == "karcher":
        c = c + 0.5 * opts.karcher_weight**2 * torch.sum(_karcher_dev(prob.poses, R0, prob.fixed_cam) ** 2)
    return c


def _cost(prob: BAProblem, opts: BAOptions, extras=None, priors=(True, True), mesh=None) -> torch.Tensor:
    """With ``mesh`` the measurement sum is over every rank's shard."""
    r, depth = _residuals(prob)
    nrm = torch.linalg.vector_norm(r, dim=-1)
    base = prob.meas_w * (depth > 1e-6)
    meas = torch.sum(base * _robust_rho(nrm, opts)) / (opts.measurement_sigma_px**2)
    if mesh is not None:
        meas = all_reduce_sum(mesh, "data", meas.reshape(1))[0]
    c = meas + _prior_cost(prob, priors)
    return c if extras is None else c + _extras_cost(prob, opts, extras)


def _cost_dense(prob: BAProblem, opts: BAOptions, extras, L: int, priors=(True, True)) -> torch.Tensor:
    T = prob.points.shape[0]
    r_e, depth_e, _, _ = _dense_linearize(prob, L, False, want_jac=False)
    nrm = torch.sqrt(r_e[0] ** 2 + r_e[1] ** 2)
    base = prob.meas_w.reshape(T, L).T * (depth_e > 1e-6)
    c = torch.sum(base * _robust_rho(nrm, opts)) / (opts.measurement_sigma_px**2) + _prior_cost(prob, priors)
    return c if extras is None else c + _extras_cost(prob, opts, extras)


class _Index(NamedTuple):
    """The index structure of one solve, fixed for all its iterations."""

    meas_cam: torch.Tensor
    meas_track: torch.Tensor
    cam_sum: SegmentSum | None  # measurements -> cameras (entry, scatter)
    trk_sum: SegmentSum  # measurements -> tracks
    rel_sum: SegmentSum | None  # between-factor ends (a then b) -> cameras
    rel_pair_sum: SegmentSum | None  # (a, b) then (b, a) -> camera pairs (dense)


def _optimize(prob: BAProblem, opts: BAOptions, mesh=None):
    """Fixed-count LM in ``opts.layout``; returns (problem, initial cost,
    final cost, cost history) with every cost still on the device. With
    ``mesh`` (layout ``scatter``) ``prob`` holds this rank's measurement
    shard, and every measurement sum runs over all the shards."""
    n_cam = prob.fixed_cam.shape[0]
    n_track = prob.points.shape[0]
    dev = prob.points.device
    dense = opts.layout == "dense"
    L = opts.dense_track_len
    # prior kinds present (one read-back each per solve); absent ones add
    # exact zeros, so they are left out of every step
    priors = (bool((prob.rel_weight != 0).any()), bool((prob.prior_weight != 0).any()))
    a_idx, b_idx = prob.rel_edges[:, 0], prob.rel_edges[:, 1]
    ends = torch.cat([a_idx, b_idx])
    cam_sum = None if dense else SegmentSum((n_cam,), prob.meas_cam)
    trk_sum = SegmentSum((n_track,), prob.meas_track)
    if mesh is not None:
        cam_sum, trk_sum = ReducedSum(cam_sum, mesh), ReducedSum(trk_sum, mesh)
    ix = _Index(
        meas_cam=prob.meas_cam, meas_track=prob.meas_track, cam_sum=cam_sum, trk_sum=trk_sum,
        rel_sum=SegmentSum((n_cam,), ends) if priors[0] else None,
        rel_pair_sum=SegmentSum((n_cam, n_cam), ends, torch.cat([b_idx, a_idx])) if dense and priors[0] else None,
    )

    # gauge and regularization anchors, taken at the start of the solve
    calp0 = prob.cal.to_params()
    anchor_idx = torch.argmax(ix.trk_sum(prob.meas_w))  # the best-constrained point
    anchor_val = torch.index_select(prob.points, 0, anchor_idx.reshape(1))[0]
    R0 = prob.poses.R
    extras = (calp0, anchor_idx, anchor_val, R0)
    shared_dc = prob.cal_params.shape[-1] if (opts.optimize_intrinsics and opts.shared_intrinsics) else 0

    def priors_for_step(prob, d):
        H_prior, g_prior, rel = _pose_prior_terms(prob, d, ix.rel_sum, priors)
        if opts.cal_prior_weight > 0 and opts.optimize_intrinsics:
            w2 = opts.cal_prior_weight**2
            cal_eye = torch.diag(torch.cat([torch.zeros(6, device=dev), torch.full((d - 6,), w2, device=dev)]))
            H_prior = H_prior + cal_eye
            g_prior = g_prior + torch.nn.functional.pad(w2 * (prob.cal_params - calp0), (6, 0))
        point_prior = None
        if opts.first_point_prior_weight > 0:
            w2p = opts.first_point_prior_weight**2
            point_prior = (anchor_idx, w2p,
                           w2p * (torch.index_select(prob.points, 0, anchor_idx.reshape(1))[0] - anchor_val))
        karcher = ((opts.karcher_weight**2, _karcher_dev(prob.poses, R0, prob.fixed_cam), R0)
                   if opts.gauge == "karcher" else None)
        return (H_prior, g_prior, rel), point_prior, karcher

    if dense:
        # camera one-hot incidence (N, L, T), fixed for the whole solve
        A = (torch.arange(n_cam, device=dev)[:, None, None] == prob.meas_cam.reshape(n_track, L).T[None]).to(
            torch.float32)
        base_e = prob.meas_w.reshape(n_track, L).T
        cost0 = _cost_dense(prob, opts, extras, L, priors)
    else:
        cost0 = _cost(prob, opts, extras, priors, mesh)
    cost = cost0
    lam = torch.tensor(opts.init_lambda, dtype=torch.float32, device=dev)
    hist = []
    for it in range(opts.max_iterations):
        mu = max(opts.gnc_mu_init * opts.gnc_gamma**it, 1.0)
        if dense:
            r_e, depth_e, Jc_e, Jp_e = _dense_linearize(prob, L, opts.optimize_intrinsics)
            nrm = torch.sqrt(r_e[0] ** 2 + r_e[1] ** 2)
            w_e = base_e * _robust_w_from_nrm(nrm, opts, mu) * (depth_e > 1e-6) / (opts.measurement_sigma_px**2)
            prior_terms, point_prior, karcher = priors_for_step(prob, Jc_e.shape[1])
            delta_c, delta_p = _schur_solve_dense(
                Jc_e, Jp_e, r_e, w_e, A, ix, prob.fixed_cam, lam, prior_terms=prior_terms,
                shared_cal_dims=shared_dc, point_prior=point_prior, karcher=karcher)
        else:
            r, depth = _residuals(prob)
            w = _robust_weights(r, depth, prob.meas_w, opts, mu)
            J_c, J_p = _jacobians(prob, opts.optimize_intrinsics)
            prior_terms, point_prior, karcher = priors_for_step(prob, J_c.shape[-1])
            delta_c, delta_p = _schur_solve(
                J_c, J_p, r, w, ix, prob.fixed_cam, lam, opts.cg_iterations, prior_terms=prior_terms,
                shared_cal_dims=shared_dc, point_prior=point_prior, karcher=karcher)
        cand = _apply_step(prob, delta_c, delta_p, opts)
        new_cost = _cost_dense(cand, opts, extras, L, priors) if dense else _cost(cand, opts, extras, priors, mesh)
        accept = new_cost < cost
        prob = where_struct(accept, cand, prob)
        lam = torch.clamp(torch.where(accept, lam * opts.lambda_down, lam * opts.lambda_up),
                          opts.min_lambda, opts.max_lambda)
        cost = torch.where(accept, new_cost, cost)
        hist.append(cost)
    return prob, cost0, cost, hist


class BundleAdjustment:
    """BA over SfmData; ``run_staged`` is the [10, 5, 3] px optimize +
    filter schedule."""

    def __init__(self, options: BAOptions = BAOptions(), mesh=None):
        """mesh: a parallel.sharding.Mesh, or None: with it, the solve's
        measurements shard over its ``data`` axis (the module's docstring)
        and every rank of the mesh must make the same calls."""
        self.options = options
        self.mesh = mesh

    def run(self, data: SfmData, fixed_cam=None, **prior_kwargs) -> tuple:
        """-> (optimized SfmData, metrics). prior_kwargs go to
        problem_from_sfm_data (rel_edges / rel_meas / rel_weight for rig
        between factors, prior_pose / prior_weight for absolute priors)."""
        opts = self.options
        with precise():
            prob = problem_from_sfm_data(data, fixed_cam=fixed_cam, **prior_kwargs)
            opts_run = opts
            if self.mesh is not None:
                # a measurement shard per rank: the segment-sum layout
                opts_run = opts._replace(layout="scatter")
                prob = shard_ba_problem(self.mesh, prob)
            elif opts.layout == "dense":
                if type(prob.cal).__name__ not in _DENSE_CALS:
                    opts_run = opts._replace(layout="entry")  # no closed-form linearization
                else:
                    try:
                        prob, L = densify_problem(prob, opts.dense_track_len)
                        opts_run = opts._replace(dense_track_len=L)
                    except ValueError:
                        opts_run = opts._replace(layout="entry")  # a track past the dense cap
            layout_counts[opts_run.layout] += 1
            prob_f, cost0, cost_f, hist = _optimize(prob, opts_run, self.mesh)
        out = problem_to_sfm_data(prob_f, data)
        costs = torch.stack([cost0, cost_f] + hist).cpu().numpy()
        metrics = {
            "initial_cost": float(costs[0]),
            "final_cost": float(costs[1]),
            "iterations": int(opts.max_iterations),
            "cost_history": [float(c) for c in costs[2:]],
        }
        if opts.robust_mode == "gnc_gm" and opts.gnc_weight_threshold > 0:
            # final GNC weights at mu = 1: the measurements the graduated
            # loss has annealed away are outliers
            with precise():
                r, depth = _residuals(problem_from_sfm_data(out))
            c2 = opts.robust_huber_px**2
            w_gnc = (c2 / (torch.sum(r * r, dim=-1) + c2)) ** 2 * (depth > 1e-6)
            out = out.replace(meas_mask=out.meas_mask & (w_gnc >= opts.gnc_weight_threshold)).filter_by_track_length(
                opts.min_track_length)
            metrics["gnc_measurements_removed"] = int(data.meas_mask.sum() - out.meas_mask.sum())
        return out, metrics

    def run_compact(self, data: SfmData, fixed_cam=None, **prior_kwargs) -> tuple:
        """``run`` on a copy of the scene compacted to its live cameras,
        tracks and measurements, scattered back into the original layout.

        A hierarchical merge concatenates its children's track axes, so by
        the root most slots are dead, and the merged pair touches a fraction
        of the global camera axis: the solve then scales with the live
        subproblem. Cameras are live when registered or measured, tracks when
        valid or measured. The reference pads each axis to a power of two to
        share XLA executables; the port compacts to the exact counts. Rig
        edges touching an inactive camera get weight 0; pose priors follow
        their cameras. The dense layout gives way to ``scatter`` above 96
        live cameras on the CPU and to ``entry`` above 1024 (its camera
        contraction grows as N^2 T)."""
        dev = data.points.device
        pm = data.pose_mask.cpu().numpy()
        mm_ = data.meas_mask.cpu().numpy()
        mc = data.meas_cam.cpu().numpy()
        mt = data.meas_track.cpu().numpy()
        active = pm.copy()
        active[mc[mm_]] = True
        act_idx = np.flatnonzero(active)
        if len(act_idx) == 0 or not mm_.any():
            return data, {"initial_cost": 0.0, "final_cost": 0.0, "iterations": 0}
        live_t = data.track_mask.cpu().numpy().copy()
        live_t[mt[mm_]] = True
        t_idx = np.flatnonzero(live_t)
        g2l = np.full(data.max_cameras, -1, np.int64)  # inactive cameras map nowhere
        g2l[act_idx] = np.arange(len(act_idx))
        t_g2l = np.zeros(data.max_tracks, np.int64)
        t_g2l[t_idx] = np.arange(len(t_idx))
        ai, ti, mi = (torch.as_tensor(x, device=dev) for x in (act_idx, t_idx, np.flatnonzero(mm_)))
        local = data.replace(
            poses=data.poses.map(lambda a: a[ai]),
            cal=data.cal.map(lambda a: a[ai]),
            pose_mask=data.pose_mask[ai],
            points=data.points[ti],
            track_mask=data.track_mask[ti],
            meas_cam=torch.as_tensor(np.maximum(g2l, 0), device=dev)[data.meas_cam[mi]],
            meas_track=torch.as_tensor(t_g2l, device=dev)[data.meas_track[mi]],
            meas_uv=data.meas_uv[mi],
            meas_mask=data.meas_mask[mi],
        )
        if prior_kwargs.get("rel_edges") is not None:
            prior_kwargs = dict(prior_kwargs)
            re_loc = g2l[torch.as_tensor(prior_kwargs["rel_edges"]).cpu().numpy()]
            re_ok = np.all(re_loc >= 0, axis=1).astype(np.float32)
            prior_kwargs["rel_edges"] = torch.as_tensor(np.maximum(re_loc, 0), device=dev)
            w = prior_kwargs.get("rel_weight")
            w = np.ones(len(re_ok), np.float32) if w is None else torch.as_tensor(w).cpu().numpy()
            prior_kwargs["rel_weight"] = torch.as_tensor(w * re_ok, device=dev)
        if prior_kwargs.get("prior_pose") is not None:
            prior_kwargs = dict(prior_kwargs)
            prior_kwargs["prior_pose"] = prior_kwargs["prior_pose"].map(lambda a: a.to(dev)[ai])
            prior_kwargs["prior_weight"] = torch.as_tensor(prior_kwargs["prior_weight"], device=dev)[ai]

        solver = self
        if self.options.layout == "dense":
            if dev.type == "cpu" and len(act_idx) > 96:
                solver = BundleAdjustment(self.options._replace(layout="scatter"), mesh=self.mesh)
            elif len(act_idx) > 1024:
                solver = BundleAdjustment(self.options._replace(layout="entry"), mesh=self.mesh)
        out_l, metrics = solver.run(local, fixed_cam=None if fixed_cam is None else fixed_cam[ai], **prior_kwargs)
        # the solve changes poses, calibrations and points, and a GNC filter
        # the masks; each live row goes back to its one slot (no accumulation)
        out = data.replace(
            poses=SE3(R=data.poses.R.index_copy(0, ai, out_l.poses.R), t=data.poses.t.index_copy(0, ai, out_l.poses.t)),
            cal=data.cal.with_params(data.cal.to_params().index_copy(0, ai, out_l.cal.to_params())),
            points=data.points.index_copy(0, ti, out_l.points),
            track_mask=data.track_mask.index_copy(0, ti, out_l.track_mask),
            meas_mask=data.meas_mask.index_copy(0, mi, out_l.meas_mask),
        )
        return out, metrics

    def run_staged(self, data: SfmData, reproj_thresholds=(10.0, 5.0, 3.0), fixed_cam=None):
        all_metrics = []
        for thresh in reproj_thresholds:
            data, m = self.run(data, fixed_cam=fixed_cam)
            data = data.filter_by_reprojection_error(thresh)
            m["filter_threshold_px"] = thresh
            m["tracks_after_filter"] = data.number_tracks()
            all_metrics.append(m)
        return data, all_metrics
