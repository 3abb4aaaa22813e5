"""Bundle adjustment: Levenberg-Marquardt with an explicit dense Schur
complement (the reference's ``layout="dense"``).

Port of gtsfm_tpu/bundle/ba.py, the path the multi-view optimizer runs:
``densify_problem`` re-lays measurements track-major to (T, L);
``_dense_linearize`` gives residuals and closed-form Jacobians of the right
retraction; ``_schur_solve_dense`` forms the reduced camera system
S = Hcc - W Hpp^-1 W^T and solves it exactly each step; the fixed-count LM
loop accepts or rejects with ``torch.where`` and never reads a value back
to the host. Huber IRLS weights, fixed-camera gauge, poses and points
optimized (intrinsics fixed), Cal3Bundler only. ``run_compact`` solves the
live subproblem of a merged scene. The iterative ``entry`` / ``scatter``
layouts, priors and GNC are still to be ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.geometry import SE3
from gtsfm_tpu_torch.utils.numerics import TensorStruct, precise, where_struct


class BAOptions(NamedTuple):
    max_iterations: int = 30
    robust_huber_px: float = 1.345  # 0 disables
    init_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    lambda_down: float = 0.5
    lambda_up: float = 4.0
    measurement_sigma_px: float = 1.0


@dataclasses.dataclass(frozen=True)
class BAProblem(TensorStruct):
    poses: SE3  # [N]
    cal: object  # Cal3Bundler [N]
    cal_params: torch.Tensor  # [N, 3]
    points: torch.Tensor  # [T, 3]
    meas_cam: torch.Tensor  # i64 [M]
    meas_track: torch.Tensor  # i64 [M]
    meas_uv: torch.Tensor  # [M, 2]
    meas_w: torch.Tensor  # [M] base weights (0 = padding/invalid)
    fixed_cam: torch.Tensor  # bool [N]


def problem_from_sfm_data(data: SfmData, fixed_cam=None) -> BAProblem:
    n = data.max_cameras
    dev = data.points.device
    if fixed_cam is None:
        fixed_cam = torch.zeros(n, dtype=torch.bool, device=dev)
    base_w = data.meas_mask & data.track_mask[data.meas_track] & data.pose_mask[data.meas_cam]
    return BAProblem(
        poses=data.poses, cal=data.cal, cal_params=data.cal.to_params(), points=data.points,
        meas_cam=data.meas_cam, meas_track=data.meas_track, meas_uv=data.meas_uv,
        meas_w=base_w.to(torch.float32), fixed_cam=fixed_cam,
    )


def densify_problem(prob: BAProblem) -> tuple:
    """Re-layout measurements track-major, padded to (T, L) and flattened
    (host numpy, once per solve); L is the next power of two >= the longest
    track. Padding rows point at their track with camera 0 and weight 0."""
    dev = prob.points.device
    trk = prob.meas_track.cpu().numpy()
    cam = prob.meas_cam.cpu().numpy()
    uv = prob.meas_uv.cpu().numpy()
    w = prob.meas_w.cpu().numpy()
    T = prob.points.shape[0]
    counts = np.bincount(trk[w > 0], minlength=T)
    max_len = int(counts.max()) if counts.size else 1
    L = 1 << max(0, int(np.ceil(np.log2(max(max_len, 2)))))
    if L > 128:
        raise NotImplementedError(f"track length {max_len} exceeds the dense layout (L={L}); "
                                  "the iterative layouts are not ported")
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


def _dense_linearize(prob: BAProblem, L: int, want_jac: bool = True):
    """Residuals r (2, L, T), depth (L, T) and, with ``want_jac``, the
    camera Jacobian Jc (2, 6, L, T) and point Jacobian Jp (2, 3, L, T) in
    the track-major layout (track axis minor)."""
    T = prob.points.shape[0]
    cam_lt = prob.meas_cam.reshape(T, L).T  # (L, T)
    Rg = prob.poses.R[cam_lt].permute(2, 3, 0, 1)  # (3, 3, L, T)
    tg = prob.poses.t[cam_lt].permute(2, 0, 1)  # (3, L, T)
    calg = prob.cal_params[cam_lt].permute(2, 0, 1)  # (3, L, T)
    cg = torch.stack([prob.cal.u0, prob.cal.v0], dim=-1)[cam_lt].permute(2, 0, 1)
    uv_e = prob.meas_uv.reshape(T, L, 2).permute(2, 1, 0)  # (2, L, T)

    dX = prob.points.T[:, None, :] - tg
    p_cam = torch.einsum("jilt,jlt->ilt", Rg, dX)  # R^T (X - t)
    z = p_cam[2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    q = p_cam[:2] / zs[None]
    f, k1, k2 = calg[0], calg[1], calg[2]
    r2 = q[0] * q[0] + q[1] * q[1]
    g = 1.0 + k1 * r2 + k2 * r2 * r2
    r = (f * g)[None] * q + cg - uv_e
    if not want_jac:
        return r, z, None, None

    gp2 = 2.0 * (k1 + 2.0 * k2 * r2)
    D00 = f * (g + gp2 * q[0] * q[0])
    D01 = f * gp2 * q[0] * q[1]
    D11 = f * (g + gp2 * q[1] * q[1])
    D = torch.stack([torch.stack([D00, D01]), torch.stack([D01, D11])])  # (2, 2, L, T)
    inv_z = 1.0 / zs
    zero = torch.zeros_like(inv_z)
    Jq = torch.stack([
        torch.stack([inv_z, zero, -q[0] * inv_z]),
        torch.stack([zero, inv_z, -q[1] * inv_z]),
    ])  # (2, 3, L, T)
    P = torch.einsum("ablt,bclt->aclt", D, Jq)
    x_, y_, z_ = p_cam[0], p_cam[1], p_cam[2]
    hatp = torch.stack([
        torch.stack([zero, -z_, y_]),
        torch.stack([z_, zero, -x_]),
        torch.stack([-y_, x_, zero]),
    ])
    Jrot = torch.einsum("ablt,bclt->aclt", P, hatp)
    Jc = torch.cat([Jrot, -P], dim=1)  # (2, 6, L, T)
    Jp = torch.einsum("ablt,cblt->aclt", P, Rg)  # P @ R^T
    return r, z, Jc, Jp


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


def _schur_solve_dense(Jc_e, Jp_e, r_e, w_e, A, fixed_cam, lam):
    """Form S = blockdiag(Hcc_d) - sum_t W_t Hpp_t^-1 W_t^T, solve the
    camera step exactly, back-substitute the points."""
    n_cam = A.shape[0]
    d = Jc_e.shape[1]
    dt = Jc_e.dtype
    dev = Jc_e.device
    sw = torch.sqrt(w_e)
    Jp = Jp_e * sw[None, None]
    rw = r_e * sw[None]
    free = (~fixed_cam).to(dt)
    free_m = torch.einsum("nlt,n->lt", A, free)
    Jc = Jc_e * sw[None, None] * free_m[None, None]

    Hpp_e = torch.einsum("rilt,rjlt->ijt", Jp, Jp)  # (3, 3, T)
    g_p_e = torch.einsum("rilt,rlt->it", Jp, rw)  # (3, T)
    Wd = torch.einsum("rilt,rjlt->ijlt", Jc, Jp)  # (d, 3, L, T)
    Hcc = torch.einsum("nlt,ijlt->nij", A, torch.einsum("rilt,rjlt->ijlt", Jc, Jc))
    g_c = torch.einsum("nlt,ilt->ni", A, torch.einsum("rilt,rlt->ilt", Jc, rw))

    eye_d = torch.eye(d, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)[:, :, None]
    Hcc_d = Hcc + lam * (Hcc.abs() * eye_d) + (lam + 1e-8) * eye_d
    Hpp_d = Hpp_e + lam * (Hpp_e.abs() * eye3) + (lam + 1e-8) * eye3
    Hpp_inv = _inv3_lanes(Hpp_d)

    Y = torch.einsum("nlt,iklt->iknt", A, Wd)  # (d, 3, N, T)
    Y2 = torch.einsum("kqt,jqnt->jknt", Hpp_inv, Y)
    S = -torch.einsum("iknt,jkmt->nimj", Y, Y2)  # (N, d, N, d)
    ar = torch.arange(n_cam, device=dev)
    S[ar, :, ar, :] += Hcc_d
    hv = torch.einsum("ijt,jt->it", Hpp_inv, g_p_e)
    b = -g_c + torch.einsum("iknt,kt->ni", Y, hv)
    Nd = n_cam * d
    delta_c = torch.linalg.solve_ex(S.reshape(Nd, Nd), b.reshape(Nd, 1))[0].reshape(n_cam, d)

    xg = torch.einsum("ni,nlt->ilt", delta_c, A)
    u2 = torch.einsum("ijlt,ilt->jt", Wd, xg)
    delta_p = -torch.einsum("ijt,jt->it", Hpp_inv, g_p_e + u2)
    return delta_c, delta_p.T


def _apply_step(prob: BAProblem, delta_c, delta_p) -> BAProblem:
    free = (~prob.fixed_cam)[:, None].to(delta_c.dtype)
    return prob.replace(poses=prob.poses.retract(delta_c[:, :6] * free), points=prob.points + delta_p)


def _robust_rho(nrm: torch.Tensor, opts: BAOptions) -> torch.Tensor:
    k = opts.robust_huber_px
    if k > 0:
        return torch.where(nrm <= k, 0.5 * nrm**2, k * (nrm - 0.5 * k))
    return 0.5 * nrm**2


def _robust_w(nrm: torch.Tensor, opts: BAOptions) -> torch.Tensor:
    k = opts.robust_huber_px
    if k > 0:
        return torch.clamp(k / torch.clamp(nrm, min=1e-12), max=1.0)
    return torch.ones_like(nrm)


def _cost_dense(prob: BAProblem, opts: BAOptions, L: int) -> torch.Tensor:
    T = prob.points.shape[0]
    r_e, depth_e, _, _ = _dense_linearize(prob, L, want_jac=False)
    nrm = torch.sqrt(r_e[0] ** 2 + r_e[1] ** 2)
    base = prob.meas_w.reshape(T, L).T * (depth_e > 1e-6)
    return torch.sum(base * _robust_rho(nrm, opts)) / (opts.measurement_sigma_px**2)


def _optimize(prob: BAProblem, opts: BAOptions, L: int):
    """Fixed-count LM; returns (problem, initial cost, final cost, cost
    history) with every cost still on the device."""
    n_cam = prob.fixed_cam.shape[0]
    T = prob.points.shape[0]
    A = (
        torch.arange(n_cam, device=prob.points.device)[:, None, None]
        == prob.meas_cam.reshape(T, L).T[None]
    ).to(torch.float32)  # camera one-hot incidence (N, L, T)
    base_e = prob.meas_w.reshape(T, L).T
    cost0 = _cost_dense(prob, opts, L)
    cost = cost0
    lam = torch.tensor(opts.init_lambda, dtype=torch.float32, device=prob.points.device)
    hist = []
    for _ in range(opts.max_iterations):
        r_e, depth_e, Jc_e, Jp_e = _dense_linearize(prob, L)
        nrm = torch.sqrt(r_e[0] ** 2 + r_e[1] ** 2)
        w_e = base_e * _robust_w(nrm, opts) * (depth_e > 1e-6) / (opts.measurement_sigma_px**2)
        delta_c, delta_p = _schur_solve_dense(Jc_e, Jp_e, r_e, w_e, A, prob.fixed_cam, lam)
        cand = _apply_step(prob, delta_c, delta_p)
        new_cost = _cost_dense(cand, opts, L)
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

    def __init__(self, options: BAOptions = BAOptions()):
        self.options = options

    def run(self, data: SfmData, fixed_cam=None) -> tuple:
        with precise():
            prob, L = densify_problem(problem_from_sfm_data(data, fixed_cam))
            prob_f, cost0, cost_f, hist = _optimize(prob, self.options, L)
        out = data.replace(poses=prob_f.poses, cal=prob_f.cal.with_params(prob_f.cal_params),
                           points=prob_f.points)
        costs = torch.stack([cost0, cost_f] + hist).cpu().numpy()
        metrics = {
            "initial_cost": float(costs[0]),
            "final_cost": float(costs[1]),
            "iterations": int(self.options.max_iterations),
            "cost_history": [float(c) for c in costs[2:]],
        }
        return out, metrics

    def run_compact(self, data: SfmData, fixed_cam=None) -> tuple:
        """``run`` on a copy of the scene compacted to its live cameras,
        tracks and measurements, scattered back into the original layout.

        A hierarchical merge concatenates its children's track axes, so by
        the root most slots are dead, and the merged pair touches a fraction
        of the global camera axis: the solve then scales with the live
        subproblem. Cameras are live when registered or measured, tracks when
        valid or measured. The reference pads each axis to a power of two to
        share XLA executables; the port compacts to the exact counts."""
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
        g2l = np.zeros(data.max_cameras, np.int64)
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
            meas_cam=torch.as_tensor(g2l, device=dev)[data.meas_cam[mi]],
            meas_track=torch.as_tensor(t_g2l, device=dev)[data.meas_track[mi]],
            meas_uv=data.meas_uv[mi],
            meas_mask=data.meas_mask[mi],
        )
        out_l, metrics = self.run(local, fixed_cam=None if fixed_cam is None else fixed_cam[ai])
        # the solve changes poses, calibrations and points; each live row
        # goes back to its one slot (no accumulation)
        out = data.replace(
            poses=SE3(R=data.poses.R.index_copy(0, ai, out_l.poses.R), t=data.poses.t.index_copy(0, ai, out_l.poses.t)),
            cal=data.cal.with_params(data.cal.to_params().index_copy(0, ai, out_l.cal.to_params())),
            points=data.points.index_copy(0, ti, out_l.points),
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
