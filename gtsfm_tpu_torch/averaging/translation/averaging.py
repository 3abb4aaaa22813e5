"""Global translation averaging with 1DSfM outlier rejection.

Port of gtsfm_tpu/averaging/translation/averaging.py with every option:
outlier rejection on or off, MFAS over the camera graph alone or with the
camera->track directions, uniform or measurement-seeded projection
sampling, and the rig-constrained solve (cameras collapsed onto rig-body
nodes with known world-frame offsets, the metric scale recovered in closed
form). MFAS is a sequential host heuristic: the port binds its copy of the
reference's native ``libmfas.so`` (native/mfas.cpp, built by
native/build.py into build/torch_native/) through ctypes, with the same
numpy fallback. The position solve (a robust LUD alternation, then Huber
Gauss-Newton on the direction residuals) runs on the device of the
rotations.

The reference seeds the LUD phase with ``jax.random.normal(PRNGKey(0))``;
the port draws its ``t0`` from a ``torch.Generator`` seeded with 0, or takes
it as an argument (the tests replay the reference's draw). The projection
directions come from ``numpy.random.default_rng(seed)`` with the
reference's calls in the reference's order, so they are bit-equal.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from gtsfm_tpu_torch.utils.numerics import SegmentSum, precise

MAX_PROJECTION_DIRECTIONS = 2000
OUTLIER_WEIGHT_THRESHOLD = 0.125


class TranslationAveragingOptions(NamedTuple):
    lud_iterations: int = 40
    refine_iterations: int = 30
    robust_huber: float = 0.1
    num_projection_dirs: int = MAX_PROJECTION_DIRECTIONS
    outlier_weight_threshold: float = OUTLIER_WEIGHT_THRESHOLD
    reject_outliers: bool = True
    # run MFAS over the camera + track direction graph (else cameras only)
    mfas_include_tracks: bool = True
    # projection directions: uniform at the full budget (else half the
    # measured directions, half random, up to max(E, 8))
    mfas_uniform_sampling: bool = True


_MFAS_LIB = None


def _native_mfas():
    """ctypes binding of the port's libmfas.so (False when it cannot
    be built)."""
    global _MFAS_LIB
    if _MFAS_LIB is not None:
        return _MFAS_LIB
    from gtsfm_tpu_torch.native.build import ensure_built

    so = ensure_built("libmfas.so")
    if so is None:
        _MFAS_LIB = False
        return _MFAS_LIB
    lib = ctypes.CDLL(so)
    i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
    lib.mfas_order.argtypes = [i64p, i64p, f64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.mfas_order.restype = None
    lib.mfas_outlier_weights.argtypes = [
        i64p, f64p, ctypes.c_int64, ctypes.c_int64, f64p, ctypes.c_int64, ctypes.c_int64, f64p,
    ]
    lib.mfas_outlier_weights.restype = None
    _MFAS_LIB = lib
    return _MFAS_LIB


def mfas_outlier_weights(edges: np.ndarray, w_dirs: np.ndarray, num_nodes: int,
                         proj_dirs: np.ndarray) -> np.ndarray:
    """1DSfM outlier weight per edge (t_i - t_j ~ s * w_dirs[e]), averaged
    over the projection directions."""
    E = len(edges)
    if E == 0:
        return np.zeros(0, np.float32)
    lib = _native_mfas()
    if lib:
        i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
        e2 = np.ascontiguousarray(np.asarray(edges, np.int64).reshape(-1))
        wd = np.ascontiguousarray(np.asarray(w_dirs, np.float64).reshape(-1))
        pd = np.ascontiguousarray(np.asarray(proj_dirs, np.float64).reshape(-1))
        out = np.empty(E, np.float64)
        n_threads = min(len(proj_dirs), os.cpu_count() or 1, 16)
        lib.mfas_outlier_weights(
            e2.ctypes.data_as(i64p), wd.ctypes.data_as(f64p), E, num_nodes,
            pd.ctypes.data_as(f64p), len(proj_dirs), n_threads, out.ctypes.data_as(f64p),
        )
        return out.astype(np.float32)
    broken = np.zeros(E, np.float64)
    total = np.zeros(E, np.float64)
    for d in proj_dirs:
        proj = w_dirs @ d
        src = np.where(proj > 0, edges[:, 1], edges[:, 0])
        dst = np.where(proj > 0, edges[:, 0], edges[:, 1])
        wgt = np.abs(proj)
        order = _greedy_mfas_order(src, dst, wgt, num_nodes)
        pos = np.empty(num_nodes, np.int64)
        pos[order] = np.arange(num_nodes)
        broken += np.where(pos[src] > pos[dst], wgt, 0.0)
        total += wgt
    return (broken / np.maximum(total, 1e-12)).astype(np.float32)


def _greedy_mfas_order(src, dst, wgt, n) -> np.ndarray:
    """Greedy minimum-feedback-arc-set ordering: the native library when
    built, else the reference's numpy ratio-greedy + insertion refinement."""
    lib = _native_mfas()
    if lib:
        i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
        out = np.empty(n, np.int64)
        s = np.ascontiguousarray(src, np.int64)
        d = np.ascontiguousarray(dst, np.int64)
        w = np.ascontiguousarray(wgt, np.float64)
        lib.mfas_order(s.ctypes.data_as(i64p), d.ctypes.data_as(i64p), w.ctypes.data_as(f64p),
                       len(s), n, out.ctypes.data_as(i64p))
        return out
    eps = 1e-8
    win = np.zeros(n)
    wout = np.zeros(n)
    np.add.at(wout, src, wgt)
    np.add.at(win, dst, wgt)
    out_edges = [[] for _ in range(n)]
    in_edges = [[] for _ in range(n)]
    for e in range(len(src)):
        out_edges[src[e]].append((dst[e], wgt[e]))
        in_edges[dst[e]].append((src[e], wgt[e]))
    removed = np.zeros(n, bool)
    order = []
    for _ in range(n):
        ratio = np.where(removed, -np.inf, (wout + eps) / (win + eps))
        u = int(np.argmax(ratio))
        order.append(u)
        removed[u] = True
        for v, w in out_edges[u]:
            if not removed[v]:
                win[v] = max(win[v] - w, 0.0)
        for v, w in in_edges[u]:
            if not removed[v]:
                wout[v] = max(wout[v] - w, 0.0)
    order = np.asarray(order, np.int64)
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    order = list(order)
    for _ in range(8):
        improved = False
        for u in range(n):
            pu = int(pos[u])
            evs = [(int(pos[v]), -w) for v, w in out_edges[u]]
            evs += [(int(pos[v]), +w) for v, w in in_edges[u]]
            if not evs:
                continue
            evs.sort()
            best_gain, best_t = 0.0, pu
            g = 0.0
            for pv, dw in evs:
                if pv > pu:
                    g += dw
                    if g > best_gain + 1e-12:
                        best_gain, best_t = g, pv
            g = 0.0
            for pv, dw in reversed(evs):
                if pv < pu:
                    g -= dw
                    if g > best_gain + 1e-12:
                        best_gain, best_t = g, pv
            if best_t == pu:
                continue
            improved = True
            order.pop(pu)
            order.insert(best_t, u)
            lo, hi = (best_t, pu) if best_t < pu else (pu, best_t)
            for k in range(lo, hi + 1):
                pos[order[k]] = k
        if not improved:
            break
    return np.asarray(order, np.int64)


def initial_positions(num_nodes: int, device=None) -> torch.Tensor:
    """The LUD phase's random start, N(0, 0.1^2) from a generator seeded
    with 0 (the reference draws it with jax.random.PRNGKey(0))."""
    g = torch.Generator().manual_seed(0)
    return (torch.randn((num_nodes, 3), generator=g) * 0.1).to(device)


def _solve_positions(
    num_nodes: int,
    edges: torch.Tensor,  # i64 (E, 2): t_i - t_j + c_e ~ s_e u_e
    u: torch.Tensor,  # (E, 3)
    w: torch.Tensor,  # (E,)
    opts: TranslationAveragingOptions,
    c: torch.Tensor | None = None,
    t0: torch.Tensor | None = None,
    t_init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Node positions (n, 3) with t_i - t_j + c_e ~ s_e u_e: the LUD phase
    from ``t0`` (default ``initial_positions``), then the GN polish; a
    ``t_init`` (a metric warm start) skips the LUD phase."""
    n = num_nodes
    dev, dt = u.device, u.dtype
    i, j = edges[:, 0], edges[:, 1]
    if c is None:
        c = torch.zeros_like(u)
    if t0 is None and t_init is None:
        t0 = initial_positions(n, dev)
    k = opts.robust_huber
    eye_n = torch.eye(n, dtype=dt, device=dev)
    anchor = torch.zeros((n, n), dtype=dt, device=dev)
    anchor[0, 0] = 1e4
    # the four blocks of every edge, (i, i), (j, j), (i, j), (j, i), and the
    # two gradient rows, i and j
    block_sum = SegmentSum((n, n), torch.cat([i, j, i, j]), torch.cat([i, j, j, i]))
    row_sum = SegmentSum((n,), torch.cat([i, j]))

    def huber_w(rn):
        return torch.clamp(k / torch.clamp(rn, min=1e-12), max=1.0) if k > 0 else torch.ones_like(rn)

    # phase 1: robust LUD alternation (IRLS on direction residuals, s >= 1)
    t = t0 if t_init is None else t_init
    for _ in range(opts.lud_iterations if t_init is None else 0):
        d = t[i] - t[j] + c
        nrm = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-9)
        rn = torch.linalg.vector_norm(d / nrm[:, None] - u, dim=-1)
        we = w * huber_w(rn)
        L = block_sum(torch.cat([we, we, -we, -we]))
        L = L + 1e-6 * eye_n + anchor
        s = torch.clamp(torch.sum(d * u, dim=-1), min=1.0)
        rhs_e = we[:, None] * (s[:, None] * u - c)
        rhs = row_sum(torch.cat([rhs_e, -rhs_e]))
        Lc, _ = torch.linalg.cholesky_ex(L)
        t = torch.cholesky_solve(rhs, Lc)

    # phase 2: Huber Gauss-Newton on normalize(t_i - t_j + c) - u
    def residuals(t_):
        d_ = t_[i] - t_[j] + c
        return d_ / torch.clamp(torch.linalg.vector_norm(d_, dim=-1), min=1e-9)[:, None] - u

    def cost_of(t_):
        rn_ = torch.linalg.vector_norm(residuals(t_), dim=-1)
        rho = torch.where(rn_ <= k, 0.5 * rn_**2, k * (rn_ - 0.5 * k)) if k > 0 else 0.5 * rn_**2
        return torch.sum(w * rho)

    eye3n = torch.eye(3 * n, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    keep = torch.ones((n, 1), dtype=dt, device=dev)
    keep[0] = 0.0
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for _ in range(opts.refine_iterations):
        r = residuals(t)
        d = t[i] - t[j] + c
        nd = torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)
        dn = d / nd
        Pm = (eye3 - dn[:, :, None] * dn[:, None, :]) / nd[:, :, None]
        we = w * huber_w(torch.linalg.vector_norm(r, dim=-1))
        PtP = torch.einsum("eri,erj->eij", Pm * we[:, None, None], Pm)
        H = block_sum(torch.cat([PtP, PtP, -PtP, -PtP]))
        Ptr = torch.einsum("eri,er->ei", Pm * we[:, None, None], r)
        g = row_sum(torch.cat([Ptr, -Ptr]))
        Hd = H.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)
        Hd = Hd + lam * torch.diag(torch.diagonal(Hd)) + (lam + 1e-6) * eye3n
        Lh, _ = torch.linalg.cholesky_ex(Hd)
        delta = torch.cholesky_solve(-g.reshape(-1, 1), Lh).reshape(n, 3) * keep
        cand = t + delta
        accept = cost_of(cand) < cost_of(t)
        t = torch.where(accept, cand, t)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-10, 1e6)
    return t


class TranslationAveraging:
    """run(num_images, edges, i2Ui1, wRi, edge_mask, seed, track_dirs) ->
    (wti (N, 3) tensor, valid bool numpy (N,), inlier_edge_mask numpy (E,)).

    edges are (i1, i2); i2Ui1 (E, 3) is the unit direction of camera i1's
    center in camera i2's frame; wRi (N, 3, 3) are the averaged rotations
    (their device is where the solve runs)."""

    def __init__(self, options: TranslationAveragingOptions = TranslationAveragingOptions()):
        self.options = options

    def run(
        self,
        num_images: int,
        edges: np.ndarray,
        i2Ui1: torch.Tensor,
        wRi: torch.Tensor,
        edge_mask: np.ndarray | None = None,
        seed: int = 0,
        track_dirs: tuple | None = None,
        rig_of: np.ndarray | None = None,
        rig_offsets: np.ndarray | None = None,
        t0: torch.Tensor | None = None,
    ):
        """track_dirs: camera->landmark directions (cam_idx (A,), track_node
        (A,), w_dir (A, 3)[, weight (A,), 0 for padding]); track nodes are
        virtual nodes after the camera (or rig-body) nodes.

        rig_of (N,) / rig_offsets (N, 3): hard intra-rig constraints, each
        camera at its rig body's position plus a known world-frame offset.
        The solve runs over body nodes: a direction-only solve, the metric
        scale in closed form from the offsets, then the GN polish with the
        offsets from that warm start.

        t0: the LUD phase's start over all solve nodes (default
        ``initial_positions``)."""
        opts = self.options
        dev = wRi.device
        edges = np.asarray(edges, np.int64)
        E = len(edges)
        if E == 0:
            return torch.zeros((num_images, 3), device=dev), np.zeros(num_images, bool), np.zeros(0, bool)
        if edge_mask is None:
            edge_mask = np.ones(E, bool)
        wRi_np = wRi.cpu().numpy()
        w_dirs = np.einsum("eij,ej->ei", wRi_np[edges[:, 1]], i2Ui1.cpu().numpy().astype(np.float32))
        w_dirs /= np.maximum(np.linalg.norm(w_dirs, axis=-1, keepdims=True), 1e-12)

        inlier_mask = edge_mask.copy()
        # MFAS gate counts padded edges too (E, not the kept count), as the
        # reference does
        if opts.reject_outliers and E >= 3:
            rng = np.random.default_rng(seed)
            mfas_edges = edges[edge_mask]
            mfas_dirs = w_dirs[edge_mask]
            mfas_nodes = num_images
            if opts.mfas_include_tracks and track_dirs is not None:
                tcam = np.asarray(track_dirs[0])
                tnode = np.asarray(track_dirs[1])
                tdir = np.asarray(track_dirs[2], np.float32)
                twt = (np.asarray(track_dirs[3], np.float32) if len(track_dirs) == 4
                       else np.ones(len(tcam), np.float32))
                real = twt > 0
                if real.any():
                    te = np.stack([tnode[real].astype(np.int64) + num_images,
                                   tcam[real].astype(np.int64)], axis=-1)
                    mfas_edges = np.concatenate([mfas_edges.astype(np.int64), te])
                    mfas_dirs = np.concatenate([mfas_dirs, tdir[real]])
                    mfas_nodes = num_images + int(tnode[real].max()) + 1
            if opts.mfas_uniform_sampling:
                proj_dirs = rng.normal(size=(opts.num_projection_dirs, 3))
                proj_dirs /= np.linalg.norm(proj_dirs, axis=-1, keepdims=True)
            else:
                # half measured directions (of all E edges), half random
                k = min(opts.num_projection_dirs, max(E, 8))
                pick = rng.choice(E, size=min(k // 2, E), replace=False)
                rand = rng.normal(size=(k - len(pick), 3))
                rand /= np.linalg.norm(rand, axis=-1, keepdims=True)
                proj_dirs = np.concatenate([w_dirs[pick], rand], axis=0)
            ow = mfas_outlier_weights(mfas_edges, mfas_dirs, mfas_nodes, proj_dirs)
            keep = ow[: int(edge_mask.sum())] <= opts.outlier_weight_threshold
            inlier_mask[np.nonzero(edge_mask)[0][~keep]] = False

        valid = np.zeros(num_images, bool)
        np.logical_or.at(valid, edges[inlier_mask][:, 0], True)
        np.logical_or.at(valid, edges[inlier_mask][:, 1], True)

        if rig_of is not None:
            rig_of = np.asarray(rig_of, np.int64)
            rig_offsets = np.asarray(rig_offsets, np.float32).reshape(num_images, 3)
            n_body = int(rig_of.max()) + 1
            node_of = rig_of
        else:
            n_body = num_images
            node_of = np.arange(num_images, dtype=np.int64)
            rig_offsets = np.zeros((num_images, 3), np.float32)
        solve_edges = node_of[edges]
        solve_c = rig_offsets[edges[:, 0]] - rig_offsets[edges[:, 1]]
        # intra-rig edges say nothing about body positions
        solve_w = inlier_mask.astype(np.float32) * (solve_edges[:, 0] != solve_edges[:, 1])
        solve_dirs = w_dirs
        num_nodes = n_body
        if track_dirs is not None:
            cam_idx, track_node, tdirs = (np.asarray(a) for a in track_dirs[:3])
            tw = 0.5 * (np.asarray(track_dirs[3], np.float32) if len(track_dirs) == 4
                        else np.ones(len(cam_idx), np.float32))
            num_nodes = n_body + (int(np.max(track_node)) + 1 if len(track_node) else 0)
            aug_edges = np.stack([track_node.astype(np.int64) + n_body, node_of[cam_idx.astype(np.int64)]], axis=-1)
            solve_edges = np.concatenate([solve_edges, aug_edges])
            solve_c = np.concatenate([solve_c, -rig_offsets[cam_idx.astype(np.int64)]])
            solve_dirs = np.concatenate([w_dirs, tdirs.astype(np.float32)])
            solve_w = np.concatenate([solve_w, tw])
        with precise():
            se = torch.as_tensor(solve_edges, dtype=torch.int64, device=dev)
            sd = torch.as_tensor(solve_dirs, dtype=torch.float32, device=dev)
            sw = torch.as_tensor(solve_w, dtype=torch.float32, device=dev)
            sc = torch.as_tensor(solve_c, dtype=torch.float32, device=dev)
            if rig_of is not None:
                t_hat = _solve_positions(num_nodes, se, sd, sw, opts, t0=t0).cpu().numpy()
                # metric scale: each edge wants a dt + c parallel to u,
                # i.e. a (dt x u) = -(c x u)
                dt = t_hat[solve_edges[:, 0]] - t_hat[solve_edges[:, 1]]
                v = np.cross(dt, solve_dirs)
                z = np.cross(solve_c, solve_dirs)
                ww = solve_w[:, None]
                a = -float(np.sum(ww * v * z)) / max(float(np.sum(ww * v * v)), 1e-12)
                a = abs(a) if abs(a) > 1e-6 else 1.0
                t = _solve_positions(num_nodes, se, sd, sw, opts, c=sc,
                                     t_init=torch.as_tensor(a * t_hat, dtype=torch.float32, device=dev))
            else:
                t = _solve_positions(num_nodes, se, sd, sw, opts, c=sc, t0=t0)
        t = t[torch.as_tensor(node_of, device=dev)] + torch.as_tensor(rig_offsets, device=dev)
        t = torch.where(torch.as_tensor(valid, device=dev)[:, None], t, torch.zeros_like(t))
        return t, valid, inlier_mask


def select_tracks_for_coverage(track_cam: np.ndarray, track_mask: np.ndarray, num_images: int,
                               tracks_per_camera: int = 12) -> np.ndarray:
    """Greedy per-camera track selection for translation-averaging coverage
    (host numpy, as the reference)."""
    counts = np.zeros(num_images, np.int64)
    order = np.argsort(-track_mask.sum(axis=1))
    selected = []
    for t in order:
        cams = track_cam[t][track_mask[t]]
        if len(cams) < 2:
            continue
        if np.any(counts[cams] < tracks_per_camera):
            selected.append(t)
            counts[cams] += 1
        if np.all(counts >= tracks_per_camera):
            break
    return np.asarray(selected, np.int64)


def camera_track_directions(wRi: torch.Tensor, cal, track_cam, track_uv, track_mask, selected):
    """Unit world directions camera -> landmark from each selected track
    observation's bearing. Returns (cam_idx, track_node, dirs) numpy."""
    selected = np.asarray(selected, np.int64)
    if len(selected) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, 3), np.float32)
    sel_cam = np.asarray(track_cam)[selected]
    sel_uv = np.asarray(track_uv)[selected]
    sel_m = np.asarray(track_mask)[selected]
    S, L = sel_cam.shape
    flat_cam = sel_cam.reshape(-1).astype(np.int64)
    dev = wRi.device
    cam_t = torch.as_tensor(flat_cam, device=dev)
    xy = cal.map(lambda a: a[cam_t]).calibrate(
        torch.as_tensor(sel_uv.reshape(-1, 2), dtype=torch.float32, device=dev)
    ).cpu().numpy()
    bearing = np.concatenate([xy.astype(np.float64), np.ones((len(xy), 1))], axis=-1)
    bearing /= np.linalg.norm(bearing, axis=-1, keepdims=True)
    d = np.einsum("mij,mj->mi", wRi.cpu().numpy().astype(np.float64)[flat_cam], bearing)
    keep = sel_m.reshape(-1)
    nodes = np.repeat(np.arange(S, dtype=np.int32), L)
    return flat_cam[keep].astype(np.int32), nodes[keep], d[keep].astype(np.float32)
