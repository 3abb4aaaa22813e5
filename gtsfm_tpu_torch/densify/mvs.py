"""Dense multi-view stereo: plane-sweep depth and fusion.

Port of gtsfm_tpu/densify/mvs.py. Per reference view, D fronto-parallel
planes evenly spaced in inverse depth, each source image warped onto them
by the plane-induced homography (bilinear), a zero-mean NCC over a box
window, the mean of the best half of the sources, the best plane with a
parabola refinement. ``plane_sweep_depth`` runs on the device of its
inputs in float32 under ``precise()``, all depths and sources of a view
batched at once (in depth chunks of ``VOLUME_BYTES`` a (depths, sources,
H, W) float32 volume). Source selection, the depth ranges and the fusion
are the reference's host numpy, kept as they are:
``select_source_views`` ranks with ``np.argsort`` (quicksort ties), and
``fuse_depth_maps`` mirrors its ``max_depth_rel_err * 10`` test, its
stride of 2 and its confidence threshold of 0.3.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.utils.numerics import precise, resolve_device

# float32 bytes of a (depths, sources, H, W) NCC volume per chunk
VOLUME_BYTES = 1 << 29


class MVSOptions(NamedTuple):
    num_depths: int = 64
    num_source_views: int = 4
    window: int = 5  # NCC window (odd)
    theta0_deg: float = 5.0  # triangulation-angle score center
    min_consistent_views: int = 2
    max_reproj_err_px: float = 1.0
    max_depth_rel_err: float = 0.01
    depth_margin: float = 1.3  # expand sparse depth range by this factor


def _host(data: SfmData) -> dict:
    """The scene's fields as host numpy."""
    h = {k: getattr(data, k).cpu().numpy() for k in ("pose_mask", "points", "meas_cam", "meas_track", "meas_mask")}
    return h | {"R": data.poses.R.cpu().numpy(), "t": data.poses.t.cpu().numpy(), "K": data.cal.K().cpu().numpy()}


def select_source_views(data: SfmData, opts: MVSOptions = MVSOptions()) -> np.ndarray:
    """Score view pairs by shared-track triangulation angles with the
    piecewise Gaussian (theta0 = 5 deg); return (N, num_source_views)
    source indices per reference view. Host numpy, as the reference."""
    h = _host(data)
    n = data.max_cameras
    centers, pts = h["t"], h["points"]
    mcam, mtrk, mask = h["meas_cam"], h["meas_track"], h["meas_mask"]
    score = np.zeros((n, n))
    track_cams: dict = {}
    for c, t in zip(mcam[mask], mtrk[mask]):
        track_cams.setdefault(t, []).append(c)
    theta0 = opts.theta0_deg
    for t, cams in track_cams.items():
        X = pts[t]
        for i in range(len(cams)):
            for j in range(i + 1, len(cams)):
                a, b = cams[i], cams[j]
                va = centers[a] - X
                vb = centers[b] - X
                cosang = np.dot(va, vb) / max(np.linalg.norm(va) * np.linalg.norm(vb), 1e-9)
                theta = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
                sigma = 1.0 if theta <= theta0 else 10.0
                s = np.exp(-((theta - theta0) ** 2) / (2 * sigma**2))
                score[a, b] += s
                score[b, a] += s
    src = np.argsort(-score, axis=1)[:, : opts.num_source_views]
    return src.astype(np.int32)


def _depth_range_per_view(data: SfmData, margin: float) -> np.ndarray:
    """(N, 2) [min, max] depth from the sparse tracks seen by each view
    (the 2nd and 98th percentiles over the margin and times it), NaN for a
    view that sees none in front of it."""
    h = _host(data)
    n = data.max_cameras
    depths = np.full((n, 2), np.nan)
    mcam, mtrk, mask, pts = h["meas_cam"], h["meas_track"], h["meas_mask"], h["points"]
    for i in range(n):
        sel = mask & (mcam == i)
        if not sel.any():
            continue
        # R^T (p - t) in float32, the reference's SE3.transform_to
        z = ((pts[mtrk[sel]] - h["t"][i]) @ h["R"][i])[:, 2]
        z = z[z > 0]
        if len(z) == 0:
            continue
        depths[i] = [np.percentile(z, 2) / margin, np.percentile(z, 98) * margin]
    return depths


def _box(x: torch.Tensor, window: int) -> torch.Tensor:
    """Mean over a window x window box of each (..., H, W) image, zero
    padded, always divided by window^2 (the reference's SAME convolution)."""
    shape = x.shape
    y = F.avg_pool2d(x.reshape(-1, 1, *shape[-2:]), window, stride=1, padding=window // 2, count_include_pad=True)
    return y.reshape(shape)


def _bilinear(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> tuple:
    """Sample each of the S images (S, H, W) at (..., S, H, W) pixel
    positions: the top-left corner clamped to [0, W-2] x [0, H-2], the
    weights clipped to [0, 1]; -> (values, in-bounds mask)."""
    S, H, W = imgs.shape
    x0f = torch.clamp(torch.floor(x), 0, W - 2)
    y0f = torch.clamp(torch.floor(y), 0, H - 2)
    fx = torch.clamp(x - x0f, 0, 1)
    fy = torch.clamp(y - y0f, 0, 1)
    base = (torch.arange(S, device=imgs.device) * (H * W))[:, None, None]
    i00 = base + y0f.long() * W + x0f.long()
    flat = imgs.reshape(-1)
    v = (flat[i00] * (1 - fy) * (1 - fx) + flat[i00 + 1] * (1 - fy) * fx
         + flat[i00 + W] * fy * (1 - fx) + flat[i00 + W + 1] * fy * fx)
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return v, inb


def plane_sweep_depth(ref_img: torch.Tensor, src_imgs: torch.Tensor, ref_K: torch.Tensor, src_K: torch.Tensor,
                      ref_cTw_R: torch.Tensor, ref_cTw_t: torch.Tensor, src_cTw_R: torch.Tensor,
                      src_cTw_t: torch.Tensor, depth_min: float, depth_max: float, num_depths: int = 64,
                      window: int = 5) -> tuple:
    """Plane-sweep stereo for one reference view, on the device of
    ``ref_img``: ref_img (H, W) gray, src_imgs (S, H, W), ref_K (3, 3),
    src_K (S, 3, 3), world-to-camera rotations and translations of the
    reference (3, 3), (3,) and the sources (S, 3, 3), (S, 3), the depth
    range. -> (depth (H, W), confidence (H, W) in [0, 1])."""
    with torch.no_grad(), precise():
        dev = ref_img.device
        f32 = dict(dtype=torch.float32, device=dev)
        ref_img, src_imgs, ref_K, src_K, ref_cTw_R, ref_cTw_t, src_cTw_R, src_cTw_t = (
            torch.as_tensor(a, **f32) for a in (ref_img, src_imgs, ref_K, src_K, ref_cTw_R, ref_cTw_t, src_cTw_R,
                                                src_cTw_t))
        H, W = ref_img.shape
        S = src_imgs.shape[0]
        D = num_depths
        inv_dmin = 1.0 / torch.clamp(torch.tensor(depth_min, **f32), min=1e-6)
        inv_dmax = 1.0 / torch.clamp(torch.tensor(depth_max, **f32), min=1e-6)
        # jnp.linspace(inv_dmax, inv_dmin, D): far -> near, the end point exact
        step = torch.arange(D - 1, **f32) / (D - 1)
        inv_depths = torch.cat([inv_dmax * (1 - step) + inv_dmin * step, inv_dmin[None]])
        depths = 1.0 / inv_depths

        # src <- ref: x_s = R_rel x_r + t_rel
        R_rel = src_cTw_R @ ref_cTw_R.T
        t_rel = src_cTw_t - torch.einsum("sij,j->si", R_rel, ref_cTw_t)
        ys, xs = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32), indexing="ij")
        pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
        rays = pix @ torch.linalg.inv(ref_K).T  # (H, W, 3)
        rot_rays = torch.einsum("sij,hwj->shwi", R_rel, rays)  # (S, H, W, 3)

        ref_zm = ref_img - _box(ref_img, window)
        ref_var = _box(ref_zm * ref_zm, window)
        k = max(1, S // 2)
        chunk = max(1, VOLUME_BYTES // (4 * S * H * W))
        scores = torch.empty((D, H, W), **f32)
        for s0 in range(0, D, chunk):
            d = depths[s0 : s0 + chunk]
            Xs = d[:, None, None, None, None] * rot_rays + t_rel[:, None, None, :]  # (dc, S, H, W, 3)
            zs = Xs[..., 2]
            uv = torch.einsum("sij,dshwj->dshwi", src_K, Xs / torch.clamp(zs, min=1e-6)[..., None])
            warped, inb = _bilinear(src_imgs, uv[..., 0], uv[..., 1])
            del Xs, uv
            wzm = warped - _box(warped, window)
            cov = _box(ref_zm * wzm, window)
            wvar = _box(wzm * wzm, window)
            ncc = cov / torch.sqrt(torch.clamp(ref_var * wvar, min=1e-10))
            ncc = torch.where(inb & (zs > 0), ncc, -1.0)
            # the mean of the best half of the sources (robust to occlusion)
            scores[s0 : s0 + chunk] = torch.topk(ncc, k, dim=1).values.mean(dim=1)

        best_score = scores.max(dim=0).values
        # the first plane that reaches the maximum, as jnp.argmax
        ar = torch.arange(D, device=dev)[:, None, None]
        best = torch.where(scores == best_score, ar, D).min(dim=0).values
        # parabola sub-plane refinement in inverse depth
        s0 = torch.gather(scores, 0, torch.clamp(best - 1, 0, D - 1)[None])[0]
        s2 = torch.gather(scores, 0, torch.clamp(best + 1, 0, D - 1)[None])[0]
        denom = s0 - 2 * best_score + s2
        delta = torch.where(torch.abs(denom) > 1e-9, 0.5 * (s0 - s2) / denom, 0.0)
        delta = torch.clamp(delta, -1.0, 1.0)
        inv_step = (inv_dmin - inv_dmax) / (D - 1)
        inv_best = inv_dmax + (best.to(torch.float32) + delta) * inv_step
        depth = 1.0 / torch.clamp(inv_best, min=1e-6)
        conf = torch.clamp(best_score, 0.0, 1.0)
        return depth, conf


def _world_to_cam(h: dict) -> tuple:
    cTw_R = h["R"].transpose(0, 2, 1)
    return cTw_R, -np.einsum("nij,nj->ni", cTw_R, h["t"])


class DenseMVS:
    """What the dense back ends share: ``run(data, images) -> (points (P,
    3), colors (P,), metrics)`` is the back end's ``compute_depths(data,
    images, sec)`` and then ``fuse_depth_maps``; images: (N, H, W) gray
    numpy aligned with the scene's cameras. The metrics carry the seconds
    of the source selection, the depth maps and the fusion."""

    options: MVSOptions

    def run(self, data: SfmData, images: np.ndarray) -> tuple:
        sec = {}
        depths, confs = self.compute_depths(data, images, sec)
        t0 = time.perf_counter()
        points, colors, metrics = fuse_depth_maps(depths, confs, data, images, self.options)
        sec["fusion_sec"] = time.perf_counter() - t0
        return points, colors, {**metrics, **sec}

    def _select(self, data: SfmData, sec: dict) -> tuple:
        """(host fields, source views, depth ranges); sec receives
        source_selection_sec."""
        t0 = time.perf_counter()
        h = _host(data)
        src_sel = select_source_views(data, self.options)
        dranges = _depth_range_per_view(data, self.options.depth_margin)
        sec["source_selection_sec"] = time.perf_counter() - t0
        return h, src_sel, dranges


class PlaneSweepMVS(DenseMVS):
    """Dense reconstruction by plane sweep: the depth maps are computed on
    ``device`` (the CUDA card by default)."""

    def __init__(self, options: MVSOptions = MVSOptions(), device="cuda"):
        self.options = options
        self.device = resolve_device(device)

    def compute_depths(self, data: SfmData, images: np.ndarray, sec: dict = None) -> tuple:
        """-> ({view: (H, W) depth}, {view: (H, W) confidence}), numpy;
        ``sec`` receives source_selection_sec and depth_sec."""
        sec = {} if sec is None else sec
        opts = self.options
        h, src_sel, dranges = self._select(data, sec)
        t0 = time.perf_counter()
        f32 = dict(dtype=torch.float32, device=self.device)
        cTw_R, cTw_t = (torch.as_tensor(a, **f32) for a in _world_to_cam(h))
        Ks = torch.as_tensor(h["K"], **f32)
        imgs = torch.as_tensor(np.asarray(images, np.float32), **f32)
        depths, confs = {}, {}
        for i, srcs in _views_to_run(h["pose_mask"], src_sel, dranges, opts.num_source_views):
            sidx = torch.as_tensor(srcs, device=self.device)
            d, c = plane_sweep_depth(imgs[i], imgs[sidx], Ks[i], Ks[sidx], cTw_R[i], cTw_t[i], cTw_R[sidx],
                                     cTw_t[sidx], float(dranges[i, 0]), float(dranges[i, 1]),
                                     num_depths=opts.num_depths, window=opts.window)
            depths[i] = d.cpu().numpy()
            confs[i] = c.cpu().numpy()
        sec["depth_sec"] = time.perf_counter() - t0
        return depths, confs


def _views_to_run(pose_mask, src_sel, dranges, num_source_views: int):
    """(view, its sources) for each posed view with a depth range and a
    posed source other than itself; sources padded to num_source_views by
    repetition."""
    for i in range(len(pose_mask)):
        if not pose_mask[i] or np.isnan(dranges[i, 0]):
            continue
        srcs = [int(s) for s in src_sel[i] if pose_mask[s] and s != i][:num_source_views]
        if len(srcs) < 1:
            continue
        yield i, (srcs + srcs)[:num_source_views]


def fuse_depth_maps(depths: dict, confs: dict, data: SfmData, images: np.ndarray, opts: MVSOptions) -> tuple:
    """Cross-view geometric consistency filtering and fusion into a world
    point cloud (shared by the plane-sweep and PatchmatchNet back ends).
    Host numpy, as the reference, quirks included: every second pixel,
    confidence > 0.3, and a depth agreement within ``max_depth_rel_err *
    10``."""
    if True:  # the reference's block, kept as it is
        h = _host(data)
        Ks, ts = h["K"], h["t"]
        cTw_R, cTw_t = _world_to_cam(h)
        pts_out, col_out = [], []
        view_ids = sorted(depths.keys())
        for i in view_ids:
            H, W = depths[i].shape
            ys, xs = np.mgrid[0:H, 0:W]
            step = 2  # subsample for fusion density control
            sel = (confs[i] > 0.3)[::step, ::step]
            xs_s, ys_s = xs[::step, ::step][sel], ys[::step, ::step][sel]
            d_s = depths[i][::step, ::step][sel]
            if len(xs_s) == 0:
                continue
            Kinv = np.linalg.inv(Ks[i])
            rays = (Kinv @ np.stack([xs_s, ys_s, np.ones_like(xs_s)], 0)).T
            X_cam = rays * d_s[:, None]
            X_world = X_cam @ cTw_R[i] + ts[i]  # R^T x via right-multiply

            consistent = np.zeros(len(X_world), np.int32)
            for j in view_ids:
                if j == i:
                    continue
                Xj = X_world @ cTw_R[j].T + cTw_t[j]
                zj = Xj[:, 2]
                ok = zj > 1e-6
                uvj = (Xj / np.maximum(zj[:, None], 1e-6)) @ Ks[j].T
                xj = np.clip(np.round(uvj[:, 0]).astype(int), 0, W - 1)
                yj = np.clip(np.round(uvj[:, 1]).astype(int), 0, H - 1)
                inb = ok & (uvj[:, 0] >= 0) & (uvj[:, 0] < W) & (uvj[:, 1] >= 0) & (uvj[:, 1] < H)
                dj = depths[j][yj, xj]
                rel = np.abs(dj - zj) / np.maximum(zj, 1e-6)
                consistent += (inb & (rel < opts.max_depth_rel_err * 10)).astype(np.int32)
            keep = consistent >= opts.min_consistent_views - 1
            pts_out.append(X_world[keep])
            col_out.append(images[i][ys_s[keep], xs_s[keep]])

        if pts_out:
            points = np.concatenate(pts_out)
            colors = np.concatenate(col_out)
        else:
            points = np.zeros((0, 3), np.float32)
            colors = np.zeros(0, np.float32)
        metrics = {
            "num_views_with_depth": len(view_ids),
            "num_dense_points": len(points),
        }
        return points.astype(np.float32), colors.astype(np.float32), metrics
