"""Hierarchical cluster merging: Sim(3) alignment, scene union, parent BA.

Port of gtsfm_tpu/merging/merge.py. Children produced by the partitioner
own disjoint camera sets; the parent's cut edges give cross-child keypoint
correspondences. Where both ends of a cut correspondence belong to
triangulated tracks of their children, the two 3D points form a 3D-3D pair;
a robust Umeyama (LMedS hypotheses, then an IRLS polish) on those pairs
gives the child-to-child Sim3. The scenes are then concatenated (cameras
disjoint, tracks appended, paired tracks fused), compacted, and a parent BA
polishes the union.

The LMedS hypotheses are drawn from ``np.random.default_rng(0)`` in the
reference's order, so both packages score the same hypotheses; they are
scored as one batch of weighted Umeyama fits on the device.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment
from gtsfm_tpu_torch.common.sfm_data import SceneMeta, SfmData
from gtsfm_tpu_torch.geometry import SE3
from gtsfm_tpu_torch.geometry.sim3 import Sim3, _masked_median, align_points_umeyama
from gtsfm_tpu_torch.utils.numerics import precise

NUM_HYPOTHESES = 64  # LMedS minimal 4-point hypotheses


class MergeOptions(NamedTuple):
    min_3d3d_pairs: int = 8
    irls_iterations: int = 8
    inlier_threshold_factor: float = 3.0  # x median residual
    run_parent_ba: bool = True
    parent_ba: BAOptions = BAOptions(max_iterations=15)
    parent_reproj_filter_px: float = 5.0


def _residuals(sim: Sim3, pb: torch.Tensor, pa: torch.Tensor) -> torch.Tensor:
    """|sim(pb) - pa| per pair for a batch of Sim3s (H,) -> (H, P)."""
    moved = sim.s[..., None, None] * torch.einsum("...ij,pj->...pi", sim.R, pb) + sim.t[..., None, :]
    return torch.linalg.vector_norm(moved - pa, dim=-1)


def sim3_from_point_pairs(pa, pb, opts: MergeOptions = MergeOptions()) -> tuple:
    """Robust Sim3 mapping points b into frame a: the best of 64 LMedS
    4-point Umeyama hypotheses (lowest median residual), then an IRLS
    Umeyama polish with Cauchy weights at ``inlier_threshold_factor`` x
    the median residual. ``pa``, ``pb``: (P, 3) tensors (or arrays).

    Returns (Sim3, inlier mask (P,) numpy, ok)."""
    pa = torch.as_tensor(pa, dtype=torch.float32)
    pb = torch.as_tensor(pb, dtype=torch.float32, device=pa.device)
    n = pa.shape[0]
    if n < opts.min_3d3d_pairs:
        return Sim3(R=torch.eye(3), t=torch.zeros(3), s=torch.ones(())), np.zeros(n, bool), False

    # LMedS initialization: a straight IRLS from the full set collapses when
    # gross outliers dominate the first unweighted fit
    rng = np.random.default_rng(0)
    n_distinct = min(NUM_HYPOTHESES, 4 * n)  # tiny sets need fewer distinct hypotheses
    w_hyp = np.zeros((NUM_HYPOTHESES, n), np.float32)
    for h in range(NUM_HYPOTHESES):
        w_hyp[h, rng.choice(n, 4, replace=False) if h < n_distinct else [0, 1, 2, 3]] = 1.0

    valid = torch.ones(n, dtype=torch.bool, device=pa.device)
    factor = opts.inlier_threshold_factor
    with precise():
        resid_h = _residuals(align_points_umeyama(pb, pa, weights=torch.as_tensor(w_hyp, device=pa.device)), pb, pa)
        med_h = _masked_median(resid_h, valid.expand(NUM_HYPOTHESES, n))
        best = torch.argmin(med_h)
        s0 = factor * torch.clamp(med_h[best], min=1e-9)
        w = s0**2 / (s0**2 + resid_h[best] ** 2)
        for _ in range(opts.irls_iterations):
            r = _residuals(align_points_umeyama(pb, pa, weights=w), pb, pa)
            s = factor * torch.clamp(_masked_median(r, valid), min=1e-9)
            w = s**2 / (s**2 + r**2)
        sim = align_points_umeyama(pb, pa, weights=w)
        r = _residuals(sim, pb, pa)
        inliers = (r < factor * torch.clamp(_masked_median(r, valid), min=1e-9)).cpu().numpy()
    return sim, inliers, bool(inliers.sum() >= opts.min_3d3d_pairs)


def concatenate_scenes(
    data_a: SfmData,
    data_b: SfmData,
    sim_ab: Sim3,
    merge_track_pairs: Optional[np.ndarray] = None,
    meta: Optional[SceneMeta] = None,
) -> SfmData:
    """Union of two scenes over the same global camera index space.

    data_b is moved into a's frame by sim_ab. Camera slots must be disjoint.
    merge_track_pairs (M, 2) gives (track_a, track_b) duplicates: b's track
    is fused into a's (b's measurements reassigned, b's point dropped); for a
    track of b listed twice, the last pair wins."""
    if data_a.max_cameras != data_b.max_cameras:
        raise ValueError("the two scenes must share the camera index space")
    if bool((data_a.pose_mask & data_b.pose_mask).any()):
        raise ValueError("camera sets must be disjoint for concatenation")
    b_moved = data_b.transform(sim_ab)
    sel = data_a.pose_mask
    poses = SE3(R=torch.where(sel[:, None, None], data_a.poses.R, b_moved.poses.R),
                t=torch.where(sel[:, None], data_a.poses.t, b_moved.poses.t))
    cal = data_a.cal.replace(**{
        k: torch.where(sel, getattr(data_a.cal, k), getattr(data_b.cal, k)) for k in ("f", "k1", "k2", "u0", "v0")
    })

    Ta = data_a.max_tracks
    b_track_map = np.arange(data_b.max_tracks, dtype=np.int64) + Ta
    drop_b = np.zeros(data_b.max_tracks, bool)
    if merge_track_pairs is not None and len(merge_track_pairs):
        ta, tb = np.asarray(merge_track_pairs, np.int64).T
        _, last = np.unique(tb[::-1], return_index=True)
        keep = len(tb) - 1 - last
        b_track_map[tb[keep]] = ta[keep]
        drop_b[tb] = True
    dev = data_a.points.device
    b_map = torch.as_tensor(b_track_map, device=dev)
    return SfmData(
        poses=poses, cal=cal, pose_mask=data_a.pose_mask | data_b.pose_mask,
        points=torch.cat([data_a.points, b_moved.points]),
        track_mask=torch.cat([data_a.track_mask, data_b.track_mask & ~torch.as_tensor(drop_b, device=dev)]),
        meas_cam=torch.cat([data_a.meas_cam, data_b.meas_cam]),
        meas_track=torch.cat([data_a.meas_track, b_map[data_b.meas_track]]),
        meas_uv=torch.cat([data_a.meas_uv, data_b.meas_uv]),
        meas_mask=torch.cat([data_a.meas_mask, data_b.meas_mask]),
        meta=meta or data_a.meta,
    )


def compact_tracks(data: SfmData) -> tuple:
    """Drop dead track and measurement slots (a merge concatenates its
    children's padded axes). Returns (compacted SfmData, old -> new track
    index map with -1 = dropped). Tracks are live when valid or measured."""
    tm = data.track_mask.cpu().numpy()
    mm_ = data.meas_mask.cpu().numpy()
    live = tm.copy()
    live[data.meas_track.cpu().numpy()[mm_]] = True
    t_idx = np.flatnonzero(live)
    m_idx = np.flatnonzero(mm_)
    if len(t_idx) == 0 or len(m_idx) == 0:
        return data, np.arange(data.max_tracks, dtype=np.int64)
    old2new = np.full(data.max_tracks, -1, np.int64)
    old2new[t_idx] = np.arange(len(t_idx))
    dev = data.points.device
    ti = torch.as_tensor(t_idx, device=dev)
    mi = torch.as_tensor(m_idx, device=dev)
    out = data.replace(
        points=data.points[ti],
        track_mask=data.track_mask[ti],
        meas_cam=data.meas_cam[mi],
        meas_track=torch.as_tensor(old2new, device=dev)[data.meas_track[mi]],
        meas_uv=data.meas_uv[mi],
        meas_mask=data.meas_mask[mi],
    )
    return out, old2new


def merge_children(
    data_a: SfmData,
    data_b: SfmData,
    pairs_3d3d: tuple,  # (pa (P, 3), pb (P, 3), track_a (P,), track_b (P,))
    opts: MergeOptions = MergeOptions(),
    meta: Optional[SceneMeta] = None,
) -> tuple:
    """Align child b onto child a through 3D-3D pairs, fuse the Sim3-inlier
    track pairs, compact, filter at 3x the parent threshold, run the parent
    BA (gauge: the camera with the most measurements) and filter. Returns
    (SfmData or None when the Sim3 fails, metrics dict)."""
    pa, pb, ta, tb = pairs_3d3d
    metrics = {"num_3d3d_pairs": len(pa)}
    t0 = time.perf_counter()
    sim, inl, ok = sim3_from_point_pairs(pa, pb, opts)
    metrics["sim3_ok"] = ok
    metrics["sim3_inliers"] = int(inl.sum())
    metrics["sim3_inlier_mask"] = inl  # which 3D-3D pairs were fused
    metrics["sim3_sec"] = time.perf_counter() - t0
    if not ok:
        return None, metrics
    t0 = time.perf_counter()
    merge_pairs = np.stack([np.asarray(ta)[inl], np.asarray(tb)[inl]], axis=-1)
    merged = concatenate_scenes(data_a, data_b, sim, merge_track_pairs=merge_pairs, meta=meta)
    merged, metrics["track_old2new"] = compact_tracks(merged)
    merged = merged.filter_by_reprojection_error(opts.parent_reproj_filter_px * 3)
    metrics["concat_sec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if opts.run_parent_ba:
        counts = np.bincount(merged.meas_cam[merged.meas_mask].cpu().numpy(), minlength=merged.max_cameras)
        fixed = torch.zeros(merged.max_cameras, dtype=torch.bool, device=merged.points.device)
        fixed[int(np.argmax(counts))] = True
        merged, metrics["parent_ba"] = BundleAdjustment(opts.parent_ba).run_compact(merged, fixed_cam=fixed)
        merged = merged.filter_by_reprojection_error(opts.parent_reproj_filter_px)
    metrics["ba_sec"] = time.perf_counter() - t0
    metrics["merged_tracks"] = merged.number_tracks()
    metrics["merged_cameras"] = merged.number_images()
    return merged, metrics
