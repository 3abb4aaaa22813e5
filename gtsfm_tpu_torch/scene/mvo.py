"""MultiViewOptimizer: the global back-end chain for one cluster.

Port of gtsfm_tpu/scene/mvo.py: two-pass cycle-consistency view-graph
filtering -> largest connected component -> rotation averaging -> DSF
tracks -> translation averaging (with camera->track directions) ->
RANSAC-DLT triangulation -> staged dense-Schur bundle adjustment.

Host-only stages reuse the reference's numpy modules (cycle consistency,
graph utilities, DSF track linking). Numeric stages run on the device of
the two-view results; the data-dependent track and measurement axes are
padded to power-of-two buckets as in the reference.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gtsfm_tpu.tracks.dsf import tracks_from_matches
from gtsfm_tpu.utils.graph import largest_connected_component
from gtsfm_tpu.view_graph.cycle_consistency import (
    CycleConsistencyFilter,
    EdgeErrorAggregation,
    ViewGraphOptions,
)
from gtsfm_tpu_torch.averaging.rotation.averaging import RotationAveraging, RotationAveragingOptions
from gtsfm_tpu_torch.averaging.translation.averaging import (
    TranslationAveraging,
    TranslationAveragingOptions,
    camera_track_directions,
    select_tracks_for_coverage,
)
from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment
from gtsfm_tpu_torch.bundle.triangulation import triangulate_tracks
from gtsfm_tpu_torch.common.sfm_data import SceneMeta, SfmData
from gtsfm_tpu_torch.geometry import SE3
from gtsfm_tpu_torch.utils.numerics import ceil_pow2


class MVOOptions(NamedTuple):
    view_graph: ViewGraphOptions = ViewGraphOptions()
    rotation: RotationAveragingOptions = RotationAveragingOptions()
    translation: TranslationAveragingOptions = TranslationAveragingOptions()
    ba: BAOptions = BAOptions(max_iterations=30)
    reproj_thresholds: tuple = (10.0, 5.0, 3.0)
    min_track_len: int = 2
    max_track_len: int = 15
    triangulation_reproj_threshold_px: float = 10.0
    triangulation_hypotheses: int = 32
    min_triangulation_angle_deg: float = 1.0
    ta_tracks_per_camera: int = 12
    seed: int = 0


def _pad_rows(a: np.ndarray, rows: int, fill=0) -> np.ndarray:
    if rows == a.shape[0]:
        return a
    return np.concatenate([a, np.full((rows - a.shape[0],) + a.shape[1:], fill, a.dtype)])


class MultiViewOptimizer:
    def __init__(self, options: MVOOptions = MVOOptions()):
        self.options = options

    def run(
        self,
        num_images: int,
        pairs: np.ndarray,  # (E, 2)
        i2Ri1: torch.Tensor,  # (E, 3, 3)
        i2Ui1: torch.Tensor,  # (E, 3)
        pair_valid: np.ndarray,  # (E,)
        num_inliers: np.ndarray,  # (E,)
        corr_i1: np.ndarray,  # (E, K)
        corr_i2: np.ndarray,
        corr_mask: np.ndarray,
        keypoints_xy: np.ndarray,  # (N, K, 2)
        cal,  # Cal3Bundler [N]
        meta: Optional[SceneMeta] = None,
    ) -> tuple:
        """-> (SfmData, metrics dict)."""
        opts = self.options
        dev = i2Ri1.device
        metrics: dict = {}
        t_start = time.perf_counter()
        pairs = np.asarray(pairs, np.int64)
        edge_mask = np.asarray(pair_valid, bool).copy()
        metrics["num_input_edges"] = int(edge_mask.sum())
        i2Ri1_np = i2Ri1.cpu().numpy()

        t0 = time.perf_counter()
        for agg in (EdgeErrorAggregation.MIN, EdgeErrorAggregation.MEDIAN):
            f = CycleConsistencyFilter(ViewGraphOptions(
                max_cycle_error_deg=opts.view_graph.max_cycle_error_deg, aggregation=agg,
            ))
            edge_mask, _ = f.run(pairs, i2Ri1_np, edge_mask)
        metrics["num_edges_after_cycle_filter"] = int(edge_mask.sum())
        metrics["view_graph_sec"] = time.perf_counter() - t0

        cc_mask = largest_connected_component(num_images, pairs[edge_mask])
        edge_mask &= cc_mask[pairs[:, 0]] & cc_mask[pairs[:, 1]]
        metrics["num_cameras_largest_cc"] = int(cc_mask.sum())
        if edge_mask.sum() < 1 or cc_mask.sum() < 2:
            return SfmData.empty(num_images, meta=meta, device=dev), {**metrics, "failed": True}

        t0 = time.perf_counter()
        wRi, rot_valid = RotationAveraging(opts.rotation).run(
            num_images, pairs, i2Ri1, num_inliers=np.asarray(num_inliers), edge_mask=edge_mask,
        )
        metrics["rotation_averaging_sec"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        cmask = np.asarray(corr_mask) & edge_mask[:, None]
        track_cam, track_kp, track_uv, track_mask = tracks_from_matches(
            pairs, corr_i1, corr_i2, cmask, np.asarray(keypoints_xy),
            min_track_len=opts.min_track_len, max_track_len=opts.max_track_len,
        )
        metrics["num_tracks_2d"] = int((track_mask.sum(1) >= 2).sum())
        metrics["dsf_sec"] = time.perf_counter() - t0

        T_pad = ceil_pow2(track_cam.shape[0], 16)
        track_cam = _pad_rows(track_cam, T_pad)
        track_kp = _pad_rows(track_kp, T_pad)
        track_uv = _pad_rows(track_uv, T_pad)
        track_mask = _pad_rows(track_mask, T_pad)

        t0 = time.perf_counter()
        track_dirs = None
        if opts.ta_tracks_per_camera > 0:
            sel = select_tracks_for_coverage(track_cam, track_mask, num_images, opts.ta_tracks_per_camera)
            if len(sel) >= 3:
                cams_d, nodes_d, dirs_d = camera_track_directions(
                    wRi, cal, track_cam, track_uv, track_mask, sel
                )
                # pad with weight-0 entries anchored to a sentinel node
                S_pad = ceil_pow2(len(sel), 8)
                A_raw = len(cams_d)
                padn = ceil_pow2(A_raw + 1, 8) - A_raw
                track_dirs = (
                    np.concatenate([cams_d, np.zeros(padn, np.int32)]),
                    np.concatenate([nodes_d, np.full(padn, S_pad - 1, np.int32)]),
                    np.concatenate([dirs_d, np.tile(np.float32([[0, 0, 1]]), (padn, 1))]),
                    np.concatenate([np.ones(A_raw, np.float32), np.zeros(padn, np.float32)]),
                )
        wti, trans_valid, ta_inlier_mask = TranslationAveraging(opts.translation).run(
            num_images, pairs, i2Ui1, wRi, edge_mask=edge_mask, seed=opts.seed,
            track_dirs=track_dirs,
        )
        metrics["translation_averaging_sec"] = time.perf_counter() - t0
        metrics["num_edges_after_1dsfm"] = int(ta_inlier_mask.sum())

        cam_valid = rot_valid & trans_valid
        metrics["num_cameras_estimated"] = int(cam_valid.sum())
        if cam_valid.sum() < 2:
            return SfmData.empty(num_images, meta=meta, device=dev), {**metrics, "failed": True}
        poses = SE3(R=wRi.to(torch.float32), t=wti.to(torch.float32))

        t0 = time.perf_counter()
        track_mask = track_mask & cam_valid[track_cam]
        points, tri_inliers, tri_ok = triangulate_tracks(
            poses, cal,
            torch.as_tensor(track_cam, dtype=torch.int64, device=dev),
            torch.as_tensor(track_uv, device=dev),
            torch.as_tensor(track_mask, device=dev),
            reproj_threshold_px=opts.triangulation_reproj_threshold_px,
            num_hypotheses=opts.triangulation_hypotheses,
            min_triangulation_angle_deg=opts.min_triangulation_angle_deg,
            seed=opts.seed,
        )
        tri_inliers = tri_inliers.cpu().numpy() & track_mask
        tri_ok = tri_ok.cpu().numpy() & (tri_inliers.sum(1) >= opts.min_track_len)
        metrics["num_tracks_triangulated"] = int(tri_ok.sum())
        metrics["triangulation_sec"] = time.perf_counter() - t0

        obs_t, obs_k = np.nonzero(tri_inliers & tri_ok[:, None])
        meas_cam = track_cam[obs_t, obs_k].astype(np.int64)
        meas_kp = track_kp[obs_t, obs_k].astype(np.int32)
        meas_uv = track_uv[obs_t, obs_k].astype(np.float32)
        M_raw = len(obs_t)
        M_pad = ceil_pow2(M_raw, 16)
        meas_mask = np.arange(M_pad) < M_raw
        data = SfmData(
            poses=poses,
            cal=cal,
            pose_mask=torch.as_tensor(cam_valid, device=dev),
            points=points.to(torch.float32),
            track_mask=torch.as_tensor(tri_ok, device=dev),
            meas_cam=torch.as_tensor(_pad_rows(meas_cam, M_pad), device=dev),
            meas_track=torch.as_tensor(_pad_rows(obs_t.astype(np.int64), M_pad), device=dev),
            meas_uv=torch.as_tensor(_pad_rows(meas_uv, M_pad), device=dev),
            meas_mask=torch.as_tensor(meas_mask, device=dev),
            meta=meta,
        )
        if M_raw == 0:
            return data, {**metrics, "failed": True}

        t0 = time.perf_counter()
        # gauge: freeze the estimated camera with most measurements
        counts = np.bincount(meas_cam, minlength=num_images) * cam_valid
        fixed = np.zeros(num_images, bool)
        fixed[np.argsort(-counts)[:1]] = True
        data, ba_metrics = BundleAdjustment(opts.ba).run_staged(
            data, reproj_thresholds=opts.reproj_thresholds,
            fixed_cam=torch.as_tensor(fixed, device=dev),
        )
        metrics["ba_sec"] = time.perf_counter() - t0
        metrics["ba_stages"] = ba_metrics
        metrics["num_tracks_final"] = data.number_tracks()
        metrics["num_measurements_final"] = data.number_measurements()
        mean_len, med_len = data.track_length_stats()
        metrics["mean_track_length"] = mean_len
        metrics["median_track_length"] = med_len
        err = data.reprojection_errors().cpu().numpy()
        msk = data.meas_mask.cpu().numpy()
        if msk.any():
            metrics["reproj_error_median_px"] = float(np.median(err[msk]))
            metrics["reproj_error_mean_px"] = float(np.mean(err[msk][np.isfinite(err[msk])]))
        metrics["total_sec"] = time.perf_counter() - t_start
        metrics["aux"] = {"meas_kp": meas_kp, "meas_cam": meas_cam.astype(np.int32),
                          "meas_track": obs_t.astype(np.int32)}
        return data, metrics
