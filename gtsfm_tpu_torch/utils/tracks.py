"""Track classification against ground truth.

Port of gtsfm_tpu/utils/tracks.py: a 2D track is correct when one point,
triangulated by DLT from the GT cameras, reprojects within the threshold
in every one of its views. All tracks are solved together on the device of
the GT poses.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch.bundle.triangulation import _dehomogenize, _dlt_normal_matrix
from gtsfm_tpu_torch.geometry import SE3
from gtsfm_tpu_torch.utils.numerics import eigh, precise


def classify_tracks_by_gt(gt_poses: SE3, cal, track_cam: np.ndarray, track_uv: np.ndarray,
                          track_mask: np.ndarray, reproj_threshold_px: float = 3.0) -> tuple:
    """track_cam (T, K), track_uv (T, K, 2), track_mask (T, K), host numpy.
    Returns (correct bool (T,), per-observation pixel errors (T, K), NaN
    where masked)."""
    dev = gt_poses.t.device
    cam = torch.as_tensor(np.asarray(track_cam), dtype=torch.int64, device=dev)
    mask = torch.as_tensor(np.asarray(track_mask), device=dev)
    with precise():
        cal_m = cal.map(lambda a: a[cam])
        xy = cal_m.calibrate(torch.as_tensor(np.asarray(track_uv), dtype=torch.float32, device=dev))
        poses = gt_poses.map(lambda a: a[cam])  # (T, K)
        R_cw = poses.R.transpose(-1, -2)
        t_cw = -torch.einsum("...ij,...j->...i", R_cw, poses.t)
        _, vecs = eigh(_dlt_normal_matrix(R_cw, t_cw, xy, mask))
        X = _dehomogenize(vecs[..., :, 0])  # (T, 3)
        p_cam = torch.einsum("tkji,tkj->tki", poses.R, X[:, None, :] - poses.t)  # R^T (X - t)
        z = torch.clamp(p_cam[..., 2], min=1e-9)
        err_norm = torch.linalg.vector_norm(p_cam[..., :2] / z[..., None] - xy, dim=-1)
    err_px = err_norm.cpu().numpy() * cal_m.fx.cpu().numpy()
    valid_obs = np.asarray(track_mask)
    ok_obs = (err_px < reproj_threshold_px) & (p_cam[..., 2].cpu().numpy() > 0)
    correct = np.all(ok_obs | ~valid_obs, axis=1) & (valid_obs.sum(axis=1) >= 2)
    return correct, np.where(valid_obs, err_px, np.nan)


def tracks_from_sfm_data(data, gt_poses: SE3, max_obs_per_track: int = 12, reproj_threshold_px: float = 3.0):
    """classify_tracks_by_gt over an SfmData's flat measurements, as
    track-major (T, K) arrays (K = max_obs_per_track; observations past K
    are dropped), for every valid track. Returns (correct bool (T_valid,),
    per-observation errors (T_valid, K))."""
    mm = data.meas_mask.cpu().numpy()
    mc = data.meas_cam.cpu().numpy()[mm]
    mt = data.meas_track.cpu().numpy()[mm]
    uv = data.meas_uv.cpu().numpy()[mm]
    tmask = data.track_mask.cpu().numpy()
    valid_tracks = np.flatnonzero(tmask)
    remap = np.full(len(tmask), -1, np.int64)
    remap[valid_tracks] = np.arange(len(valid_tracks))
    T, K = len(valid_tracks), max_obs_per_track
    track_cam = np.zeros((T, K), np.int64)
    track_uv = np.zeros((T, K, 2), np.float32)
    track_m = np.zeros((T, K), bool)
    fill = np.zeros(T, np.int64)
    for m in range(len(mc)):
        t = remap[mt[m]]
        if t < 0 or fill[t] >= K:
            continue
        track_cam[t, fill[t]] = mc[m]
        track_uv[t, fill[t]] = uv[m]
        track_m[t, fill[t]] = True
        fill[t] += 1
    return classify_tracks_by_gt(gt_poses, data.cal, track_cam, track_uv, track_m,
                                 reproj_threshold_px=reproj_threshold_px)
