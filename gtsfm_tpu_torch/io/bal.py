"""BAL (Bundle Adjustment in the Large) problem file reader.

Port of gtsfm_tpu/io/bal.py. BAL cameras look down -z with the projection
p = -P / P.z; the reader moves them to the +z-depth convention by
conjugating with F = diag(1, -1, -1) and negating each v measurement,
which keeps every reprojection error. Cameras are Cal3Bundler (f, k1, k2,
principal point 0). Host numpy; the scene comes back on the CPU.
"""

from __future__ import annotations

import bz2
import gzip

import numpy as np
import torch

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler, so3


def read_bal(path: str) -> SfmData:
    """A BAL problem (plain, .bz2 or .gz) as SfmData: every camera posed,
    every point a track, every observation a measurement."""
    opener = bz2.open if path.endswith(".bz2") else gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tokens = f.read().split()
    n_cam, n_pts, n_obs = int(tokens[0]), int(tokens[1]), int(tokens[2])
    obs = np.array(tokens[3 : 3 + 4 * n_obs], np.float64).reshape(n_obs, 4)
    meas_cam = obs[:, 0].astype(np.int64)
    meas_track = obs[:, 1].astype(np.int64)
    meas_uv = np.stack([obs[:, 2], -obs[:, 3]], -1).astype(np.float32)  # v flipped: see the module docstring
    o = 3 + 4 * n_obs
    cams = np.array(tokens[o : o + 9 * n_cam], np.float64).astype(np.float32).reshape(n_cam, 9)
    points = np.array(tokens[o + 9 * n_cam : o + 9 * n_cam + 3 * n_pts], np.float64).astype(np.float32)

    F = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    R_all = so3.expmap(torch.as_tensor(cams[:, :3])).numpy()
    Rs = np.zeros((n_cam, 3, 3), np.float32)
    ts = np.zeros((n_cam, 3), np.float32)
    for i in range(n_cam):
        R_cw = F @ R_all[i]
        t_cw = F @ cams[i, 3:6]
        Rs[i] = R_cw.T
        ts[i] = -R_cw.T @ t_cw
    z = torch.zeros(n_cam)
    return SfmData(
        poses=SE3(R=torch.as_tensor(Rs), t=torch.as_tensor(ts)),
        cal=Cal3Bundler.create(torch.as_tensor(cams[:, 6]), torch.as_tensor(cams[:, 7]),
                               torch.as_tensor(cams[:, 8]), z, z),
        pose_mask=torch.ones(n_cam, dtype=torch.bool),
        points=torch.as_tensor(points.reshape(n_pts, 3)),
        track_mask=torch.ones(n_pts, dtype=torch.bool),
        meas_cam=torch.as_tensor(meas_cam),
        meas_track=torch.as_tensor(meas_track),
        meas_uv=torch.as_tensor(meas_uv),
        meas_mask=torch.ones(n_obs, dtype=torch.bool),
    )
