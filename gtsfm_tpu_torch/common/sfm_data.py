"""SfmData — the scene container, a padded struct of tensors.

Port of gtsfm_tpu/common/sfm_data.py:

  poses       SE3 [N]         camera poses wTi (identity where absent)
  cal         a calibration model [N] (any of geometry.CALIBRATION_TYPES)
  pose_mask   bool [N]
  points      f32 [T, 3]
  track_mask  bool [T]
  meas_cam    i64 [M]         measurement -> camera index
  meas_track  i64 [M]         measurement -> track index
  meas_uv     f32 [M, 2]
  meas_mask   bool [M]

Filtering is a mask update on the device; padded shapes never change.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler, PinholeCamera
from gtsfm_tpu_torch.geometry.sim3 import Sim3
from gtsfm_tpu_torch.utils.numerics import TensorStruct


@dataclasses.dataclass
class SceneMeta:
    """Static scene metadata."""

    image_names: Optional[list] = None
    image_sizes: Optional[list] = None  # (width, height) per image


@dataclasses.dataclass(frozen=True)
class SfmData(TensorStruct):
    poses: SE3
    cal: Any
    pose_mask: torch.Tensor
    points: torch.Tensor
    track_mask: torch.Tensor
    meas_cam: torch.Tensor
    meas_track: torch.Tensor
    meas_uv: torch.Tensor
    meas_mask: torch.Tensor
    meta: Optional[SceneMeta] = None

    @property
    def max_cameras(self) -> int:
        return self.pose_mask.shape[0]

    @property
    def max_tracks(self) -> int:
        return self.track_mask.shape[0]

    def number_images(self) -> int:
        return int(self.pose_mask.sum())

    def number_tracks(self) -> int:
        return int(self.track_mask.sum())

    def number_measurements(self) -> int:
        return int(self.meas_mask.sum())

    def cameras(self) -> PinholeCamera:
        return PinholeCamera(pose=self.poses, cal=self.cal)

    def track_lengths(self) -> torch.Tensor:
        """Valid measurement count per track, i64 [T]."""
        out = torch.zeros(self.max_tracks, dtype=torch.int64, device=self.meas_mask.device)
        return out.index_add_(0, self.meas_track, self.meas_mask.to(torch.int64))

    def reprojection_errors(self) -> torch.Tensor:
        """Pixel reprojection error per measurement, inf where the
        measurement is masked out or behind its camera."""
        cam = self.cameras().map(lambda a: a[self.meas_cam])
        uv, depth = cam.project(self.points[self.meas_track])
        err = torch.linalg.vector_norm(uv - self.meas_uv, dim=-1)
        bad = (~self.meas_mask) | (depth <= 0)
        return torch.where(bad, torch.full_like(err, float("inf")), err)

    def filter_by_reprojection_error(self, thresh: float, min_track_len: int = 2) -> "SfmData":
        """Mask out measurements with error > thresh, then tracks with fewer
        than min_track_len surviving measurements."""
        new_meas = self.meas_mask & (self.reprojection_errors() <= thresh)
        counts = torch.zeros(self.max_tracks, dtype=torch.int64, device=new_meas.device)
        counts.index_add_(0, self.meas_track, new_meas.to(torch.int64))
        new_track = self.track_mask & (counts >= min_track_len)
        return self.replace(meas_mask=new_meas & new_track[self.meas_track], track_mask=new_track)

    def filter_by_track_length(self, min_track_len: int) -> "SfmData":
        """Mask out tracks with fewer than min_track_len valid measurements,
        and their measurements."""
        new_track = self.track_mask & (self.track_lengths() >= min_track_len)
        return self.replace(track_mask=new_track, meas_mask=self.meas_mask & new_track[self.meas_track])

    def transform(self, sim: Sim3) -> "SfmData":
        """Apply a Sim3 to poses and points."""
        return self.replace(poses=sim.transform_pose(self.poses), points=sim.transform(self.points))

    def track_length_stats(self) -> tuple:
        """(mean, median) track length over valid tracks."""
        vals = self.track_lengths()[self.track_mask].cpu().numpy()
        if vals.size == 0:
            return 0.0, 0.0
        return float(np.mean(vals)), float(np.median(vals))

    @classmethod
    def from_cameras_and_tracks(cls, poses: SE3, cal, tracks, num_cameras: Optional[int] = None,
                                meta: Optional[SceneMeta] = None) -> "SfmData":
        """Host-side builder on the poses' device. tracks: a sequence of
        (point_xyz, [(cam_idx, uv), ...]); every camera is marked posed."""
        n = num_cameras if num_cameras is not None else poses.t.shape[0]
        T = max(len(tracks), 1)
        points = np.zeros((T, 3), np.float32)
        mc, mt, muv = [], [], []
        for j, (xyz, obs) in enumerate(tracks):
            points[j] = xyz
            for cam_idx, uv in obs:
                mc.append(cam_idx)
                mt.append(j)
                muv.append(uv)
        M = max(len(mc), 1)
        meas_cam = np.zeros(M, np.int64)
        meas_track = np.zeros(M, np.int64)
        meas_uv = np.zeros((M, 2), np.float32)
        meas_cam[: len(mc)] = mc
        meas_track[: len(mt)] = mt
        if muv:
            meas_uv[: len(muv)] = np.asarray(muv, np.float32)
        dev = poses.t.device
        return cls(
            poses=poses,
            cal=cal,
            pose_mask=torch.ones(n, dtype=torch.bool, device=dev),
            points=torch.as_tensor(points, device=dev),
            track_mask=torch.as_tensor(np.arange(T) < len(tracks), device=dev),
            meas_cam=torch.as_tensor(meas_cam, device=dev),
            meas_track=torch.as_tensor(meas_track, device=dev),
            meas_uv=torch.as_tensor(meas_uv, device=dev),
            meas_mask=torch.as_tensor(np.arange(M) < len(mc), device=dev),
            meta=meta,
        )

    @classmethod
    def empty(cls, num_cameras: int, meta: Optional[SceneMeta] = None, device=None) -> "SfmData":
        """A scene with no posed camera and no track; its calibration is a
        Cal3Bundler placeholder whatever the loader's model, as in the
        reference."""
        n = max(num_cameras, 1)
        z = torch.zeros(n, device=device)
        return cls(
            poses=SE3.identity((n,), device=device),
            cal=Cal3Bundler.create(torch.ones(n, device=device), z, z, z, z),
            pose_mask=torch.zeros(n, dtype=torch.bool, device=device),
            points=torch.zeros((1, 3), device=device),
            track_mask=torch.zeros(1, dtype=torch.bool, device=device),
            meas_cam=torch.zeros(1, dtype=torch.int64, device=device),
            meas_track=torch.zeros(1, dtype=torch.int64, device=device),
            meas_uv=torch.zeros((1, 2), device=device),
            meas_mask=torch.zeros(1, dtype=torch.bool, device=device),
            meta=meta,
        )
