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
Compaction, the largest component and downsampling are host numpy, their
results put back on the scene's device.
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

    @property
    def max_measurements(self) -> int:
        return self.meas_mask.shape[0]

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

    def compact(self) -> "SfmData":
        """Tracks and measurements compacted to the live ones (host);
        cameras stay, their indexing is positional."""
        tm = self.track_mask.cpu().numpy()
        meas_track = self.meas_track.cpu().numpy()
        keep_meas = self.meas_mask.cpu().numpy() & tm[meas_track]
        track_old2new = np.cumsum(tm) - 1
        dev = self.points.device
        return SfmData(
            poses=self.poses,
            cal=self.cal,
            pose_mask=self.pose_mask,
            points=torch.as_tensor(self.points.cpu().numpy()[tm], device=dev),
            track_mask=torch.ones(int(tm.sum()), dtype=torch.bool, device=dev),
            meas_cam=torch.as_tensor(self.meas_cam.cpu().numpy()[keep_meas], device=dev),
            meas_track=torch.as_tensor(track_old2new[meas_track[keep_meas]], device=dev),
            meas_uv=torch.as_tensor(self.meas_uv.cpu().numpy()[keep_meas], device=dev),
            meas_mask=torch.ones(int(keep_meas.sum()), dtype=torch.bool, device=dev),
            meta=self.meta,
        )

    def select_largest_connected_component(self) -> "SfmData":
        """Keep the cameras of the largest component of the co-observation
        graph (two cameras connect when they see one track), their
        measurements and the tracks left with two or more (host
        union-find, the reference's order)."""
        n = self.max_cameras
        parent = np.arange(n)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        meas_cam = self.meas_cam.cpu().numpy()
        meas_track = self.meas_track.cpu().numpy()
        mm_ = self.meas_mask.cpu().numpy()
        order = np.argsort(meas_track[mm_], kind="stable")
        cams = meas_cam[mm_][order]
        tracks = meas_track[mm_][order]
        for i in range(1, len(cams)):
            if tracks[i] == tracks[i - 1]:
                ra, rb = find(cams[i]), find(cams[i - 1])
                if ra != rb:
                    parent[ra] = rb
        pose_mask = self.pose_mask.cpu().numpy()
        roots = np.array([find(i) if pose_mask[i] else -1 for i in range(n)])
        valid_roots = roots[roots >= 0]
        if valid_roots.size == 0:
            return self
        keep_cam = (roots == np.bincount(valid_roots).argmax()) & pose_mask
        keep_meas = mm_ & keep_cam[meas_cam]
        counts = np.zeros(self.max_tracks, np.int64)
        np.add.at(counts, meas_track[keep_meas], 1)
        keep_track = self.track_mask.cpu().numpy() & (counts >= 2)
        keep_meas = keep_meas & keep_track[meas_track]
        dev = self.pose_mask.device
        return self.replace(
            pose_mask=torch.as_tensor(keep_cam, device=dev),
            track_mask=torch.as_tensor(keep_track, device=dev),
            meas_mask=torch.as_tensor(keep_meas, device=dev),
        )

    def downsample(self, max_tracks: int, seed: int = 0) -> "SfmData":
        """A random subset of max_tracks live tracks (host), drawn by
        numpy's ``default_rng(seed)`` as the reference draws it."""
        alive = np.nonzero(self.track_mask.cpu().numpy())[0]
        if len(alive) <= max_tracks:
            return self
        keep = np.zeros(self.max_tracks, bool)
        keep[np.random.default_rng(seed).permutation(alive)[:max_tracks]] = True
        keep_t = torch.as_tensor(keep, device=self.track_mask.device)
        return self.replace(track_mask=keep_t, meas_mask=self.meas_mask & keep_t[self.meas_track])

    @classmethod
    def from_cameras_and_tracks(
        cls,
        poses: SE3,
        cal,
        tracks,
        num_cameras: Optional[int] = None,
        pose_mask: Optional[np.ndarray] = None,
        meta: Optional[SceneMeta] = None,
        pad_tracks_to: Optional[int] = None,
        pad_meas_to: Optional[int] = None,
    ) -> "SfmData":
        """Host-side builder on the poses' device. tracks: a sequence of
        (point_xyz, [(cam_idx, uv), ...]); every camera is marked posed
        unless ``pose_mask`` says otherwise. ``pad_tracks_to`` and
        ``pad_meas_to`` pad the track and measurement arrays (masked)."""
        n = num_cameras if num_cameras is not None else poses.t.shape[0]
        t = len(tracks)
        points = np.zeros((max(t, 1), 3), np.float32)
        mc, mt, muv = [], [], []
        for j, (xyz, obs) in enumerate(tracks):
            points[j] = xyz
            for cam_idx, uv in obs:
                mc.append(cam_idx)
                mt.append(j)
                muv.append(uv)
        m = len(mc)
        T = pad_tracks_to or max(t, 1)
        M = pad_meas_to or max(m, 1)
        if T < t or M < m:
            raise ValueError(f"pad_tracks_to={T} / pad_meas_to={M} below {t} tracks / {m} measurements")
        if T > len(points):
            points = np.concatenate([points, np.zeros((T - len(points), 3), np.float32)])
        meas_cam = np.zeros(M, np.int64)
        meas_track = np.zeros(M, np.int64)
        meas_uv = np.zeros((M, 2), np.float32)
        meas_cam[:m] = mc
        meas_track[:m] = mt
        if muv:
            meas_uv[:m] = np.asarray(muv, np.float32)
        if pose_mask is None:
            pose_mask = np.ones(n, bool)
        dev = poses.t.device
        return cls(
            poses=poses,
            cal=cal,
            pose_mask=torch.as_tensor(np.asarray(pose_mask, bool), device=dev),
            points=torch.as_tensor(points[:T], device=dev),
            track_mask=torch.as_tensor(np.arange(T) < t, device=dev),
            meas_cam=torch.as_tensor(meas_cam, device=dev),
            meas_track=torch.as_tensor(meas_track, device=dev),
            meas_uv=torch.as_tensor(meas_uv, device=dev),
            meas_mask=torch.as_tensor(np.arange(M) < m, device=dev),
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
