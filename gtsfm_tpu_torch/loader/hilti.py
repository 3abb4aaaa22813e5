"""Hilti SLAM multi-camera rig loader.

Port of gtsfm_tpu/loader/hilti.py: a 5-camera rig with Kalibr camchain
calibration YAMLs. Image i belongs to rig timestamp i // cams_per_rig and
physical camera i % cams_per_rig. ``get_rig_constraints()`` gives the
intra-rig between-factors (rel_edges, rel_meas, rel_weight) that
BundleAdjustment takes.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch
import yaml

from gtsfm_tpu_torch.geometry import SE3, Cal3_S2
from gtsfm_tpu_torch.loader.base import LoaderBase, read_image


def _load_camchain(calib_dir: str) -> dict:
    """Kalibr camchain YAMLs -> {camera index: (T_cam_imu 4x4, intrinsics,
    resolution)}, cameras numbered in the order of the files and their
    keys."""
    cams = {}
    next_idx = 0
    for path in sorted(glob.glob(os.path.join(calib_dir, "*camchain-imucam.yaml"))):
        with open(path) as f:
            chain = yaml.safe_load(f)
        for key in sorted(chain.keys()):
            c = chain[key]
            cams[next_idx] = (np.asarray(c["T_cam_imu"], np.float64), c.get("intrinsics"),
                              c.get("resolution", [1440, 1080]))
            next_idx += 1
    return cams


class HiltiLoader(LoaderBase):
    def __init__(self, base_folder: str, max_resolution: int = 760, max_frames: Optional[int] = None,
                 cams_per_rig: Optional[int] = None):
        super().__init__(max_resolution=max_resolution)
        self.base_folder = base_folder
        paths = glob.glob(os.path.join(base_folder, "images", "*.jpg"))
        # numeric order: 0.jpg, 1.jpg, ...
        self._image_paths = sorted(paths, key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))
        if max_frames:
            self._image_paths = self._image_paths[:max_frames]
        self._calib = _load_camchain(os.path.join(base_folder, "calibration"))
        self.cams_per_rig = cams_per_rig or max(len(self._calib), 1)

    def __len__(self) -> int:
        return len(self._image_paths)

    def rig_index(self, index: int) -> int:
        return index // self.cams_per_rig

    def camera_index(self, index: int) -> int:
        return index % self.cams_per_rig

    def _get_image_full_res(self, index: int):
        return read_image(self._image_paths[index])

    def _get_intrinsics_full_res(self, index: int):
        cam = self._calib.get(self.camera_index(index))
        if cam is None or cam[1] is None:
            return None
        fx, fy, cx, cy = cam[1][:4]
        return Cal3_S2.create(float(fx), float(fy), 0.0, float(cx), float(cy))

    def get_camera_pose(self, index: int):
        return None  # no GT world poses; the rig's relative poses come from the calibration

    def relative_pose_in_rig(self, cam_a: int, cam_b: int) -> SE3:
        """bTa between two physical cameras: T_b_imu (T_a_imu)^-1."""
        M = self._calib[cam_b][0] @ np.linalg.inv(self._calib[cam_a][0])
        return SE3(R=torch.as_tensor(M[:3, :3], dtype=torch.float32), t=torch.as_tensor(M[:3, 3], dtype=torch.float32))

    def get_rig_constraints(self, weight: float = 1e4):
        """Between-factors for every pair of images of one rig timestamp:
        (rel_edges (F, 2), rel_meas SE3 [F] holding bTa for the edge (a, b),
        rel_weight (F,))."""
        edges, Rs, ts = [], [], []
        n = len(self)
        for i in range(n):
            for j in range(i + 1, n):
                if self.rig_index(i) != self.rig_index(j):
                    continue
                rel = self.relative_pose_in_rig(self.camera_index(i), self.camera_index(j))
                edges.append((i, j))
                Rs.append(rel.R.numpy())
                ts.append(rel.t.numpy())
        if not edges:
            return np.zeros((1, 2), np.int32), SE3.identity((1,)), np.zeros(1, np.float32)
        return (np.asarray(edges, np.int32), SE3(R=torch.as_tensor(np.stack(Rs)), t=torch.as_tensor(np.stack(ts))),
                np.full(len(edges), weight, np.float32))
