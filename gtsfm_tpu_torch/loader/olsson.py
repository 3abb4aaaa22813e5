"""Olsson dataset loader: images/ plus data.mat with P matrices.

Port of gtsfm_tpu/loader/olsson.py. data.mat holds 3x4 projection matrices
P = K [R | t] (world -> camera); K, R and t come back by an RQ
decomposition, and the poses are stored as wTi.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import scipy.io
import scipy.linalg
import torch

from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
from gtsfm_tpu_torch.loader.base import LoaderBase, read_image


def _decompose_projection(P: np.ndarray) -> tuple:
    """P = K [R | t] -> (K (3, 3) upper triangular with K[2, 2] = 1, R with
    det(R) = +1, t)."""
    K, R = scipy.linalg.rq(P[:, :3])
    S = np.diag(np.sign(np.diag(K)))  # a positive diagonal of K
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        K = -K
        R = -R
    K = K / K[2, 2]
    t = np.linalg.solve(K, P[:, 3])
    return K, R, t


class OlssonLoader(LoaderBase):
    def __init__(self, folder: str, max_resolution: int = 760, max_frames: Optional[int] = None):
        super().__init__(max_resolution=max_resolution)
        self.folder = folder
        paths = []
        for ext in ("*.JPG", "*.jpg", "*.png", "*.jpeg"):
            paths += glob.glob(os.path.join(folder, "images", ext))
        self._image_paths = sorted(paths)
        if max_frames:
            self._image_paths = self._image_paths[:max_frames]

        self._K = None
        self._wTi = None
        mat_path = os.path.join(folder, "data.mat")
        if os.path.exists(mat_path):
            P = scipy.io.loadmat(mat_path)["P"]
            n = min(P.shape[1], len(self._image_paths))
            self._K, self._wTi = [], []
            for i in range(n):
                K, R_cw, t_cw = _decompose_projection(np.asarray(P[0, i], np.float64))
                self._K.append(K)
                # the stored pose is cTw: invert it to wTi
                self._wTi.append(SE3(R=torch.as_tensor(R_cw.T, dtype=torch.float32),
                                     t=torch.as_tensor(-R_cw.T @ t_cw, dtype=torch.float32)))

    def __len__(self) -> int:
        return len(self._image_paths)

    def _get_image_full_res(self, index: int):
        return read_image(self._image_paths[index])

    def image_filename(self, index: int) -> str:
        return os.path.basename(self._image_paths[index])

    def _get_intrinsics_full_res(self, index: int) -> Optional[Cal3Bundler]:
        if self._K is None:
            return None
        K = self._K[index]
        # fx ~ fy and a tiny skew: Cal3Bundler(f, 0, 0, u0, v0)
        f = 0.5 * (K[0, 0] + K[1, 1])
        return Cal3Bundler.create(float(f), 0.0, 0.0, float(K[0, 2]), float(K[1, 2]))

    def get_camera_pose(self, index: int) -> Optional[SE3]:
        if self._wTi is None:
            return None
        return self._wTi[index]
