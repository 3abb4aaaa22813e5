"""In-memory synthetic scene loader.

Port of gtsfm_tpu/loader/synthetic.py: ``spectral_ring_poses`` places the
cameras of a visibility graph on an inward-looking ring in Fiedler order,
and ``SyntheticSceneLoader`` serves in-memory GT poses, calibrations and
flat gray images (the detector slot supplies the keypoints).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
from gtsfm_tpu_torch.loader.base import LoaderBase


def spectral_ring_poses(
    edges: np.ndarray,
    num_images: int,
    ring_radius: float = 20.0,
    z_noise: float = 0.5,
    seed: int = 0,
    device=None,
) -> SE3:
    """GT camera ring ordered by the graph's Fiedler vector (host numpy,
    the same arithmetic as the reference)."""
    n = num_images
    A = np.zeros((n, n), np.float64)
    e = np.asarray(edges, np.int64)
    A[e[:, 0], e[:, 1]] = 1.0
    A[e[:, 1], e[:, 0]] = 1.0
    L = np.diag(A.sum(1)) - A
    _, vecs = np.linalg.eigh(L)
    order = np.argsort(vecs[:, 1])
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)

    rng = np.random.default_rng(seed)
    ang = 2.0 * np.pi * rank / n
    centers = np.stack(
        [ring_radius * np.cos(ang), ring_radius * np.sin(ang), rng.normal(0.0, z_noise, n)],
        axis=1,
    ).astype(np.float32)
    Rs = []
    for c in centers:
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        Rs.append(np.stack([x, np.cross(z, x), z], axis=1))
    return SE3(
        R=torch.as_tensor(np.stack(Rs).astype(np.float32), device=device),
        t=torch.as_tensor(centers, device=device),
    )


class SyntheticSceneLoader(LoaderBase):
    """LoaderBase over in-memory GT poses/calibrations (no files on disk)."""

    def __init__(
        self,
        poses: SE3,
        cal: Optional[Cal3Bundler] = None,
        image_size: Tuple[int, int] = (480, 640),
        names: Optional[Sequence[str]] = None,
    ):
        self._poses = poses
        self._n = int(poses.t.shape[0])
        h, w = image_size
        if cal is None:
            n = self._n
            cal = Cal3Bundler.create(
                torch.full((n,), 600.0), torch.zeros(n), torch.zeros(n),
                torch.full((n,), w / 2.0), torch.full((n,), h / 2.0), device=poses.t.device,
            )
        self._cal = cal
        self._hw = (h, w)
        self._names = list(names) if names is not None else [
            f"synthetic_{i:04d}.jpg" for i in range(self._n)
        ]

    def __len__(self) -> int:
        return self._n

    def get_image(self, index: int) -> np.ndarray:
        h, w = self._hw
        return np.full((h, w), 128, np.uint8)

    def get_camera_intrinsics(self, index: int) -> Cal3Bundler:
        return self._cal.map(lambda a: a[index])

    def get_camera_pose(self, index: int) -> Optional[SE3]:
        return self._poses[index]

    def get_gt_poses(self) -> SE3:
        return self._poses

    def image_filename(self, index: int) -> str:
        return self._names[index]
