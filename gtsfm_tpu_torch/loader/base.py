"""Loader base: image access and batched intrinsics.

Port of gtsfm_tpu/loader/base.py, the surface the reconstruction path uses:
``__len__``, ``get_all_intrinsics``, ``load_grayscale_batch``,
``get_gt_poses``, ``image_filenames``, ``is_valid_pair`` (the retrievers'
pair filter) and ``batch_calibrations``. Images are
host numpy arrays (the detector slot consumes numpy); poses and calibrations
are port tensors, and their device is the device the reconstruction runs on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler


def rgb_to_gray(value_array: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma, float32 in [0, 1] (the reference's
    common/image.py conversion)."""
    arr = np.asarray(value_array).astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.ndim == 2:
        return arr
    return arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114


class LoaderBase:
    """Subclasses implement __len__, get_image(i) -> uint8 numpy image,
    get_camera_intrinsics(i) and get_camera_pose(i). Resolution capping
    (the reference's ``max_resolution`` rescale) is not ported: the
    in-memory loaders serve images at their own size."""

    def __len__(self) -> int:
        raise NotImplementedError

    def get_image(self, index: int) -> np.ndarray:
        raise NotImplementedError

    def get_camera_intrinsics(self, index: int) -> Cal3Bundler:
        raise NotImplementedError

    def get_camera_pose(self, index: int) -> Optional[SE3]:
        return None

    def image_filename(self, index: int) -> str:
        return f"{index:04d}.jpg"

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        """Whether (idx1, idx2), idx1 < idx2, may be matched. Loaders with a
        temporal order or a benchmark pair list restrict this."""
        return 0 <= idx1 < idx2 < len(self)

    def load_grayscale_batch(self, indices=None):
        """-> (images f32 (B, H, W) in [0, 1] zero-padded to a common size,
        list of (orig_h, orig_w))."""
        if indices is None:
            indices = range(len(self))
        grays = [rgb_to_gray(self.get_image(i)) for i in indices]
        sizes = [(g.shape[0], g.shape[1]) for g in grays]
        H = max(s[0] for s in sizes)
        W = max(s[1] for s in sizes)
        batch = np.zeros((len(grays), H, W), np.float32)
        for b, g in enumerate(grays):
            batch[b, : g.shape[0], : g.shape[1]] = g
        return batch, sizes

    def get_all_intrinsics(self):
        return [self.get_camera_intrinsics(i) for i in range(len(self))]

    def get_gt_poses(self) -> Optional[SE3]:
        poses = [self.get_camera_pose(i) for i in range(len(self))]
        if any(p is None for p in poses):
            return None
        return SE3(R=torch.stack([p.R for p in poses]), t=torch.stack([p.t for p in poses]))

    def image_filenames(self):
        return [self.image_filename(i) for i in range(len(self))]


def batch_calibrations(cals) -> Cal3Bundler:
    """Stack per-image calibrations into one batched Cal3Bundler."""
    if not all(isinstance(c, Cal3Bundler) for c in cals):
        raise TypeError("only Cal3Bundler calibrations are ported")
    return Cal3Bundler(*(torch.stack([getattr(c, k) for c in cals]) for k in ("f", "k1", "k2", "u0", "v0")))
