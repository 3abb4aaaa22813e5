"""Loader base: image access with resolution capping, intrinsics, GT.

Port of gtsfm_tpu/loader/base.py: ``read_image`` (PIL, with EXIF), the
``max_resolution`` short-side rescale of images and of the intrinsics
(any calibration model), EXIF intrinsics when a loader has none,
``load_grayscale_batch`` padding to a common (H, W), ``get_gt_poses``,
``is_valid_pair`` (the retrievers' pair filter) and
``batch_calibrations``. Images are host numpy arrays (the detector takes a
padded numpy batch); poses and calibrations are port tensors on the CPU,
which the scene optimizer moves to its device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image as PILImage
from PIL.ExifTags import TAGS

from gtsfm_tpu_torch.common.image import Image, rgb_to_gray
from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
from gtsfm_tpu_torch.geometry.calibration import CALIBRATION_TYPES
from gtsfm_tpu_torch.utils.tracing import span

_EXIF_IFD = 0x8769  # the Exif sub-IFD: FocalLength and friends live there


def read_image(path: str) -> Image:
    """An image file as RGB uint8 with its EXIF tags by name."""
    with PILImage.open(path) as im:
        exif = {}
        raw = im.getexif()
        if raw:
            for tag_id, value in raw.items():
                exif[TAGS.get(tag_id, tag_id)] = value
            for tag_id, value in raw.get_ifd(_EXIF_IFD).items():
                exif[TAGS.get(tag_id, tag_id)] = value
        arr = np.asarray(im.convert("RGB"))
    return Image(value_array=arr, exif_data=exif, file_name=os.path.basename(path))


def _resize(arr: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    return np.asarray(PILImage.fromarray(arr).resize((new_w, new_h), PILImage.BILINEAR))


class LoaderBase:
    """Subclasses implement __len__, _get_image_full_res(i) -> Image,
    _get_intrinsics_full_res(i) -> a calibration or None (None: a
    Cal3Bundler from EXIF)
    and, where GT is known, get_camera_pose(i)."""

    def __init__(self, max_resolution: int = 760):
        self.max_resolution = max_resolution
        self._scale_cache: dict = {}

    def __len__(self) -> int:
        raise NotImplementedError

    def _get_image_full_res(self, index: int) -> Image:
        raise NotImplementedError

    def _get_intrinsics_full_res(self, index: int):
        raise NotImplementedError

    def get_camera_pose(self, index: int) -> Optional[SE3]:
        """GT pose wTi if known, else None."""
        return None

    def image_filename(self, index: int) -> str:
        return self._get_image_full_res(index).file_name

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        """Whether (idx1, idx2), idx1 < idx2, may be matched. Loaders with a
        temporal order or a benchmark pair list restrict this."""
        return 0 <= idx1 < idx2 < len(self)

    def valid_pairs(self) -> np.ndarray:
        """All loader-valid (i, j) pairs as an (E, 2) int array."""
        n = len(self)
        return np.array(
            [(i, j) for i in range(n) for j in range(i + 1, n) if self.is_valid_pair(i, j)],
            np.int32,
        ).reshape(-1, 2)

    def _scale_for(self, index: int, h: int, w: int) -> float:
        """Downscale factor so that the short side is <= max_resolution."""
        short = min(h, w)
        if short <= self.max_resolution:
            return 1.0
        return self.max_resolution / short

    def get_image(self, index: int) -> Image:
        with span("load.read", 1):
            img = self._get_image_full_res(index)
        s = self._scale_for(index, img.height, img.width)
        self._scale_cache[index] = s
        if s == 1.0:
            return img
        new_h, new_w = int(round(img.height * s)), int(round(img.width * s))
        with span("load.resize", 1):
            arr = _resize(img.value_array, new_h, new_w)
        return Image(value_array=arr, exif_data=img.exif_data, file_name=img.file_name)

    def get_camera_intrinsics(self, index: int):
        cal = self._get_intrinsics_full_res(index)
        if cal is None:
            img = self._get_image_full_res(index)
            f, u0, v0 = img.intrinsics_from_exif()
            cal = Cal3Bundler.create(f, 0.0, 0.0, u0, v0)
        s = self._scale_cache.get(index)
        if s is None:
            img = self._get_image_full_res(index)
            s = self._scale_for(index, img.height, img.width)
            self._scale_cache[index] = s
        if s == 1.0:
            return cal
        return _rescale_cal(cal, s)

    def load_grayscale_batch(self, indices=None, pad_to: Optional[tuple] = None):
        """-> (images f32 (B, H, W) in [0, 1] zero-padded to a common size,
        at least ``pad_to`` = (H, W) when given, list of (orig_h, orig_w))."""
        if indices is None:
            indices = range(len(self))
        with span("load", len(indices)):
            grays = []
            for i in indices:
                rgb = self.get_image(i).value_array
                with span("load.gray", 1):
                    grays.append(rgb_to_gray(rgb))
            sizes = [(g.shape[0], g.shape[1]) for g in grays]
            H = max(s[0] for s in sizes)
            W = max(s[1] for s in sizes)
            if pad_to is not None:
                H, W = max(H, pad_to[0]), max(W, pad_to[1])
            with span("load.pad", len(grays)):
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


def _rescale_cal(cal, s: float):
    """The calibration of an image downscaled by the factor s: focal
    lengths, skew and principal point scale, distortion does not."""
    if isinstance(cal, Cal3Bundler):
        return cal.replace(f=cal.f * s, u0=cal.u0 * s, v0=cal.v0 * s)
    if isinstance(cal, CALIBRATION_TYPES):
        return cal.replace(fx=cal.fx * s, fy=cal.fy * s, s=cal.s * s, u0=cal.u0 * s, v0=cal.v0 * s)
    raise ValueError(type(cal))


def batch_calibrations(cals):
    """Stack per-image calibrations of one model into one batched
    calibration."""
    t0 = type(cals[0])
    if not all(type(c) is t0 for c in cals):
        raise TypeError(f"mixed calibration types: {sorted({type(c).__name__ for c in cals})}")
    return t0(**{f.name: torch.stack([getattr(c, f.name) for c in cals]) for f in dataclasses.fields(t0)})
