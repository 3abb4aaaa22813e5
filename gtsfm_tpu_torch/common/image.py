"""Host-side image container with EXIF-based intrinsics inference.

Port of gtsfm_tpu/common/image.py (``Image`` with its EXIF focal length and
intrinsics and its patch extraction, ``rgb_to_gray``). Images stay host
numpy until the detector takes a padded batch to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gtsfm_tpu_torch.common.sensor_db import SENSOR_WIDTHS_MM

DEFAULT_FOCAL_RATIO = 1.2  # focal ~ 1.2 * max(h, w) when EXIF is absent


@dataclasses.dataclass
class Image:
    value_array: np.ndarray  # (H, W, 3) uint8 or (H, W) grayscale
    exif_data: Optional[dict] = None
    file_name: Optional[str] = None
    mask: Optional[np.ndarray] = None  # (H, W) bool, True = use pixel

    @property
    def height(self) -> int:
        return self.value_array.shape[0]

    @property
    def width(self) -> int:
        return self.value_array.shape[1]

    @property
    def shape(self):
        return self.value_array.shape

    def focal_length_from_exif(self) -> Optional[float]:
        """Focal length in pixels from EXIF, else None: from
        FocalLengthIn35mmFilm (f35 / the 35 mm diagonal * the image
        diagonal), else from FocalLength and the camera model's sensor
        width."""
        if not self.exif_data:
            return None
        max_size = max(self.height, self.width)
        f35 = self.exif_data.get("FocalLengthIn35mmFilm")
        if f35 and f35 > 0:
            return float(f35) * np.hypot(self.width, self.height) / np.hypot(36.0, 24.0)
        focal_mm = self.exif_data.get("FocalLength")
        if not focal_mm or focal_mm <= 0:
            return None
        make = (self.exif_data.get("Make") or "").strip().lower()
        model = (self.exif_data.get("Model") or "").strip().lower()
        for key in (f"{make} {model}".strip(), model):
            sensor_mm = SENSOR_WIDTHS_MM.get(key)
            if sensor_mm:
                return float(focal_mm) / sensor_mm * max_size
        return None

    def intrinsics_from_exif(self) -> tuple:
        """(f, u0, v0) from EXIF, or the default focal-ratio prior, with
        the principal point at the image center."""
        f = self.focal_length_from_exif()
        if f is None:
            f = DEFAULT_FOCAL_RATIO * max(self.height, self.width)
        return float(f), self.width / 2.0, self.height / 2.0

    def extract_patch(self, x: int, y: int, size: int) -> np.ndarray:
        """The size x size patch centered at (x, y), zero-padded past the
        borders."""
        half = size // 2
        h, w = self.height, self.width
        patch = np.zeros((size, size) + self.value_array.shape[2:], dtype=self.value_array.dtype)
        y0, y1 = max(0, y - half), min(h, y - half + size)
        x0, x1 = max(0, x - half), min(w, x - half + size)
        py0 = y0 - (y - half)
        px0 = x0 - (x - half)
        patch[py0 : py0 + (y1 - y0), px0 : px0 + (x1 - x0)] = self.value_array[y0:y1, x0:x1]
        return patch


def rgb_to_gray(value_array: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """ITU-R BT.601 luma, float32 in [0, 1]; written into ``out``, a float32
    (H, W) array or view, where given. Every pixel goes through the same
    float32 operations in the same order as ``x = value_array.astype(
    float32)``, ``x / 255`` where ``x.max() > 1.5``, then ``r * 0.299 + g *
    0.587 + b * 0.114``, so the bits are those. A uint8 colour image is
    taken one channel at a time, with no float32 copy of all three."""
    arr = np.asarray(value_array)
    if arr.dtype == np.uint8 and arr.ndim == 3:
        scaled = arr.max() > 1  # exact in uint8: the float test's > 1.5
        out = np.empty(arr.shape[:2], np.float32) if out is None else out
        plane = np.empty(arr.shape[:2], np.float32)
        for c, weight in enumerate((0.299, 0.587, 0.114)):
            dst = plane if c else out
            if scaled:
                np.divide(arr[..., c], 255.0, out=dst, dtype=np.float32)
            else:
                dst[...] = arr[..., c]
            np.multiply(dst, weight, out=dst)
            if c:
                out += plane
        return out
    arr = arr.astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    gray = arr if arr.ndim == 2 else arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114
    if out is None:
        return gray
    out[...] = gray
    return out
