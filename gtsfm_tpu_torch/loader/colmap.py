"""COLMAP-export loader: cameras.txt / images.txt (GT) plus an images
directory.

Port of gtsfm_tpu/loader/colmap.py, on the text readers of
``io/colmap.py``: intrinsics of any of the four calibration models, by the
camera's COLMAP model.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from gtsfm_tpu_torch.geometry import SE3
from gtsfm_tpu_torch.io import colmap as colmap_io
from gtsfm_tpu_torch.loader.base import LoaderBase, read_image


class ColmapLoader(LoaderBase):
    def __init__(
        self,
        colmap_files_dirpath: str,
        images_dir: str,
        max_resolution: int = 760,
        use_gt_intrinsics: bool = True,
        max_frames: Optional[int] = None,
    ):
        super().__init__(max_resolution=max_resolution)
        self.images_dir = images_dir
        self.use_gt_intrinsics = use_gt_intrinsics
        cams = colmap_io.read_cameras_txt(os.path.join(colmap_files_dirpath, "cameras.txt"))
        images = colmap_io.read_images_txt(os.path.join(colmap_files_dirpath, "images.txt"))
        # only the images present on disk, in the order of their names
        self._records = []
        for im in images:
            path = os.path.join(images_dir, im["name"])
            if os.path.exists(path):
                self._records.append((im, cams.get(im["camera_id"]), path))
        if max_frames:
            self._records = self._records[:max_frames]

    def __len__(self) -> int:
        return len(self._records)

    def _get_image_full_res(self, index: int):
        return read_image(self._records[index][2])

    def image_filename(self, index: int) -> str:
        return os.path.basename(self._records[index][2])

    def _get_intrinsics_full_res(self, index: int):
        cam = self._records[index][1]
        if not self.use_gt_intrinsics or cam is None:
            return None
        kwargs, cal_type, _w, _h = cam
        return cal_type.create(**{k: float(v) for k, v in kwargs.items()})

    def get_camera_pose(self, index: int) -> SE3:
        im = self._records[index][0]
        return SE3(R=torch.as_tensor(im["R"], dtype=torch.float32), t=torch.as_tensor(im["t"], dtype=torch.float32))
