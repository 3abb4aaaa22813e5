"""Dataset loaders: AstroVision, Tanks and Temples, MobileBrick, 1DSfM,
Argoverse and the Image Matching Benchmark's YFCC scenes.

Port of gtsfm_tpu/loader/datasets.py (the Hilti rig loader is in
loader/hilti.py). Host-side file reading; poses and calibrations come back
as port tensors on the CPU. YFCC's calibrations are HDF5 files: h5py is
imported where they are read, so only a YFCC run needs it.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import SE3, Cal3_S2, Cal3Bundler
from gtsfm_tpu_torch.io import colmap as colmap_io
from gtsfm_tpu_torch.loader.base import LoaderBase, read_image


def _se3(R, t) -> SE3:
    return SE3(R=torch.as_tensor(np.asarray(R), dtype=torch.float32),
               t=torch.as_tensor(np.asarray(t), dtype=torch.float32))


class AstrovisionLoader(LoaderBase):
    """An AstroVision segment: a COLMAP *binary* model and images/."""

    def __init__(self, data_dir: str, max_resolution: int = 1024, max_frames=None):
        super().__init__(max_resolution=max_resolution)
        self.data_dir = data_dir
        cams = colmap_io.read_cameras_bin(os.path.join(data_dir, "cameras.bin"))
        images = colmap_io.read_images_bin(os.path.join(data_dir, "images.bin"))
        self._records = []
        for im in images:
            path = os.path.join(data_dir, "images", im["name"])
            if os.path.exists(path):
                self._records.append((im, cams.get(im["camera_id"]), path))
        if max_frames:
            self._records = self._records[:max_frames]

    def __len__(self):
        return len(self._records)

    def _get_image_full_res(self, index):
        return read_image(self._records[index][2])

    def _get_intrinsics_full_res(self, index):
        cam = self._records[index][1]
        if cam is None:
            return None
        kwargs, cal_type, _w, _h = cam
        return cal_type.create(**{k: float(v) for k, v in kwargs.items()})

    def get_camera_pose(self, index):
        im = self._records[index][0]
        return _se3(im["R"], im["t"])


def _read_tnt_log(path: str) -> list:
    """A Tanks and Temples .log trajectory: blocks of an 'i i 0' line and a
    4x4 wTc, as float32 matrices."""
    poses = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i + 4 < len(lines) + 1 and i + 4 <= len(lines):
        M = np.array([lines[i + 1 + r].split() for r in range(4)], np.float64)
        poses.append(M.astype(np.float32))
        i += 5
    return poses


class TanksAndTemplesLoader(LoaderBase):
    """A T&T scene: an images directory and the COLMAP_SfM.log GT
    trajectory; intrinsics from EXIF."""

    def __init__(self, img_dir: str, poses_fpath: str, max_resolution: int = 760, max_frames=None,
                 ply_alignment_fpath: Optional[str] = None, gt_scene_path: Optional[str] = None):
        super().__init__(max_resolution=max_resolution)
        self._image_paths = sorted(glob.glob(os.path.join(img_dir, "*.jpg"))
                                   + glob.glob(os.path.join(img_dir, "*.png")))
        self._wTc = _read_tnt_log(poses_fpath)
        self.gt_scene_path = gt_scene_path
        n = min(len(self._image_paths), len(self._wTc))
        self._image_paths = self._image_paths[:n]
        self._wTc = self._wTc[:n]
        if max_frames:
            self._image_paths = self._image_paths[:max_frames]
            self._wTc = self._wTc[:max_frames]
        self.alignment = np.eye(4, dtype=np.float32)
        if ply_alignment_fpath and os.path.exists(ply_alignment_fpath):
            self.alignment = np.loadtxt(ply_alignment_fpath).astype(np.float32)

    def __len__(self):
        return len(self._image_paths)

    def _get_image_full_res(self, index):
        return read_image(self._image_paths[index])

    def _get_intrinsics_full_res(self, index):
        return None  # EXIF

    def get_camera_pose(self, index):
        M = self._wTc[index]
        return _se3(M[:3, :3], M[:3, 3])


class MobilebrickLoader(LoaderBase):
    """A MobileBrick capture: image/, intrinsic/<stem>.txt (3x3 K) and
    pose/<stem>.txt (4x4 wTc)."""

    def __init__(self, data_dir: str, max_resolution: int = 760, max_frames=None):
        super().__init__(max_resolution=max_resolution)
        self._image_paths = sorted(glob.glob(os.path.join(data_dir, "image", "*.jpg")))
        if max_frames:
            self._image_paths = self._image_paths[:max_frames]
        self.data_dir = data_dir

    def __len__(self):
        return len(self._image_paths)

    def _stem(self, index):
        return os.path.splitext(os.path.basename(self._image_paths[index]))[0]

    def _get_image_full_res(self, index):
        return read_image(self._image_paths[index])

    def _get_intrinsics_full_res(self, index):
        p = os.path.join(self.data_dir, "intrinsic", f"{self._stem(index)}.txt")
        if not os.path.exists(p):
            return None
        K = np.loadtxt(p).astype(np.float32)
        return Cal3_S2.create(float(K[0, 0]), float(K[1, 1]), float(K[0, 1]), float(K[0, 2]), float(K[1, 2]))

    def get_camera_pose(self, index):
        p = os.path.join(self.data_dir, "pose", f"{self._stem(index)}.txt")
        if not os.path.exists(p):
            return None
        M = np.loadtxt(p).astype(np.float32)  # wTc
        return _se3(M[:3, :3], M[:3, 3])


class OneDSFMLoader(LoaderBase):
    """A 1DSfM internet-photo collection: unordered images with EXIF
    intrinsics, no GT poses; with ``require_exif`` the images without an
    EXIF focal length are skipped."""

    def __init__(self, folder: str, max_resolution: int = 760, max_frames=None, require_exif: bool = False):
        super().__init__(max_resolution=max_resolution)
        img_dir = os.path.join(folder, "images") if os.path.isdir(os.path.join(folder, "images")) else folder
        paths = sorted(glob.glob(os.path.join(img_dir, "*.jpg")) + glob.glob(os.path.join(img_dir, "*.JPG")))
        if require_exif:
            keep = []
            for p in paths:
                try:
                    if read_image(p).focal_length_from_exif():
                        keep.append(p)
                except (OSError, ValueError, KeyError, TypeError):  # an unreadable image or EXIF block
                    pass
            paths = keep
        self._image_paths = paths[:max_frames] if max_frames else paths

    def __len__(self):
        return len(self._image_paths)

    def _get_image_full_res(self, index):
        return read_image(self._image_paths[index])

    def _get_intrinsics_full_res(self, index):
        return None  # EXIF


def _quat_wxyz_to_R(q) -> np.ndarray:
    """Quaternion (w, x, y, z) -> rotation matrix (float64)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class ArgoverseLoader(LoaderBase):
    """One ring camera of an Argoverse v1 tracking log, read from the raw
    log directory (poses/*.json, vehicle_calibration_info.json): every
    ``stride``-th frame with a GT pose, at most ``max_num_imgs``, poses
    anchored at the first camera, pairs within ``max_lookahead_sec``."""

    FRAME_RATE = 30  # ring camera Hz

    def __init__(self, dataset_dir: str, log_id: str, stride: int = 5, max_num_imgs: int = 20,
                 max_lookahead_sec: float = 2.0, camera_name: str = "ring_front_center", max_resolution: int = 760):
        super().__init__(max_resolution=max_resolution)
        log_dir = os.path.join(dataset_dir, log_id)
        self._log_dir = log_dir
        self._camera_name = camera_name
        self._max_lookahead = max_lookahead_sec * self.FRAME_RATE / stride

        with open(os.path.join(log_dir, "vehicle_calibration_info.json")) as f:
            calib = json.load(f)
        cam = next(c["value"] for c in calib["camera_data_"] if c["key"] == f"image_raw_{camera_name}")
        fx, fy = cam["focal_length_x_px_"], cam["focal_length_y_px_"]
        if abs(fx - fy) >= 0.1:
            raise ValueError(f"argoverse ring cameras have square pixels: fx {fx}, fy {fy}")
        self._cal = Cal3Bundler.create(float(fx), 0.0, 0.0, float(cam["focal_center_x_px_"]),
                                       float(cam["focal_center_y_px_"]))
        ext = cam["vehicle_SE3_camera_"]
        self._ego_T_cam = (_quat_wxyz_to_R(ext["rotation"]["coefficients"]), np.asarray(ext["translation"], np.float64))

        paths = sorted(glob.glob(os.path.join(log_dir, camera_name, f"{camera_name}_*.jpg")))
        stamps = [int(os.path.splitext(os.path.basename(p))[0].split("_")[-1]) for p in paths]
        keep = [(p, ts) for p, ts in zip(paths, stamps) if os.path.exists(self._pose_path(ts))]
        keep = keep[::stride][:max_num_imgs]
        self._image_paths = [p for p, _ in keep]
        self._timestamps = [ts for _, ts in keep]
        self._anchor = None  # cam0_T_city: the world frame at the first camera
        if self._timestamps:
            R0, t0 = self._city_T_cam(self._timestamps[0])
            self._anchor = (R0.T, -R0.T @ t0)

    def _pose_path(self, ts: int) -> str:
        return os.path.join(self._log_dir, "poses", f"city_SE3_egovehicle_{ts}.json")

    def _city_T_cam(self, ts: int):
        with open(self._pose_path(ts)) as f:
            d = json.load(f)
        R_ce = _quat_wxyz_to_R(d["rotation"])
        t_ce = np.asarray(d["translation"], np.float64)
        R_vc, t_vc = self._ego_T_cam
        return R_ce @ R_vc, R_ce @ t_vc + t_ce

    def __len__(self):
        return len(self._image_paths)

    def _get_image_full_res(self, index):
        return read_image(self._image_paths[index])

    def _get_intrinsics_full_res(self, index):
        return self._cal

    def get_camera_pose(self, index):
        R, t = self._city_T_cam(self._timestamps[index])
        Ra, ta = self._anchor
        return _se3(Ra @ R, Ra @ t + ta)

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        return super().is_valid_pair(idx1, idx2) and (idx2 < idx1 + self._max_lookahead)


class YfccImbLoader(LoaderBase):
    """An Image Matching Benchmark YFCC scene: the pairs of the
    co-visibility list (new-vis-pairs/keys-th-X.X.npy, "name1-name2"),
    each image's calibration/calibration_<name>.h5 (R, T = cTw and K),
    poses inverted to wTi and K reduced to Cal3Bundler with f = (fx +
    fy) / 2."""

    def __init__(self, dataset_dir: str, co_visibility_threshold: float = 0.1, max_resolution: int = 760):
        super().__init__(max_resolution=max_resolution)
        self._dataset_dir = dataset_dir
        vis_file = os.path.join(dataset_dir, "new-vis-pairs", f"keys-th-{co_visibility_threshold:0.1f}.npy")
        names = set()
        pairs = set()
        for entry in np.load(vis_file):
            f1, f2 = str(entry).split("-")
            names.update((f1, f2))
            pairs.add((min(f1, f2), max(f1, f2)))
        self._image_names = sorted(names)
        idx = {n: i for i, n in enumerate(self._image_names)}
        self._pairs = {tuple(sorted((idx[a], idx[b]))) for a, b in pairs}
        self._calibrations = [self._read_calibration(n) for n in self._image_names]

    def _read_calibration(self, name: str):
        import h5py

        path = os.path.join(self._dataset_dir, "calibration", f"calibration_{name}.h5")
        with h5py.File(path, "r") as f:
            R_cw = np.asarray(f["R"], np.float64)
            t_cw = np.asarray(f["T"], np.float64).reshape(3)
            K = np.asarray(f["K"], np.float64)
        cal = Cal3Bundler.create(float(0.5 * (K[0, 0] + K[1, 1])), 0.0, 0.0, float(K[0, 2]), float(K[1, 2]))
        return cal, _se3(R_cw.T, -R_cw.T @ t_cw)

    def __len__(self):
        return len(self._image_names)

    def image_filenames(self):
        return list(self._image_names)

    def _get_image_full_res(self, index):
        return read_image(os.path.join(self._dataset_dir, "images", f"{self._image_names[index]}.jpg"))

    def _get_intrinsics_full_res(self, index):
        return self._calibrations[index][0]

    def get_camera_pose(self, index):
        return self._calibrations[index][1]

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        return super().is_valid_pair(idx1, idx2) and (idx1, idx2) in self._pairs
