"""COLMAP scene IO: text (cameras.txt / images.txt / points3D.txt) and
binary (cameras.bin / images.bin / points3D.bin).

Port of gtsfm_tpu/io/colmap.py: the text readers (``read_cameras_txt``,
``read_images_txt``, ``read_points3d_txt``, ``read_scene``), the binary
readers (``read_cameras_bin``, ``read_images_bin``, ``read_points3d_bin``,
``read_scene_binary``, COLMAP's read_write_model layout) and the writer
(``write_scene``), host numpy. Camera models: SIMPLE_PINHOLE and
PINHOLE read as ``Cal3_S2``, SIMPLE_RADIAL and RADIAL as ``Cal3Bundler``,
OPENCV and FULL_OPENCV (truncated to k1, k2, p1, p2, with a warning when
k3..k6 are not 0) as ``Cal3DS2``, OPENCV_FISHEYE as ``Cal3Fisheye``; a
scene must use one model. The writer writes RADIAL, PINHOLE, OPENCV or
OPENCV_FISHEYE lines by the calibration's type.

COLMAP stores the pose cTw (x_cam = R x_world + t); the port stores camera
poses as wTi, so reading inverts and writing inverts back.
"""

from __future__ import annotations

import os
import struct
import warnings

import numpy as np
import torch

from gtsfm_tpu_torch.common.sfm_data import SceneMeta, SfmData
from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler, Cal3DS2, Cal3Fisheye, Cal3_S2, so3


def _rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Batched (N, 3, 3) -> (N, 4) quaternion (w, x, y, z), w >= 0, in
    float64 host numpy (branch-free Shepperd)."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    q2 = np.stack([
        np.maximum(0.0, 1.0 + m00 + m11 + m22),
        np.maximum(0.0, 1.0 + m00 - m11 - m22),
        np.maximum(0.0, 1.0 - m00 + m11 - m22),
        np.maximum(0.0, 1.0 - m00 - m11 + m22),
    ], -1)
    s = 2.0 * np.sqrt(np.maximum(q2, 1e-9))
    sw, sx, sy, sz = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    cands = np.stack([
        np.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1),
        np.stack([(m21 - m12) / sx, 0.5 * (0.5 * sx), (m01 + m10) / sx, (m02 + m20) / sx], -1),
        np.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.5 * (0.5 * sy), (m12 + m21) / sy], -1),
        np.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.5 * (0.5 * sz)], -1),
    ], -2)  # (..., 4 candidates, 4)
    best = np.argmax(q2, axis=-1)
    q = np.take_along_axis(cands, best[..., None, None].repeat(4, -1), -2)[..., 0, :]
    q /= np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    q *= np.where(q[..., :1] < 0, -1.0, 1.0)
    return q


def _quat_to_R(qw, qx, qy, qz) -> np.ndarray:
    return so3.from_quat(torch.tensor([qw, qx, qy, qz], dtype=torch.float32)).numpy()


def _parse_camera_params(model: str, params: list) -> tuple:
    """COLMAP camera model -> (calibration keyword arguments, calibration
    type)."""
    p = [float(x) for x in params]
    if model == "SIMPLE_PINHOLE":  # f, cx, cy
        return dict(fx=p[0], fy=p[0], u0=p[1], v0=p[2]), Cal3_S2
    if model == "PINHOLE":  # fx, fy, cx, cy
        return dict(fx=p[0], fy=p[1], u0=p[2], v0=p[3]), Cal3_S2
    if model == "SIMPLE_RADIAL":  # f, cx, cy, k
        return dict(f=p[0], u0=p[1], v0=p[2], k1=p[3], k2=0.0), Cal3Bundler
    if model == "RADIAL":  # f, cx, cy, k1, k2
        return dict(f=p[0], u0=p[1], v0=p[2], k1=p[3], k2=p[4]), Cal3Bundler
    if model == "OPENCV":  # fx, fy, cx, cy, k1, k2, p1, p2
        return dict(fx=p[0], fy=p[1], u0=p[2], v0=p[3], k1=p[4], k2=p[5], p1=p[6], p2=p[7]), Cal3DS2
    if model == "OPENCV_FISHEYE":  # fx, fy, cx, cy, k1, k2, k3, k4
        return dict(fx=p[0], fy=p[1], u0=p[2], v0=p[3], k1=p[4], k2=p[5], k3=p[6], k4=p[7]), Cal3Fisheye
    if model == "FULL_OPENCV":  # fx fy cx cy k1 k2 p1 p2 k3 k4 k5 k6, truncated to Cal3DS2
        higher = p[8:12]
        if any(abs(c) > 1e-9 for c in higher):
            warnings.warn(f"FULL_OPENCV camera has non-zero k3..k6 {higher}; truncating to k1,k2,p1,p2 "
                          "(Cal3DS2) — undistortion will be approximate.", stacklevel=3)
        return dict(fx=p[0], fy=p[1], u0=p[2], v0=p[3], k1=p[4], k2=p[5], p1=p[6], p2=p[7]), Cal3DS2
    raise ValueError(f"Unsupported COLMAP camera model: {model}")


def read_cameras_txt(path: str) -> dict:
    """-> {camera_id: (cal_kwargs, cal_type, width, height)}"""
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            width, height = int(parts[2]), int(parts[3])
            kwargs, cal_type = _parse_camera_params(model, parts[4:])
            cams[cam_id] = (kwargs, cal_type, width, height)
    return cams


def read_images_txt(path: str) -> list:
    """-> a list of dicts, one per image, sorted by name: {image_id, R, t
    (wTi, numpy float32), camera_id, name, points2d: (K, 3) array of
    (x, y, point3d_id)}."""
    images = []
    # each pose line is followed by its POINTS2D line, which is empty for an
    # image without observations: skip comments only, then read the lines
    # two at a time
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if not ln.lstrip().startswith("#")]
    while lines and not lines[-1].strip():  # the file's final newline, not interior blank lines
        lines.pop()
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        image_id = int(parts[0])
        qw, qx, qy, qz = map(float, parts[1:5])
        tx, ty, tz = map(float, parts[5:8])
        camera_id = int(parts[8])
        name = parts[9]
        R_cw = _quat_to_R(qw, qx, qy, qz)
        t_cw = np.array([tx, ty, tz], np.float32)
        pts2d = np.zeros((0, 3), np.float32)
        if i + 1 < len(lines):
            vals = lines[i + 1].split()
            if len(vals) >= 3:
                pts2d = np.array(vals, np.float64).reshape(-1, 3).astype(np.float32)
        images.append(dict(image_id=image_id, R=R_cw.T, t=-R_cw.T @ t_cw, camera_id=camera_id, name=name,
                           points2d=pts2d))
    images.sort(key=lambda d: d["name"])
    return images


def read_points3d_txt(path: str) -> list:
    """-> a list of (xyz, rgb, error, [(image_id, point2d_idx), ...])"""
    points = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz = np.array(parts[1:4], np.float64).astype(np.float32)
            rgb = np.array(parts[4:7], np.int32)
            err = float(parts[7])
            track = [(int(parts[i]), int(parts[i + 1])) for i in range(8, len(parts), 2)]
            points.append((xyz, rgb, err, track))
    return points


# binary camera model ids: (name, parameter count)
_BIN_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5), 4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8), 6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def _unpack(f, fmt: str) -> tuple:
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> dict:
    """Binary cameras.bin -> the mapping read_cameras_txt gives."""
    cams = {}
    with open(path, "rb") as f:
        (n,) = _unpack(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _unpack(f, "<iiQQ")
            name, n_params = _BIN_CAMERA_MODELS[model_id]
            kwargs, cal_type = _parse_camera_params(name, _unpack(f, f"<{n_params}d"))
            cams[cam_id] = (kwargs, cal_type, int(width), int(height))
    return cams


def read_images_bin(path: str) -> list:
    """Binary images.bin -> the records read_images_txt gives."""
    images = []
    with open(path, "rb") as f:
        (n,) = _unpack(f, "<Q")
        for _ in range(n):
            (image_id,) = _unpack(f, "<i")
            qw, qx, qy, qz, tx, ty, tz = _unpack(f, "<7d")
            (camera_id,) = _unpack(f, "<i")
            name = b""
            while (c := f.read(1)) not in (b"\x00", b""):
                name += c
            (n2d,) = _unpack(f, "<Q")
            pts2d = np.frombuffer(f.read(24 * n2d), dtype="<f8").reshape(-1, 3).astype(np.float32)
            R_cw = _quat_to_R(qw, qx, qy, qz)
            t_cw = np.array([tx, ty, tz], np.float32)
            images.append(dict(image_id=image_id, R=R_cw.T, t=-R_cw.T @ t_cw, camera_id=camera_id,
                               name=name.decode(), points2d=pts2d))
    images.sort(key=lambda d: d["name"])
    return images


def read_points3d_bin(path: str) -> list:
    """Binary points3D.bin -> the list read_points3d_txt gives."""
    points = []
    with open(path, "rb") as f:
        (n,) = _unpack(f, "<Q")
        for _ in range(n):
            _unpack(f, "<Q")  # the point id
            xyz = np.frombuffer(f.read(24), dtype="<f8").astype(np.float32)
            rgb = np.frombuffer(f.read(3), dtype=np.uint8).astype(np.int32)
            (err,) = _unpack(f, "<d")
            (track_len,) = _unpack(f, "<Q")
            raw = np.frombuffer(f.read(8 * track_len), dtype="<i4").reshape(-1, 2)
            points.append((xyz, rgb, float(err), [(int(a), int(b)) for a, b in raw]))
    return points


def read_scene_binary(dirpath: str) -> SfmData:
    """The binary twin of read_scene."""
    return _assemble_scene(read_cameras_bin(os.path.join(dirpath, "cameras.bin")),
                           read_images_bin(os.path.join(dirpath, "images.bin")),
                           read_points3d_bin(os.path.join(dirpath, "points3D.bin")))


def read_scene(dirpath: str) -> SfmData:
    """A COLMAP text scene directory as SfmData (on the CPU), images in the
    order of their file names."""
    return _assemble_scene(read_cameras_txt(os.path.join(dirpath, "cameras.txt")),
                           read_images_txt(os.path.join(dirpath, "images.txt")),
                           read_points3d_txt(os.path.join(dirpath, "points3D.txt")))


def _assemble_scene(cams: dict, images: list, points: list) -> SfmData:
    n = len(images)
    id2idx = {im["image_id"]: i for i, im in enumerate(images)}
    Rs = np.stack([im["R"] for im in images]) if n else np.zeros((0, 3, 3), np.float32)
    ts = np.stack([im["t"] for im in images]) if n else np.zeros((0, 3), np.float32)
    poses = SE3(R=torch.as_tensor(Rs), t=torch.as_tensor(ts))
    # one model for the whole scene, as in the reference
    cal_types = {cams[im["camera_id"]][1] for im in images}
    if len(cal_types) > 1:
        raise ValueError(f"Mixed COLMAP camera models not yet supported: {cal_types}")
    if n:
        kw = [cams[im["camera_id"]][0] for im in images]
        cal = cal_types.pop().create(**{k: np.array([c[k] for c in kw], np.float32) for k in kw[0]})
    else:
        cal = Cal3Bundler.create(torch.ones(1))

    tracks = []
    for xyz, _rgb, _err, obs in points:
        track_obs = []
        for image_id, p2d_idx in obs:
            i = id2idx.get(image_id)
            if i is None:
                continue
            p2d = images[i]["points2d"]
            if p2d_idx >= len(p2d):
                continue
            track_obs.append((i, p2d[p2d_idx, :2]))
        if len(track_obs) >= 2:
            tracks.append((xyz, track_obs))
    meta = SceneMeta(image_names=[im["name"] for im in images],
                     image_sizes=[(cams[im["camera_id"]][2], cams[im["camera_id"]][3]) for im in images])
    return SfmData.from_cameras_and_tracks(poses, cal, tracks, num_cameras=n, meta=meta)


# COLMAP model and parameter order written for each calibration type
_CAMERA_LINES = {
    Cal3Bundler: ("RADIAL", ("f", "u0", "v0", "k1", "k2")),
    Cal3_S2: ("PINHOLE", ("fx", "fy", "u0", "v0")),
    Cal3DS2: ("OPENCV", ("fx", "fy", "u0", "v0", "k1", "k2", "p1", "p2")),
    Cal3Fisheye: ("OPENCV_FISHEYE", ("fx", "fy", "u0", "v0", "k1", "k2", "k3", "k4")),
}


def _camera_line(idx: int, cal, width: int, height: int) -> str:
    if type(cal) not in _CAMERA_LINES:
        raise ValueError(f"Unsupported calibration type {type(cal)}")
    model, names = _CAMERA_LINES[type(cal)]

    def g(attr):
        v = getattr(cal, attr).cpu().numpy()
        return float(v[idx] if v.ndim else v)

    return f"{idx + 1} {model} {width} {height} " + " ".join(str(g(k)) for k in names)


def write_scene(data: SfmData, dirpath: str) -> None:
    """Write SfmData as COLMAP text (cameras.txt, images.txt, points3D.txt):
    the posed cameras and the valid tracks, with each point's mean
    reprojection error."""
    os.makedirs(dirpath, exist_ok=True)
    pose_mask, track_mask, meas_mask, meas_cam, meas_track, meas_uv, points, Rs, ts, err = (
        x.cpu().numpy() for x in (data.pose_mask, data.track_mask, data.meas_mask, data.meas_cam,
                                  data.meas_track, data.meas_uv, data.points, data.poses.R, data.poses.t,
                                  data.reprojection_errors()))
    names = (data.meta.image_names if data.meta and data.meta.image_names else None) or [
        f"image_{i:06d}.jpg" for i in range(data.max_cameras)
    ]
    sizes = (data.meta.image_sizes if data.meta and data.meta.image_sizes else None) or [
        (0, 0)
    ] * data.max_cameras

    # per-image 2D point lists and each measurement's index in its list
    per_image_pts = {i: [] for i in range(data.max_cameras)}
    meas_export_idx = {}
    valid_meas = np.nonzero(meas_mask & track_mask[meas_track] & pose_mask[meas_cam])[0]
    for mi in valid_meas:
        i = int(meas_cam[mi])
        per_image_pts[i].append((meas_uv[mi, 0], meas_uv[mi, 1], int(meas_track[mi]) + 1))
        meas_export_idx[mi] = len(per_image_pts[i]) - 1

    with open(os.path.join(dirpath, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for i in range(data.max_cameras):
            if pose_mask[i]:
                w, h = sizes[i]
                f.write(_camera_line(i, data.cal, w, h) + "\n")

    R_cw_all = np.transpose(Rs, (0, 2, 1))
    t_cw_all = -np.einsum("nij,nj->ni", R_cw_all, ts)
    q_all = _rotmat_to_quat_np(R_cw_all)
    with open(os.path.join(dirpath, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i in range(data.max_cameras):
            if not pose_mask[i]:
                continue
            t_cw, q = t_cw_all[i], q_all[i]
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t_cw[0]} {t_cw[1]} {t_cw[2]} {i + 1} {names[i]}\n")
            f.write(" ".join(f"{x} {y} {pid}" for x, y, pid in per_image_pts[i]) + "\n")

    with open(os.path.join(dirpath, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        track_obs = {j: [] for j in np.nonzero(track_mask)[0]}
        for mi in valid_meas:
            track_obs[int(meas_track[mi])].append((int(meas_cam[mi]) + 1, meas_export_idx[mi]))
        for j, obs in track_obs.items():
            track_err = err[(meas_track == j) & meas_mask]
            track_err = track_err[np.isfinite(track_err)]
            e = float(np.mean(track_err)) if track_err.size else 0.0
            x, y, z = points[j]
            f.write(f"{j + 1} {x} {y} {z} 128 128 128 {e} " + " ".join(f"{iid} {pidx}" for iid, pidx in obs) + "\n")
