"""The port's dataset loaders and COLMAP binary readers against the
reference, on the CPU, each on a small folder the test writes in its
format: a COLMAP binary model (AstroVision), a .log trajectory (Tanks and
Temples), image/intrinsic/pose (MobileBrick), bare images (1DSfM), Kalibr
camchain YAMLs (Hilti), a vehicle log's JSON (Argoverse) and HDF5
calibrations (YFCC, through ``importorskip("h5py")``). Each loader gives
the reference's images, file names, intrinsics (1e-6), GT poses (1e-6)
and valid pairs; the runner's ``build_loader`` builds each of the nine.
"""

import json
import os
import struct
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import yaml
from PIL import Image as PILImage

from gtsfm_tpu import runner as j_runner
from gtsfm_tpu.io import colmap as j_colmap
from gtsfm_tpu.loader import datasets as j_ds
from gtsfm_tpu.loader import hilti as j_hilti
from gtsfm_tpu_torch import runner
from gtsfm_tpu_torch.io import colmap
from gtsfm_tpu_torch.loader import datasets, hilti
from tests.torch_threads import cap_threads

cap_threads()

TOL = 1e-6
HW = (60, 80)


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _write_image(path, rng, h=HW[0], w=HW[1]):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    PILImage.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)


def _assert_loaders_agree(j, t, pairs=True):
    assert len(j) == len(t) > 0
    assert j.image_filenames() == t.image_filenames()
    for i in range(len(j)):
        np.testing.assert_array_equal(t.get_image(i).value_array, j.get_image(i).value_array)
        cj, ct = j.get_camera_intrinsics(i), t.get_camera_intrinsics(i)
        assert type(ct).__name__ == type(cj).__name__
        for k in ct.__dataclass_fields__:
            np.testing.assert_allclose(getattr(ct, k).numpy(), np.asarray(getattr(cj, k)), rtol=TOL, atol=TOL)
    gj, gt = j.get_gt_poses(), t.get_gt_poses()
    assert (gj is None) == (gt is None)
    if gj is not None:
        np.testing.assert_allclose(gt.R.numpy(), np.asarray(gj.R), atol=TOL)
        np.testing.assert_allclose(gt.t.numpy(), np.asarray(gj.t), atol=TOL, rtol=TOL)
    if pairs:
        n = len(j)
        assert ([t.is_valid_pair(a, b) for a in range(n) for b in range(n)]
                == [j.is_valid_pair(a, b) for a in range(n) for b in range(n)])
    tj, tt = j.load_grayscale_batch(), t.load_grayscale_batch()
    np.testing.assert_array_equal(tt[0], tj[0])


# ---- COLMAP binary (AstroVision) ------------------------------------------

_MODELS = {"SIMPLE_PINHOLE": (0, [70.5, 40.25, 30.5]), "PINHOLE": (1, [70.0, 71.0, 40.0, 30.0]),
           "SIMPLE_RADIAL": (2, [72.5, 40.5, 29.5, 0.01]), "RADIAL": (3, [71.0, 40.0, 30.0, -0.02, 0.003]),
           "OPENCV": (4, [70.5, 72.0, 40.5, 29.5, -0.05, 0.01, 5e-4, -3e-4]),
           "OPENCV_FISHEYE": (5, [70.0, 71.0, 40.0, 30.0, 0.02, -0.005, 1e-3, -1e-4])}


def _write_colmap_bin(d, rng, model: str, n: int = 3):
    """cameras.bin, images.bin and points3D.bin in COLMAP's layout, n
    images of one camera model (images named in reverse so that the
    readers' sort shows), 12 points each seen by two or three images."""
    model_id, params = _MODELS[model]
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<iiQQ", i + 1, model_id, HW[1], HW[0]))
            f.write(struct.pack(f"<{len(params)}d", *[p + 0.5 * i for p in params]))
    obs = {i: [] for i in range(n)}
    tracks = []
    for p in range(12):
        cams = sorted(rng.choice(n, size=int(rng.integers(2, n + 1)), replace=False).tolist())
        track = []
        for c in cams:
            track.append((c + 1, len(obs[c])))
            obs[c].append((*rng.uniform(0, 60, 2), p + 1))
        tracks.append((p + 1, rng.normal(size=3), track))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<i", 10 + i) + struct.pack("<7d", *q, *rng.normal(size=3)) + struct.pack("<i", i + 1))
            f.write(f"img_{n - i}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", len(obs[i])))
            for x, y, pid in obs[i]:
                f.write(struct.pack("<ddq", x, y, pid))
            _write_image(os.path.join(d, "images", f"img_{n - i}.png"), rng)
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(tracks)))
        for pid, xyz, track in tracks:
            f.write(struct.pack("<Q", pid) + struct.pack("<3d", *xyz) + bytes([10, 20, 30]) + struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", len(track)))
            for image_id, idx in track:
                f.write(struct.pack("<ii", image_id, idx))


@pytest.mark.parametrize("model", sorted(_MODELS))
def test_colmap_binary_readers_match_reference(tmp_path, model):
    _write_colmap_bin(str(tmp_path), np.random.default_rng(len(model)), model)
    t = colmap.read_scene_binary(str(tmp_path))
    j = jax.tree.map(np.asarray, j_colmap.read_scene_binary(str(tmp_path)))
    for k in ("pose_mask", "track_mask", "meas_cam", "meas_track", "meas_mask"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), getattr(j, k))
    for k in ("points", "meas_uv"):
        np.testing.assert_allclose(getattr(t, k).numpy(), getattr(j, k), rtol=TOL)
    np.testing.assert_allclose(t.poses.R.numpy(), j.poses.R, atol=TOL)
    np.testing.assert_allclose(t.poses.t.numpy(), j.poses.t, atol=TOL, rtol=TOL)
    assert type(t.cal).__name__ == type(j.cal).__name__
    for k in t.cal.__dataclass_fields__:
        np.testing.assert_allclose(getattr(t.cal, k).numpy(), getattr(j.cal, k), rtol=TOL)
    assert t.meta.image_names == ["img_1.png", "img_2.png", "img_3.png"]
    assert colmap.read_points3d_bin(str(tmp_path / "points3D.bin"))[0][2] == 0.5


def test_astrovision_loader(tmp_path):
    _write_colmap_bin(str(tmp_path), np.random.default_rng(0), "PINHOLE")
    _assert_loaders_agree(j_ds.AstrovisionLoader(str(tmp_path)), datasets.AstrovisionLoader(str(tmp_path)))


# ---- Tanks and Temples, MobileBrick, 1DSfM ---------------------------------


def _write_tnt(base, rng, n=3):
    name = os.path.basename(base)
    lines = []
    for i in range(n):
        _write_image(os.path.join(base, name, f"{i:06d}.jpg"), rng)
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = _rot(rng), rng.normal(size=3)
        lines += [f"{i} {i} 0"] + [" ".join(f"{v:.9f}" for v in row) for row in M]
    with open(os.path.join(base, f"{name}_COLMAP_SfM.log"), "w") as f:
        f.write("\n".join(lines) + "\n")


def test_tanks_and_temples_loader(tmp_path):
    base = str(tmp_path / "Barn")
    _write_tnt(base, np.random.default_rng(1))
    assert len(datasets._read_tnt_log(os.path.join(base, "Barn_COLMAP_SfM.log"))) == 3
    args = dict(img_dir=os.path.join(base, "Barn"), poses_fpath=os.path.join(base, "Barn_COLMAP_SfM.log"))
    _assert_loaders_agree(j_ds.TanksAndTemplesLoader(**args), datasets.TanksAndTemplesLoader(**args))


def _write_mobilebrick(d, rng, n=3):
    for i in range(n):
        _write_image(os.path.join(d, "image", f"{i:03d}.jpg"), rng)
        os.makedirs(os.path.join(d, "intrinsic"), exist_ok=True)
        os.makedirs(os.path.join(d, "pose"), exist_ok=True)
        K = np.array([[75.0 + i, 0.2, 40.5], [0, 76.0 + i, 29.5], [0, 0, 1]])
        np.savetxt(os.path.join(d, "intrinsic", f"{i:03d}.txt"), K)
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = _rot(rng), rng.normal(size=3)
        np.savetxt(os.path.join(d, "pose", f"{i:03d}.txt"), M)


def test_mobilebrick_loader(tmp_path):
    _write_mobilebrick(str(tmp_path), np.random.default_rng(2))
    _assert_loaders_agree(j_ds.MobilebrickLoader(str(tmp_path)), datasets.MobilebrickLoader(str(tmp_path)))


def test_onedsfm_loader(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(3):
        _write_image(str(tmp_path / "images" / f"{i:02d}.jpg"), rng)
    _assert_loaders_agree(j_ds.OneDSFMLoader(str(tmp_path)), datasets.OneDSFMLoader(str(tmp_path)))
    assert len(datasets.OneDSFMLoader(str(tmp_path), require_exif=True)) == len(
        j_ds.OneDSFMLoader(str(tmp_path), require_exif=True))


# ---- Hilti ------------------------------------------------------------------


def _write_hilti(d, rng, cams=3, rigs=2):
    os.makedirs(os.path.join(d, "calibration"))
    chain = {}
    for c in range(cams):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = _rot(rng), 0.1 * rng.normal(size=3)
        chain[f"cam{c}"] = {"T_cam_imu": T.tolist(), "intrinsics": [70.0 + c, 71.0 + c, 40.0, 30.0],
                            "resolution": [HW[1], HW[0]]}
    with open(os.path.join(d, "calibration", "calib_camchain-imucam.yaml"), "w") as f:
        yaml.safe_dump(chain, f)
    for i in range(cams * rigs):
        _write_image(os.path.join(d, "images", f"{i}.jpg"), rng)


def test_hilti_loader(tmp_path):
    _write_hilti(str(tmp_path), np.random.default_rng(4))
    j, t = j_hilti.HiltiLoader(str(tmp_path)), hilti.HiltiLoader(str(tmp_path))
    _assert_loaders_agree(j, t)
    (ej, mj, wj), (et, mt, wt) = j.get_rig_constraints(), t.get_rig_constraints()
    np.testing.assert_array_equal(et, ej)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_allclose(mt.R.numpy(), np.asarray(mj.R), atol=TOL)
    np.testing.assert_allclose(mt.t.numpy(), np.asarray(mj.t), atol=TOL)
    assert len(et) == 2 * 3  # 3 pairs in each of 2 rigs


# ---- Argoverse ----------------------------------------------------------------


def _quat(rng):
    q = rng.normal(size=4)
    return (q / np.linalg.norm(q)).tolist()


def _write_argoverse(d, rng, log="log_a", n=12):
    log_dir = os.path.join(d, log)
    cam = "ring_front_center"
    os.makedirs(os.path.join(log_dir, "poses"))
    calib = {"camera_data_": [{"key": f"image_raw_{cam}", "value": {
        "focal_length_x_px_": 70.0, "focal_length_y_px_": 70.05, "focal_center_x_px_": 40.5,
        "focal_center_y_px_": 29.5,
        "vehicle_SE3_camera_": {"rotation": {"coefficients": _quat(rng)}, "translation": rng.normal(size=3).tolist()}}}]}
    with open(os.path.join(log_dir, "vehicle_calibration_info.json"), "w") as f:
        json.dump(calib, f)
    for k in range(n):
        ts = 1000 + 33 * k
        _write_image(os.path.join(log_dir, cam, f"{cam}_{ts}.jpg"), rng)
        if k != 3:  # one frame without a GT pose
            with open(os.path.join(log_dir, "poses", f"city_SE3_egovehicle_{ts}.json"), "w") as f:
                json.dump({"rotation": _quat(rng), "translation": (10 * rng.normal(size=3)).tolist()}, f)


def test_argoverse_loader(tmp_path):
    _write_argoverse(str(tmp_path), np.random.default_rng(5))
    args = (str(tmp_path), "log_a")
    kw = dict(stride=2, max_num_imgs=5, max_lookahead_sec=0.2)
    _assert_loaders_agree(j_ds.ArgoverseLoader(*args, **kw), datasets.ArgoverseLoader(*args, **kw))


# ---- YFCC ---------------------------------------------------------------------


def _write_yfcc(d, rng, names=("b_02", "a_01", "c_03", "d_04")):
    h5py = pytest.importorskip("h5py")
    os.makedirs(os.path.join(d, "new-vis-pairs"))
    os.makedirs(os.path.join(d, "calibration"))
    np.save(os.path.join(d, "new-vis-pairs", "keys-th-0.1.npy"),
            np.array([f"{names[0]}-{names[1]}", f"{names[2]}-{names[0]}", f"{names[3]}-{names[1]}"]))
    for i, name in enumerate(names):
        _write_image(os.path.join(d, "images", f"{name}.jpg"), rng)
        with h5py.File(os.path.join(d, "calibration", f"calibration_{name}.h5"), "w") as f:
            f["R"] = _rot(rng)
            f["T"] = rng.normal(size=(3, 1))
            f["K"] = np.array([[70.0 + i, 0, 40.0], [0, 72.0 + i, 30.0], [0, 0, 1]])


def test_yfcc_loader(tmp_path):
    _write_yfcc(str(tmp_path), np.random.default_rng(6))
    _assert_loaders_agree(j_ds.YfccImbLoader(str(tmp_path)), datasets.YfccImbLoader(str(tmp_path)))


# ---- the runner's build_loader ---------------------------------------------------


def test_runner_builds_every_loader(tmp_path):
    rng = np.random.default_rng(7)
    folders = {"astrovision": tmp_path / "astro", "tanks_and_temples": tmp_path / "tnt" / "Barn",
               "mobilebrick": tmp_path / "mb", "onedsfm": tmp_path / "onedsfm", "hilti": tmp_path / "hilti",
               "argoverse": tmp_path / "argo", "yfcc": tmp_path / "yfcc"}
    _write_colmap_bin(str(folders["astrovision"]), rng, "RADIAL")
    _write_tnt(str(folders["tanks_and_temples"]), rng)
    _write_mobilebrick(str(folders["mobilebrick"]), rng)
    for i in range(2):
        _write_image(str(folders["onedsfm"] / f"{i}.jpg"), rng)
    _write_hilti(str(folders["hilti"]), rng)
    _write_argoverse(str(folders["argoverse"]), rng)
    try:
        _write_yfcc(str(folders["yfcc"]), rng)
    except pytest.skip.Exception:
        del folders["yfcc"]
    assert set(folders) | {"olsson", "colmap"} == set(runner._LOADERS)
    for name, path in folders.items():
        args = SimpleNamespace(loader=name, dataset_dirpath=str(path), images_dir=None, colmap_files_dirpath=None,
                               argoverse_log_id=None, max_resolution=760, max_frames=None)
        t, j = runner.build_loader(args), j_runner.build_loader(args)
        assert type(t).__name__ == type(j).__name__
        _assert_loaders_agree(j, t, pairs=False)
