"""The port's default entry point against the JAX reference, on the CPU:
the loaders, COLMAP text IO, bridge reconnection, axis alignment, track
classification, intrinsics errors, the configs and both runners end to end,
and the feed-forward slots (vggt, fastvggt, anysplat with --run_gs) end to
end on chip_smoke's numpy-made views with one set of seeded weights
(``chip_smoke.feedforward_fixture``) in both packages' model caches: the
same feed-forward track count, all cameras registered, AUC@5 within 0.02,
and for anysplat the trainer's initial L1 within 1e-3 relative (one
gaussian set, rendered by the plain compositing and by XLA), a falling L1
and the two PLY files with the reference's vertex counts.

Tolerances: images equal; intrinsics and poses 1e-6 (float32 values from
the same float64 host arithmetic, one rounding apart); host numpy ports
exactly; device-side float32 (the DLT of the track classifier, the Sim3 of
the alignment) 1e-5 relative. End to end, RANSAC and the back end draw
from different random streams in the two packages, so the runs are held to
the accuracy bar: equal registered counts and pose AUC@5 within 0.02.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
from PIL import Image as PILImage

import chip_smoke
from gtsfm_tpu import runner as j_runner
from gtsfm_tpu.common.sfm_data import SceneMeta as JSceneMeta, SfmData as JSfmData
from gtsfm_tpu.configs import config as j_config
from gtsfm_tpu.evaluation.metrics import intrinsics_error_metrics as j_intrinsics_error_metrics
from gtsfm_tpu.geometry import SE3 as JSE3, Cal3Bundler as JCal
from gtsfm_tpu.io import colmap as j_colmap
from gtsfm_tpu.loader.colmap import ColmapLoader as JColmapLoader
from gtsfm_tpu.loader.olsson import OlssonLoader as JOlssonLoader
from gtsfm_tpu.retriever.bridge import find_bridge_pairs as j_find_bridge_pairs
from gtsfm_tpu.utils.ellipsoid import align_scene_to_axes as j_align
from gtsfm_tpu.utils.tracks import tracks_from_sfm_data as j_tracks_from_sfm_data
from gtsfm_tpu_torch import runner
from gtsfm_tpu_torch.common.sfm_data import SceneMeta
from gtsfm_tpu_torch.configs import config
from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup, intrinsics_error_metrics
from gtsfm_tpu_torch.frontend import registry
from gtsfm_tpu_torch.io import colmap
from gtsfm_tpu_torch.loader.base import batch_calibrations
from gtsfm_tpu_torch.loader.colmap import ColmapLoader
from gtsfm_tpu_torch.loader.olsson import OlssonLoader
from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses
from gtsfm_tpu_torch.retriever.bridge import find_bridge_pairs
from gtsfm_tpu_torch.utils import convert
from gtsfm_tpu_torch.utils.ellipsoid import align_scene_to_axes
from gtsfm_tpu_torch.utils.tracks import tracks_from_sfm_data
from tests.torch_threads import cap_threads, threads

cap_threads()

TOL = 1e-6
# one camera of each COLMAP model the readers take (FULL_OPENCV with k3..k6
# not 0: truncated, with a warning, in both packages)
COLMAP_PARAMS = {
    "SIMPLE_PINHOLE": "205.5 80.5 60.25",
    "PINHOLE": "200 201 80 60",
    "SIMPLE_RADIAL": "210.5 80.25 60.5 0.01",
    "RADIAL": "190.0 81.0 59.0 -0.02 0.003",
    "OPENCV": "200.5 202.0 80.5 59.5 -0.05 0.01 0.0005 -0.0003",
    "FULL_OPENCV": "200.5 202.0 80.5 59.5 -0.05 0.01 0.0005 -0.0003 0.001 0.0 0.0 0.0",
    "OPENCV_FISHEYE": "190.0 191.0 80.0 60.0 0.02 -0.005 0.001 -0.0001",
}
SHIPPED = ("unified", "sift_front_end", "door", "cluster", "synthetic_front_end", "unit_test", "vggt", "fastvggt",
           "anysplat", "deep_front_end", "megaloc_sift_frontend", "onedsfm_front_end", "colmap_front_end",
           "skydio_front_end", "mast3r")
VIEWS = 8  # ring views of the end-to-end test
MVS_COUNT_TOL = 0.02  # the --run_mvs runners' dense point counts, relative
# the feed-forward runners' folder: chip_smoke.feedforward_views of the
# first FF_VIEWS ring cameras at FF_HW, f = FF_FOCAL
FF_VIEWS = 4
FF_HW = (96, 128)
FF_FOCAL = 120.0
FF_GS_STEPS = 50  # the trainer reports the mean L1 of its first and of its last 20 steps


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _write_png(path, rng, h, w):
    PILImage.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)


def _assert_loaders_agree(j, t):
    assert len(j) == len(t)
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
    tj, tt = j.load_grayscale_batch(), t.load_grayscale_batch()
    np.testing.assert_array_equal(tt[0], tj[0])
    assert tt[1] == tj[1]


@pytest.mark.parametrize("max_resolution", [760, 100])
def test_olsson_loader(tmp_path, max_resolution):
    rng = np.random.default_rng(0)
    (tmp_path / "images").mkdir()
    P = np.empty((1, 3), object)
    for i, (h, w) in enumerate([(120, 160), (120, 160), (150, 130)]):
        _write_png(tmp_path / "images" / f"{i:02d}.png", rng, h, w)
        K = np.array([[200.0 + i, 0.3, w / 2 + 1.5], [0, 201.0 + i, h / 2 - 2.0], [0, 0, 1]])
        R, c = _rot(rng), rng.normal(size=3) * 3
        P[0, i] = 2.5 * K @ np.concatenate([R.T, -R.T @ c[:, None]], axis=1)  # any scale of P
    scipy.io.savemat(tmp_path / "data.mat", {"P": P})
    _assert_loaders_agree(JOlssonLoader(str(tmp_path), max_resolution=max_resolution),
                          OlssonLoader(str(tmp_path), max_resolution=max_resolution))


def test_olsson_loader_exif_intrinsics(tmp_path):
    """No data.mat: intrinsics from EXIF (FocalLengthIn35mmFilm, then the
    default focal ratio), no GT."""
    rng = np.random.default_rng(1)
    (tmp_path / "images").mkdir()
    for i in range(2):
        exif = PILImage.Exif()
        if i == 0:
            exif.get_ifd(0x8769)[0xA405] = 35  # FocalLengthIn35mmFilm
        PILImage.fromarray(rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)).save(
            tmp_path / "images" / f"{i:02d}.jpg", exif=exif)
    t = OlssonLoader(str(tmp_path))
    _assert_loaders_agree(JOlssonLoader(str(tmp_path)), t)
    f0 = float(t.get_camera_intrinsics(0).f)
    np.testing.assert_allclose(f0, 35 * np.hypot(120, 90) / np.hypot(36, 24), rtol=TOL)
    np.testing.assert_allclose(float(t.get_camera_intrinsics(1).f), 1.2 * 120, rtol=TOL)


def _write_colmap(d, rng, models):
    (d / "images").mkdir()
    cams = ["# cameras"]
    imgs = ["# images", "# two lines each"]
    for i, model in enumerate(models):
        params = COLMAP_PARAMS[model]
        cams.append(f"{i + 1} {model} 160 120 {params}")
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        tr = rng.normal(size=3)
        name = f"img_{3 - i}.png"  # the loader orders by name
        imgs.append(f"{10 + i} {q[0]} {q[1]} {q[2]} {q[3]} {tr[0]} {tr[1]} {tr[2]} {i + 1} {name}")
        imgs.append("10.5 20.5 -1 30.25 40.75 7")
        _write_png(d / "images" / name, rng, 120, 160)
    (d / "cameras.txt").write_text("\n".join(cams) + "\n")
    (d / "images.txt").write_text("\n".join(imgs) + "\n")


def test_colmap_loader(tmp_path):
    _write_colmap(tmp_path, np.random.default_rng(2), ["SIMPLE_RADIAL", "RADIAL", "RADIAL"])
    args = (str(tmp_path), str(tmp_path / "images"))
    _assert_loaders_agree(JColmapLoader(*args), ColmapLoader(*args))


@pytest.mark.parametrize("model", sorted(COLMAP_PARAMS))
def test_colmap_camera_model_reads_and_writes_as_the_reference(tmp_path, model):
    """Each COLMAP camera model loads as the reference loads it (at full
    size and rescaled by max_resolution, skew included), reads into the
    same calibration type, and writes back the line the reference writes;
    a scene mixing models raises ValueError as it does."""
    _write_colmap(tmp_path, np.random.default_rng(3), [model, model])
    args = (str(tmp_path), str(tmp_path / "images"))
    for res in (760, 60):
        _assert_loaders_agree(JColmapLoader(*args, max_resolution=res), ColmapLoader(*args, max_resolution=res))
    cams_t = colmap.read_cameras_txt(str(tmp_path / "cameras.txt"))
    cams_j = j_colmap.read_cameras_txt(str(tmp_path / "cameras.txt"))
    for cid, (kw, cal_type, w, h) in cams_t.items():
        kw_j, type_j, w_j, h_j = cams_j[cid]
        assert (kw, cal_type.__name__, w, h) == (kw_j, type_j.__name__, w_j, h_j)
    # the reference's own camera_line for a batched calibration of this type
    cal_t = batch_calibrations([ColmapLoader(*args).get_camera_intrinsics(i) for i in range(2)])
    cal_j = jax.tree.map(jnp.asarray, JColmapLoader(*args).get_camera_intrinsics(0))
    cal_j = jax.tree.map(lambda *xs: jnp.stack(xs), cal_j, JColmapLoader(*args).get_camera_intrinsics(1))
    for i in range(2):
        assert colmap._camera_line(i, cal_t, 160, 120) == j_colmap._camera_line(i, cal_j, 160, 120)
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    other = "OPENCV_FISHEYE" if model != "OPENCV_FISHEYE" else "RADIAL"  # another calibration type
    _write_colmap(mixed, np.random.default_rng(4), [model, other])
    (mixed / "points3D.txt").write_text("")
    with pytest.raises(ValueError, match="Mixed COLMAP camera models"):
        j_colmap.read_scene(str(mixed))
    with pytest.raises(ValueError, match="Mixed COLMAP camera models"):
        colmap.read_scene(str(mixed))


def _seeded_scene(n=5, tracks=40, seed=4):
    """A JAX SfmData of n posed cameras (one unposed) and random tracks,
    and the same scene in the port."""
    rng = np.random.default_rng(seed)
    R = np.stack([_rot(rng) for _ in range(n)]).astype(np.float32)
    t = rng.normal(size=(n, 3)).astype(np.float32) * 2
    pts = rng.normal(size=(tracks, 3)).astype(np.float32) + np.array([0, 0, 8], np.float32)
    obs = []
    for j in range(tracks):
        for c in rng.choice(n, size=rng.integers(2, 4), replace=False):
            obs.append((c, j, rng.uniform(0, 300, 2)))
    M = len(obs) + 3  # padded measurement slots
    meas_cam = np.zeros(M, np.int32)
    meas_track = np.zeros(M, np.int32)
    meas_uv = np.zeros((M, 2), np.float32)
    for m, (c, j, uv) in enumerate(obs):
        meas_cam[m], meas_track[m], meas_uv[m] = c, j, uv
    meas_mask = np.arange(M) < len(obs)
    meas_mask[::7] = False
    pose_mask = np.ones(n, bool)
    pose_mask[2] = False
    track_mask = rng.random(tracks) > 0.1
    cal = dict(f=np.full(n, 300.0, np.float32) + np.arange(n, dtype=np.float32),
               k1=np.full(n, 0.01, np.float32), k2=np.zeros(n, np.float32),
               u0=np.full(n, 160.0, np.float32), v0=np.full(n, 120.0, np.float32))
    names = [f"im{i}.png" for i in range(n)]
    sizes = [(320, 240)] * n
    jdata = JSfmData(poses=JSE3(R=jnp.asarray(R), t=jnp.asarray(t)),
                     cal=JCal(**{k: jnp.asarray(v) for k, v in cal.items()}),
                     pose_mask=jnp.asarray(pose_mask), points=jnp.asarray(pts), track_mask=jnp.asarray(track_mask),
                     meas_cam=jnp.asarray(meas_cam), meas_track=jnp.asarray(meas_track),
                     meas_uv=jnp.asarray(meas_uv), meas_mask=jnp.asarray(meas_mask),
                     meta=JSceneMeta(image_names=names, image_sizes=sizes))
    tdata = convert.sfm_data(jdata).replace(meta=SceneMeta(image_names=names, image_sizes=sizes))
    return jdata, tdata


def _rows(path):
    return [ln.split() for ln in open(path) if not ln.startswith("#")]


def test_colmap_write_and_read(tmp_path):
    jdata, tdata = _seeded_scene()
    j_colmap.write_scene(jdata, str(tmp_path / "jax"))
    colmap.write_scene(tdata, str(tmp_path / "port"))
    for name in ("cameras.txt", "images.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    # points3D: the same text but the mean reprojection error, which the
    # two packages compute in float32 in another order
    pj, pt = _rows(tmp_path / "jax" / "points3D.txt"), _rows(tmp_path / "port" / "points3D.txt")
    assert len(pt) == len(pj) == int(tdata.track_mask.sum())
    for a, b in zip(pt, pj):
        assert a[:7] == b[:7] and a[8:] == b[8:]
        np.testing.assert_allclose(float(a[7]), float(b[7]), rtol=1e-5, atol=1e-5)
    back_t = colmap.read_scene(str(tmp_path / "port"))
    back_j = j_colmap.read_scene(str(tmp_path / "port"))
    assert back_t.number_images() == 4 and back_t.meta.image_names == back_j.meta.image_names
    for k in ("points", "track_mask", "meas_cam", "meas_track", "meas_uv", "meas_mask", "pose_mask"):
        np.testing.assert_allclose(getattr(back_t, k).numpy(), np.asarray(getattr(back_j, k)), atol=TOL)
    np.testing.assert_allclose(back_t.poses.R.numpy(), np.asarray(back_j.poses.R), atol=TOL)
    np.testing.assert_allclose(back_t.poses.t.numpy(), np.asarray(back_j.poses.t), atol=TOL)
    # the round trip: the posed cameras come back
    posed = tdata.pose_mask.numpy()
    np.testing.assert_allclose(back_t.poses.R.numpy(), tdata.poses.R.numpy()[posed], atol=1e-5)
    np.testing.assert_allclose(back_t.poses.t.numpy(), tdata.poses.t.numpy()[posed], atol=1e-5)
    np.testing.assert_allclose(back_t.cal.f.numpy(), tdata.cal.f.numpy()[posed])


def test_bridge_pairs():
    rng = np.random.default_rng(5)
    sim = rng.random((12, 12)).astype(np.float32)
    sim = (sim + sim.T) / 2
    valid = np.array([[0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [9, 10]])
    want = j_find_bridge_pairs(12, valid, sim)
    got = find_bridge_pairs(12, valid, sim)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(find_bridge_pairs(12, valid[:2], sim), j_find_bridge_pairs(12, valid[:2], sim))


def test_align_scene_to_axes():
    jdata, tdata = _seeded_scene(seed=6)
    want, got = j_align(jdata), align_scene_to_axes(tdata)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.poses.R.numpy(), np.asarray(want.poses.R), atol=1e-5)
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(want.poses.t), rtol=1e-5, atol=1e-5)


def test_track_classification_and_intrinsics_errors():
    """Tracks of a GT scene (exact projections) plus corrupted ones."""
    rng = np.random.default_rng(7)
    n = 6
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    jdata, tdata = _seeded_scene(n=n, tracks=60, seed=8)
    tdata = tdata.replace(poses=gt, pose_mask=torch.ones(n, dtype=torch.bool))
    cam = tdata.cameras().map(lambda a: a[tdata.meas_cam])
    pts = torch.as_tensor(rng.normal(size=(60, 3)), dtype=torch.float32)
    uv, _ = cam.project(pts[tdata.meas_track])
    uv = uv + torch.as_tensor(rng.normal(0, 0.5, uv.shape), dtype=torch.float32)
    uv[tdata.meas_track % 3 == 0] += 25.0  # every third track is wrong in all views
    tdata = tdata.replace(meas_uv=uv, points=pts)
    jdata = jdata.replace(poses=JSE3(R=jnp.asarray(gt.R.numpy()), t=jnp.asarray(gt.t.numpy())),
                          pose_mask=jnp.ones(n, bool), meas_uv=jnp.asarray(uv.numpy()), points=jnp.asarray(pts.numpy()))
    jgt = JSE3(R=jnp.asarray(gt.R.numpy()), t=jnp.asarray(gt.t.numpy()))
    cj, ej = j_tracks_from_sfm_data(jdata, jgt)
    ct, et = tracks_from_sfm_data(tdata, gt)
    np.testing.assert_array_equal(ct, cj)
    assert 0 < ct.sum() < len(ct)
    # errors of the consistent tracks to 1e-3 px (float32 DLT; the wrong
    # tracks' errors are large and ill-conditioned in both packages)
    np.testing.assert_array_equal(np.isnan(et), np.isnan(ej))
    np.testing.assert_allclose(et[ct], ej[cj], atol=1e-3, rtol=0, equal_nan=True)

    cal_gt = convert.cal3_bundler(jdata.cal)
    cal_est = cal_gt.replace(f=cal_gt.f * 1.03, k1=cal_gt.k1 + 0.002)
    mask = np.array([True, True, False, True, True, True])
    got = {m.name: m.dist for m in intrinsics_error_metrics(cal_est, cal_gt, valid_mask=mask).metrics}
    want = {m.name: m.dist for m in j_intrinsics_error_metrics(
        JCal(**{k: jnp.asarray(getattr(cal_est, k).numpy()) for k in ("f", "k1", "k2", "u0", "v0")}),
        jdata.cal, valid_mask=mask).metrics}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL)


def _options_equal(t, j, path):
    """Every field of the port's option tuple t equals the reference's
    field of the same name (recursing into nested tuples)."""
    for name in t._fields:
        if name == "device":
            continue
        a, b = getattr(t, name), getattr(j, name)
        if hasattr(a, "_fields"):
            _options_equal(a, b, f"{path}.{name}")
        elif hasattr(a, "name") and hasattr(b, "name"):  # enums of the two packages
            assert a.name == b.name, f"{path}.{name}"
        else:
            assert a == b, f"{path}.{name}: {a!r} != {b!r}"


def _component_options_equal(t, j, path):
    """Two packages' components of the same class name with equal options,
    and so their matchers (the dense generators); the reference's COLMAP
    replay sits in a wrapper (its ``g``) that the port does not need."""
    if hasattr(j, "g"):
        j = j.g
    assert type(t).__name__ == type(j).__name__, path
    if hasattr(j, "options"):
        _options_equal(t.options, j.options, f"{path}.options")
    if hasattr(j, "matcher"):
        _component_options_equal(t.matcher, j.matcher, f"{path}.matcher")


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_configs_build_as_the_reference(name, tmp_path):
    """Every config of the reference loads in the port as it does there
    (colmap_front_end with its colmap_dir set) and builds components of
    the same classes with equal options."""
    extra = []
    if name == "colmap_front_end":
        n = 3
        gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
        chip_smoke.write_colmap_tracks(str(tmp_path / "model"), gt.R.numpy(), gt.t.numpy(), [])
        extra = [f"correspondence.colmap_dir={tmp_path / 'model'}"]
    cfg_t = config.load_config(name, extra + ["scene_optimizer.device=cpu"])
    cfg_j = j_config.load_config(name, extra)
    cfg_t["scene_optimizer"].pop("device")
    assert cfg_t == cfg_j
    so_t = config.build_scene_optimizer(config.load_config(name, extra + ["scene_optimizer.device=cpu"]))
    so_j = j_config.build_scene_optimizer(cfg_j)
    _options_equal(so_t.options, so_j.options, "scene_optimizer")
    assert type(so_t.retriever).__name__ == type(so_j.retriever).__name__
    if hasattr(so_j.retriever, "options"):
        _options_equal(so_t.retriever.options, so_j.retriever.options, "retriever")
    _component_options_equal(getattr(so_t.detector, "detector", so_t.detector), so_j.detector.detector, "detector")
    for slot in ("matcher", "global_descriptor", "correspondence"):
        t, j = getattr(so_t, slot), getattr(so_j, slot)
        assert (t is None) == (j is None), slot
        if j is not None:
            _component_options_equal(t, j, slot)
    assert so_t.device == torch.device("cpu")


def test_unported_components_and_flags_raise_before_any_work(tmp_path):
    from gtsfm_tpu_torch.frontend.correspondence import DenseCorrespondenceGenerator

    sift = registry.build_detector({"name": "sift", "max_keypoints": 64})
    assert sift.max_keypoints == 64 and sift.detector.options.kind == "sift"
    with pytest.raises(ValueError, match="Unknown detector"):
        registry.build_detector({"name": "nope"})
    with pytest.raises(ValueError):
        registry.build_global_descriptor({"name": "nope"})
    loftr = registry.build_correspondence({"name": "loftr", "d_coarse": 32, "d_fine": 16, "nhead": 4,
                                           "initial_dim": 16, "block_dims": (16, 24, 32)}, device="cpu")
    assert isinstance(loftr, DenseCorrespondenceGenerator) and loftr.matcher.options.d_coarse == 32
    with pytest.raises(ValueError, match="Unknown correspondence generator"):
        registry.build_correspondence({"name": "nope"})
    assert registry.build_correspondence({"name": "synthetic"}).requires_gt
    with pytest.raises(NotImplementedError, match="TwoViewOptions has no option 'no_such_option'"):
        config.build_scene_optimizer(config.load_config("unified",
                                                        ["scene_optimizer.two_view.no_such_option=true"]))
    base = ["--dataset_dirpath", str(tmp_path), "--output_root", str(tmp_path / "out")]
    for flags in (["--distributed_coordinator", "localhost:1"], ["--distributed_num_processes", "2"],
                  ["--distributed_process_id", "0"]):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
            runner.main(base + flags)
    # PatchmatchNet without weights raises, as the reference does, but before any work
    with pytest.raises(RuntimeError, match="requires weights"):
        runner.main(base + ["--run_mvs", "--mvs_backend", "patchmatchnet", "scene_optimizer.device=cpu"])
    assert not (tmp_path / "out").exists()


class _FakeLoader:
    def __len__(self):
        return 5


@pytest.mark.parametrize("flag", ["--use_cache", "--load_chunk_size", "--prewarm", "--gs_video_frames",
                                  "--compare_to"])
def test_runner_flag_reaches_the_run(tmp_path, monkeypatch, flag):
    """Each flag the reference's runner takes reaches the scene optimizer's
    options or runs its step, as gtsfm_tpu/runner.py wires it (the run
    itself replaced by one that exports a seeded scene)."""
    from gtsfm_tpu.evaluation.compare import compare_colmap_dirs as j_compare_dirs
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer
    from gtsfm_tpu_torch.utils import prewarm

    jdata, tdata = _seeded_scene()
    seen = {}

    def fake_run(self, loader):
        seen["options"] = self.options
        colmap.write_scene(tdata, os.path.join(self.options.output_root, "results", "ba_output"))
        return tdata, []

    monkeypatch.setattr(runner, "build_loader", lambda args: _FakeLoader())
    monkeypatch.setattr(SceneOptimizer, "run", fake_run)
    monkeypatch.setattr(prewarm, "prewarm_standard_shapes", lambda **kw: seen.setdefault("prewarm", kw) and {})
    out = tmp_path / "out"
    argv = {"--use_cache": ["--use_cache", "--cache_root", str(tmp_path / "cache")],
            "--load_chunk_size": ["--load_chunk_size", "4"], "--prewarm": ["--prewarm"],
            "--gs_video_frames": ["--gs_video_frames", "3", "--run_gs"],
            "--compare_to": ["--compare_to", str(tmp_path / "ref")]}[flag]
    j_colmap.write_scene(jdata, str(tmp_path / "ref"))
    assert runner.main(["--dataset_dirpath", str(tmp_path), "--output_root", str(out), "scene_optimizer.device=cpu"]
                       + argv) == 0
    opts = seen["options"]
    plain = {"use_cache": False, "cache_root": None, "load_chunk_size": 0, "gs_video_frames": 0, "run_gs": False}
    want = {"--use_cache": {"use_cache": True, "cache_root": str(tmp_path / "cache")},
            "--load_chunk_size": {"load_chunk_size": 4},
            "--gs_video_frames": {"gs_video_frames": 3, "run_gs": True}}.get(flag, {})
    assert {k: getattr(opts, k) for k in plain} == dict(plain, **want)
    assert ("prewarm" in seen) == (flag == "--prewarm")
    if flag == "--prewarm":
        assert seen["prewarm"] == {"device": "cpu"}
    cmp_dir = out / "results" / "comparison"
    assert cmp_dir.exists() == (flag == "--compare_to")
    if flag == "--compare_to":
        rows = {r[0]: r[1] for r in csv.reader(open(cmp_dir / "comparison_metrics.csv"))}
        j_group = j_compare_dirs(str(out / "results" / "ba_output"), str(tmp_path / "ref"))
        assert float(rows["num_matched_cameras"]) == j_group.metrics[0].scalar == 4
        assert sorted(os.listdir(cmp_dir)) == ["camera_centers.png", "comparison_metrics.csv",
                                               "per_camera_errors.csv"]


def _results_files(output_root) -> list:
    root = os.path.join(output_root, "results")
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _scalars(output_root):
    mdir = os.path.join(output_root, "results", "metrics")
    return {g.name: {m.name: (m.scalar if m.dist is None else m.dist) for m in g.metrics}
            for g in (MetricsGroup.from_json(os.path.join(mdir, f)) for f in sorted(os.listdir(mdir)))}


@pytest.fixture(scope="module")
def ring_folder(tmp_path_factory) -> str:
    """An Olsson folder of VIEWS neighbouring ring views of
    chip_smoke.runner_scene, rendered by the port on the CPU at 480x640,
    f = 600. At 240x320 the pairs two ring steps apart carry too few
    matches (the reference registers 4 of 8), so the views are rendered at
    full size, with 256 slots a tile (about 1.5 s a view on the CPU, where
    the chip phase's 512 take about 3 s)."""
    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)[:VIEWS]
    with threads(8):
        views = chip_smoke.ring_views(R, t, torch.device("cpu"), chip_smoke.runner_scene(t.mean(axis=0)),
                                      indices=order, per_tile_cap=256)
    path = str(tmp_path_factory.mktemp("ring") / "data")
    chip_smoke.write_olsson(path, views, R[order], t[order], chip_smoke.SPLAT_FOCAL)
    return path


@threads(8)
def test_runners_end_to_end(tmp_path, ring_folder):
    """Both runners' main on ring_folder with detector.max_keypoints=512."""
    args = ["--config_name", "unified", "--loader", "olsson", "--dataset_dirpath", ring_folder, "--output_root"]
    assert j_runner.main(args + [str(tmp_path / "jax"), "detector.max_keypoints=512"]) == 0
    assert runner.main(args + [str(tmp_path / "port"), "detector.max_keypoints=512",
                               "scene_optimizer.device=cpu"]) == 0
    mj, mt = _scalars(str(tmp_path / "jax")), _scalars(str(tmp_path / "port"))
    reg_j, reg_t = len(mj["ba_pose_metrics"]["rotation_error_deg"]), len(mt["ba_pose_metrics"]["rotation_error_deg"])
    assert reg_t == reg_j == VIEWS
    auc_j, auc_t = mj["ba_pose_metrics"]["pose_auc_@5.0_deg"], mt["ba_pose_metrics"]["pose_auc_@5.0_deg"]
    assert auc_t >= auc_j - 0.02, (auc_t, auc_j)
    assert mt["frontend_summary"]["num_pairs"] == mj["frontend_summary"]["num_pairs"]
    for group in ("track_classification_metrics", "intrinsics_metrics", "verifier_summary", "total_summary"):
        assert group in mt
    for out in ("jax", "port"):
        back = colmap.read_scene(str(tmp_path / out / "results" / "ba_output"))
        assert back.number_images() == VIEWS and back.number_tracks() > 0
    # every file the reference writes, and the retrieval metrics over the same pairs
    files = _results_files(str(tmp_path / "port"))
    assert files == _results_files(str(tmp_path / "jax"))
    for name in ("gtsfm_metrics_report.html", "process_graph.dot", "viewer.html", "plots/scene_3d.png",
                 "metrics/retrieval_metrics.json"):
        assert name in files, name
    rj, rt = mj["retrieval_metrics"], mt["retrieval_metrics"]
    assert rt["num_retrieved_pairs"] == rj["num_retrieved_pairs"] == mj["frontend_summary"]["num_pairs"]
    np.testing.assert_allclose(rt["gt_relative_rotation_deg"], rj["gt_relative_rotation_deg"], atol=1e-3)


@threads(8)
def test_runners_with_run_mvs_end_to_end(tmp_path, ring_folder):
    """Both runners' main with --run_mvs on ring_folder (the plane sweep
    at 16 depths and 2 sources to keep the CPU's time down): the same
    registered views with a depth map, dense point counts within
    MVS_COUNT_TOL, mvs_sec and its three parts, and a dense_points.ply
    that reads back with the port's count."""
    from gtsfm_tpu_torch.io.ply import read_ply

    args = ["--config_name", "unified", "--loader", "olsson", "--dataset_dirpath", ring_folder, "--run_mvs",
            "--output_root"]
    extra = ["detector.max_keypoints=512", "scene_optimizer.mvs_num_depths=16",
             "scene_optimizer.mvs_num_source_views=2"]
    assert j_runner.main(args + [str(tmp_path / "jax")] + extra) == 0
    assert runner.main(args + [str(tmp_path / "port")] + extra + ["scene_optimizer.device=cpu"]) == 0
    mj, mt = _scalars(str(tmp_path / "jax")), _scalars(str(tmp_path / "port"))
    dj, dt = mj["mvs_metrics"], mt["mvs_metrics"]
    assert dt["num_views_with_depth"] == dj["num_views_with_depth"] == VIEWS
    assert abs(dt["num_dense_points"] - dj["num_dense_points"]) <= MVS_COUNT_TOL * dj["num_dense_points"], (dt, dj)
    assert dt["mvs_sec"] >= dt["source_selection_sec"] + dt["depth_sec"] + dt["fusion_sec"] > 0
    points, colors = read_ply(str(tmp_path / "port" / "results" / "dense_points.ply"))
    assert len(points) == dt["num_dense_points"] > 0 and colors.shape == (len(points), 3)


@pytest.mark.parametrize("slot", ["vggt", "fastvggt", "anysplat"])
def test_feedforward_runners_end_to_end(tmp_path, slot):
    from gtsfm_tpu.frontend.feedforward import FeedforwardOptions as JFFOptions
    from gtsfm_tpu.scene import cluster_feedforward as j_cf
    from gtsfm_tpu_torch.frontend.feedforward import FeedforwardOptions
    from gtsfm_tpu_torch.io.ply import read_ply
    from gtsfm_tpu_torch.scene import cluster_feedforward as cf

    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)[:FF_VIEWS]
    views = chip_smoke.feedforward_views(R, t, order, hw=FF_HW, focal=FF_FOCAL)
    chip_smoke.write_olsson(str(tmp_path / "data"), views, R[order], t[order], FF_FOCAL)
    stride = 4 if slot == "fastvggt" else 1
    params = chip_smoke.feedforward_fixture(0, FF_HW, stride)
    saved_j, saved_t = dict(j_cf._MODEL_CACHE), dict(cf._MODEL_CACHE)
    try:
        j_cf._resolve_model(j_cf.ClusterFeedforwardOptions(model=JFFOptions(global_kv_stride=stride)), FF_HW, params)
        cf._resolve_model(cf.ClusterFeedforwardOptions(model=FeedforwardOptions(global_kv_stride=stride)), FF_HW,
                          convert.feedforward_state_dict(params), "cpu")
        args = ["--config_name", slot, "--loader", "olsson", "--dataset_dirpath", str(tmp_path / "data"),
                "--output_root"]
        extra = ["--run_gs", f"scene_optimizer.gs_iterations={FF_GS_STEPS}"] if slot == "anysplat" else []
        assert j_runner.main(args + [str(tmp_path / "jax")] + extra) == 0
        assert runner.main(args + [str(tmp_path / "port")] + extra + ["scene_optimizer.device=cpu"]) == 0
    finally:
        j_cf._MODEL_CACHE.clear()
        j_cf._MODEL_CACHE.update(saved_j)
        cf._MODEL_CACHE.clear()
        cf._MODEL_CACHE.update(saved_t)
    mj, mt = _scalars(str(tmp_path / "jax")), _scalars(str(tmp_path / "port"))
    assert mt["feedforward_metrics"]["num_tracks_ff"] == mj["feedforward_metrics"]["num_tracks_ff"] > 0
    reg_j, reg_t = len(mj["ba_pose_metrics"]["rotation_error_deg"]), len(mt["ba_pose_metrics"]["rotation_error_deg"])
    assert reg_t == reg_j == FF_VIEWS
    auc_j, auc_t = mj["ba_pose_metrics"]["pose_auc_@5.0_deg"], mt["ba_pose_metrics"]["pose_auc_@5.0_deg"]
    assert abs(auc_t - auc_j) <= 0.02, (auc_t, auc_j)
    if slot != "anysplat":
        assert "gaussian_splatting_metrics" not in mt
        return
    gj, gtm = mj["gaussian_splatting_metrics"], mt["gaussian_splatting_metrics"]
    np.testing.assert_allclose(gtm["initial_l1"], gj["initial_l1"], rtol=1e-3)
    assert gtm["final_l1"] < gtm["initial_l1"]
    for name in ("splats.ply", "gaussian_points.ply"):
        from gtsfm_tpu.io.ply import read_ply as j_read_ply

        if name == "splats.ply":
            from gtsfm_tpu_torch.splat.gs_data import load_ply

            assert load_ply(str(tmp_path / "port" / "results" / name)).max_gaussians == len(
                j_read_ply(str(tmp_path / "jax" / "results" / name))[0])
        else:
            assert len(read_ply(str(tmp_path / "port" / "results" / name))[0]) == len(
                j_read_ply(str(tmp_path / "jax" / "results" / name))[0])
