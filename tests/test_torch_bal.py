"""The port's BAL reader and the runner's --bal tool mode against the
reference, on the CPU, on small problems written in
tests/io/test_bal.py's convention (cameras looking down -z, p = -P/P.z).

- ``read_bal``: equal index arrays and masks; poses, calibrations,
  points and measurements to 1e-6 (the rotations' Rodrigues formula in
  float32 in each package);
- a noise-free problem reprojects to 0 through the port's camera model;
- ``runner.main(["--bal", ...])`` in both packages: the same printed
  problem size, initial and final costs within 1e-4 relative, and COLMAP
  exports that read back to the same cameras and tracks, rotations and
  focal lengths within 1e-4, and camera centers and points within 1e-4
  up to the scale that one fixed camera leaves free;
- a .bz2 and a .gz file read as the plain one.
"""

import bz2
import gzip
import re

import jax
import numpy as np
import torch

from gtsfm_tpu import runner as j_runner
from gtsfm_tpu.io import colmap as j_colmap
from gtsfm_tpu.io.bal import read_bal as j_read_bal
from gtsfm_tpu_torch import runner
from gtsfm_tpu_torch.io import colmap
from gtsfm_tpu_torch.io.bal import read_bal
from tests.io.test_bal import _write_bal
from tests.torch_threads import cap_threads

cap_threads()

TOL = 1e-6
COST_TOL = 1e-4
POSE_TOL = 1e-4


def _assert_scenes_match(t, j, tol=TOL):
    j = jax.tree.map(np.asarray, j)
    for k in ("pose_mask", "track_mask", "meas_cam", "meas_track", "meas_mask"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), getattr(j, k))
    for k in ("points", "meas_uv"):
        np.testing.assert_allclose(getattr(t, k).numpy(), getattr(j, k), rtol=tol, atol=tol)
    np.testing.assert_allclose(t.poses.R.numpy(), j.poses.R, atol=tol)
    np.testing.assert_allclose(t.poses.t.numpy(), j.poses.t, rtol=tol, atol=tol)
    for k in ("f", "k1", "k2", "u0", "v0"):
        np.testing.assert_allclose(getattr(t.cal, k).numpy(), getattr(j.cal, k), rtol=tol, atol=tol)


def test_read_bal_matches_reference(tmp_path):
    path = str(tmp_path / "problem.txt")
    n_obs = _write_bal(path, np.random.default_rng(0), n_cam=5, n_pts=80)
    t = read_bal(path)
    assert t.number_images() == 5 and t.number_tracks() == 80 and t.number_measurements() == n_obs
    _assert_scenes_match(t, j_read_bal(path))
    text = open(path).read()
    for suffix, opener in ((".bz2", bz2.open), (".gz", gzip.open)):
        with opener(path + suffix, "wt") as f:
            f.write(text)
        _assert_scenes_match(read_bal(path + suffix), j_read_bal(path), tol=0.0)


def test_noise_free_problem_reprojects_exactly(tmp_path):
    path = str(tmp_path / "problem.txt")
    _write_bal(path, np.random.default_rng(0), noise=0.0)
    data = read_bal(path)
    cam = data.cameras().map(lambda a: a[data.meas_cam])
    uv, depth = cam.project(data.points[data.meas_track])
    assert float(depth.min()) > 0
    assert float(torch.linalg.norm(uv - data.meas_uv, dim=-1).max()) < 1e-2


def _cost(out: str, package: str) -> tuple:
    m = re.search(r"BA: cost (\S+) -> (\S+) in (\d+) iterations", out)
    assert m, f"{package}: no cost line in {out!r}"
    return float(m.group(1)), float(m.group(2))


def test_run_bal_matches_reference(tmp_path, capsys):
    path = str(tmp_path / "problem.txt")
    _write_bal(path, np.random.default_rng(1), n_cam=5, n_pts=80, noise=1.0)
    assert j_runner.main(["--bal", path, "--output_root", str(tmp_path / "jax")]) == 0
    out_j = capsys.readouterr().out
    assert runner.main(["--bal", path, "--output_root", str(tmp_path / "port"), "scene_optimizer.device=cpu"]) == 0
    out_t = capsys.readouterr().out
    size = re.compile(r"BAL problem: .*")
    assert size.search(out_t).group(0) == size.search(out_j).group(0)
    (c0_j, cf_j), (c0_t, cf_t) = _cost(out_j, "reference"), _cost(out_t, "port")
    np.testing.assert_allclose(c0_t, c0_j, rtol=COST_TOL)  # both printed to 4 digits
    np.testing.assert_allclose(cf_t, cf_j, rtol=COST_TOL)
    assert cf_t < c0_t
    back_t = colmap.read_scene(str(tmp_path / "port" / "bal_output"))
    back_j = jax.tree.map(np.asarray, j_colmap.read_scene(str(tmp_path / "jax" / "bal_output")))
    assert back_t.number_images() == int(back_j.pose_mask.sum()) == 5
    np.testing.assert_array_equal(back_t.meas_cam.numpy(), back_j.meas_cam)
    np.testing.assert_array_equal(back_t.meas_track.numpy(), back_j.meas_track)
    # camera 0 fixed leaves the scale about its center free (here the two LM
    # runs end 1.8% apart in scale at equal costs): rotations and
    # focal lengths are held as they are, camera centers and points
    # relative to camera 0's center, each set over its own norm
    np.testing.assert_allclose(back_t.poses.R.numpy(), back_j.poses.R, atol=POSE_TOL)
    np.testing.assert_allclose(back_t.cal.f.numpy(), back_j.cal.f, rtol=POSE_TOL)
    for a, b in ((back_t.poses.t.numpy(), back_j.poses.t), (back_t.points.numpy(), back_j.points)):
        da, db = a - back_t.poses.t.numpy()[0], b - back_j.poses.t[0]
        np.testing.assert_allclose(da / np.linalg.norm(da), db / np.linalg.norm(db), atol=POSE_TOL)


def test_run_bal_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        import pytest

        pytest.skip("this host has a CUDA device")
    path = str(tmp_path / "problem.txt")
    _write_bal(path, np.random.default_rng(2))
    try:
        runner.main(["--bal", path, "--output_root", str(tmp_path / "out")])
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("--bal ran without a card and without scene_optimizer.device=cpu")
    assert not (tmp_path / "out").exists()
