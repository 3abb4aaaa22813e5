"""The port's host utilities against the reference: telemetry, the logger,
tracing, frustum overlaps, and the option fields they come with.

- ``TelemetryDB``: the same reports logged by both packages give the same
  rows in the three tables (timestamps and run ids aside).
- ``get_logger`` / ``StageTimer``: one handler whose lines carry the host,
  the process id and the torch device type (``cpu`` here); timings add up
  by name.
- ``device_trace``: a no-op without ``GTSFM_TPU_TRACE``; with it, a
  torch.profiler Chrome trace under <dir>/<tag>/, and an inner region
  inside a live capture writes nothing of its own.
- ``sample_frustum_points``, ``in_frustum`` and ``frustum_overlap_fraction``
  within 1e-5 of the reference's, with a distorted Cal3Bundler.
- ``use_mesh``, ``direct_max_keypoints`` and ``telemetry_db`` parse as
  overrides into options equal to the reference's.
- The OpenCV detectors (sift, root_sift, orb, brisk, kaze, combination)
  through both registries: equal keypoints, masks and descriptors.
"""

import logging
import os
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.common.telemetry import TelemetryDB as JTelemetryDB
from gtsfm_tpu.configs import config as j_config
from gtsfm_tpu.frontend.reports import TwoViewEstimationReport as JReport
from gtsfm_tpu.geometry import SE3 as JSE3, Cal3Bundler as JCal
from gtsfm_tpu.utils import overlap_frustums as jf
from gtsfm_tpu_torch.common.telemetry import TelemetryDB
from gtsfm_tpu_torch.configs import config
from gtsfm_tpu_torch.frontend.reports import TwoViewEstimationReport
from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
from gtsfm_tpu_torch.utils import overlap_frustums as tf
from gtsfm_tpu_torch.utils import tracing
from gtsfm_tpu_torch.utils.logger import StageTimer, get_logger
from tests.torch_threads import cap_threads

cap_threads()

TOL = 1e-5


def _rows(path):
    with sqlite3.connect(path) as conn:
        return {
            "two_view_results": conn.execute("SELECT i1, i2, num_matches, num_inliers, inlier_ratio, valid, "
                                             "r_error_deg, u_error_deg FROM two_view_results").fetchall(),
            "stage_timings": conn.execute("SELECT stage, seconds FROM stage_timings").fetchall(),
            "run_metadata": conn.execute("SELECT key, value FROM run_metadata").fetchall(),
        }


def test_telemetry_rows_as_the_reference(tmp_path):
    fields = [(0, 1, 120, 80, 0.667, True, 1.5, 2.5), (0, 2, 40, 3, 0.075, False, None, None)]
    for cls, rep, name in ((TelemetryDB, TwoViewEstimationReport, "port"), (JTelemetryDB, JReport, "jax")):
        db = cls(str(tmp_path / name / "t.sqlite"), run_id="run")
        db.log_metadata(num_images=3, num_pairs=2)
        db.log_two_view_results([rep(*f) for f in fields])
        db.log_stage("two_view", 1.25)
        assert db.query("SELECT COUNT(*) FROM two_view_results") == [(2,)]
    assert _rows(str(tmp_path / "port" / "t.sqlite")) == _rows(str(tmp_path / "jax" / "t.sqlite"))


def test_logger_and_stage_timer():
    log = get_logger("gtsfm_tpu_torch.test")
    assert get_logger("gtsfm_tpu_torch.test") is log and len(log.handlers) == 1
    assert log.level == logging.INFO and not log.propagate
    fmt = log.handlers[0].formatter._fmt
    assert f"({os.getpid()}/cpu)" in fmt
    timer = StageTimer()
    for _ in range(2):
        with timer.time("load"):
            pass
    with timer.time("match"):
        pass
    assert set(timer.timings) == {"load", "match"} and timer.timings["load"] >= 0
    assert [m.name for m in timer.as_metrics()] == ["load_sec", "match_sec"]


def test_device_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("GTSFM_TPU_TRACE", raising=False)
    with tracing.device_trace("off"):
        torch.ones(3).sum()
    monkeypatch.setenv("GTSFM_TPU_TRACE", str(tmp_path))
    with tracing.device_trace("outer"):
        with tracing.device_trace("inner"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert sorted(os.listdir(tmp_path)) == ["outer"]
    assert os.path.getsize(tmp_path / "outer" / "trace.json") > 0
    assert not tracing._ACTIVE


def test_frustums_against_reference():
    rng = np.random.default_rng(0)
    ang = 0.3
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32)), (R, np.array([1.0, 0.2, -0.3], np.float32))]
    cal = dict(f=300.0, k1=-0.02, k2=0.003, u0=160.0, v0=120.0)
    jcal, tcal = JCal.create(**cal), Cal3Bundler.create(**cal)
    jp = [JSE3(R=jnp.asarray(r), t=jnp.asarray(t)) for r, t in poses]
    tp = [SE3(R=torch.as_tensor(r), t=torch.as_tensor(t)) for r, t in poses]
    got = tf.sample_frustum_points(tp[0], tcal, 320, 240, 0.5, 20.0, 5)
    want = jf.sample_frustum_points(jp[0], jcal, 320, 240, 0.5, 20.0, 5)
    assert got.shape == want.shape == (125, 3)
    np.testing.assert_allclose(got, want, atol=TOL * 20, rtol=TOL)
    pts = np.concatenate([want, rng.uniform(-10, 10, (200, 3)).astype(np.float32)])
    np.testing.assert_array_equal(tf.in_frustum(pts, tp[1], tcal, 320, 240, 0.5, 20.0),
                                  jf.in_frustum(pts, jp[1], jcal, 320, 240, 0.5, 20.0))
    for a, b in ((0, 1), (1, 0), (0, 0)):
        g = tf.frustum_overlap_fraction(tp[a], tcal, tp[b], tcal, 320, 240)
        w = jf.frustum_overlap_fraction(jp[a], jcal, jp[b], jcal, 320, 240)
        assert abs(g - w) <= TOL and 0.0 < w <= 1.0
    assert tf.frustum_overlap_fraction(tp[0], tcal, tp[0], tcal, 320, 240) == 1.0


def test_new_option_fields_parse_as_overrides(tmp_path):
    ov = ["scene_optimizer.use_mesh=false", "scene_optimizer.direct_max_keypoints=512",
          f"scene_optimizer.telemetry_db={tmp_path / 't.sqlite'}"]
    so_t = config.build_scene_optimizer(config.load_config("unified", ov + ["scene_optimizer.device=cpu"]))
    so_j = j_config.build_scene_optimizer(j_config.load_config("unified", ov))
    for name in ("use_mesh", "direct_max_keypoints", "telemetry_db"):
        assert getattr(so_t.options, name) == getattr(so_j.options, name)
    assert so_t.options.use_mesh is False and so_t.options.direct_max_keypoints == 512
    assert so_t._telemetry.path == str(tmp_path / "t.sqlite")


@pytest.mark.parametrize("name", ["sift", "root_sift", "orb", "brisk", "kaze", "combination"])
def test_opencv_detectors_against_reference(name):
    """Both registries' OpenCV detectors on two seeded smooth images: the
    same keypoints, masks and descriptors (the same host OpenCV calls).
    Where this OpenCV build lacks the detector's factory (OpenCV 5 moved
    BRISK and KAZE out of the main module), both packages raise the same
    AttributeError when it is built."""
    import cv2

    from gtsfm_tpu.frontend.registry import build_detector as j_build_detector
    from gtsfm_tpu_torch.frontend.registry import build_detector
    from tests.test_torch_loftr import smooth_pair

    images = np.stack(smooth_pair(hw=(120, 160), seed=6))
    cfg = {"name": name, "max_keypoints": 128}
    factory = {"brisk": "BRISK_create", "kaze": "KAZE_create"}.get(name, "SIFT_create")
    if not hasattr(cv2, factory):
        for build in (build_detector, j_build_detector):
            with pytest.raises(AttributeError, match=factory):
                build(cfg)
        return
    got = build_detector(cfg).detect_batch(torch.as_tensor(images))
    want = j_build_detector(cfg).detect_batch(images)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got[1].any() and got[0].shape == (2, 128, 2) and got[2].dtype == np.float32
