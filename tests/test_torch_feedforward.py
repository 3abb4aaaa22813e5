"""The port's compact feed-forward model and its cluster slot against the
reference, on the CPU, at FeedforwardOptions(dim=64, depth=1, num_heads=2)
(tests/scene/test_cluster_feedforward.py's dims).

- ``FeedforwardNet``: the reference's Flax init (``PRNGKey(0)``) carried
  across by ``convert.feedforward_state_dict``, with the full global block
  and with the FastVGGT block at strides 4 and 5 (42 tokens: the last
  group padded with zeros by 2 and by 3, the pads counted in its mean):
  pose outputs, confidence and track features to 2e-5, depth (an exp) to
  1e-4 relative;
- the tracking helpers (frame ranking, correlation tracking with its 3x3
  soft-argmax, BA-coverage selection) and both conversions to SfmData on
  the same predictions: equal index arrays, points to 1e-4;
- ``ClusterFeedforward`` / ``ClusterFastFeedforward`` on 3 frames with the
  same weights: without BA the same SfmData (index arrays equal, points
  and poses to 1e-4); with BA the same initial cost (1e-4 relative) and a
  final cost below it in both. The final costs are not held to each
  other: one fixed camera leaves the scale free, the damped LM steps solve
  a near-singular system, and float32 rounding sends the two packages'
  10 steps apart (776.6 against 779.1, and 1629.6 against 542.2 with
  the FastVGGT block, from one initial cost; my CPU run);
- ``depth_to_splats``; 33 frames raise (the 32-row frame embedding).

The reference's model cache is restored after each test that fills it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend import feedforward as j_ff
from gtsfm_tpu.geometry import SE3 as JSE3
from gtsfm_tpu.geometry import Cal3Bundler as JCal
from gtsfm_tpu.scene import cluster_feedforward as j_cf
from gtsfm_tpu_torch.frontend import feedforward as ff
from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
from gtsfm_tpu_torch.scene import cluster_feedforward as cf
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads

cap_threads()

SMALL = dict(dim=64, depth=1, num_heads=2)
HW = (64, 80)
TOL = 2e-5
TOL_DEPTH = 1e-4


def _params(stride: int, hw=HW):
    o = j_ff.FeedforwardOptions(**SMALL, global_kv_stride=stride)
    p = j_ff.FeedforwardNet(o).init(jax.random.PRNGKey(0), jnp.zeros((2,) + hw))["params"]
    return o, jax.tree.map(np.asarray, p)


def _images(B=3, hw=HW, seed=0):
    return np.random.default_rng(seed).uniform(size=(B,) + hw).astype(np.float32)


@pytest.fixture
def restore_caches():
    saved_j, saved_t = dict(j_cf._MODEL_CACHE), dict(cf._MODEL_CACHE)
    yield
    j_cf._MODEL_CACHE.clear()
    j_cf._MODEL_CACHE.update(saved_j)
    cf._MODEL_CACHE.clear()
    cf._MODEL_CACHE.update(saved_t)


@pytest.mark.parametrize("stride", [1, 4, 5])
def test_net_matches_reference(stride):
    o, params = _params(stride)
    imgs = _images()
    want = [np.asarray(a) for a in j_ff.FeedforwardNet(o).apply({"params": params}, jnp.asarray(imgs))]
    rec = ff.FeedforwardReconstruction(ff.FeedforwardOptions(**SMALL, global_kv_stride=stride),
                                       state_dict=convert.feedforward_state_dict(params), example_hw=HW,
                                       device="cpu")
    with torch.no_grad():
        got = [a.numpy() for a in rec.net(torch.as_tensor(imgs))]
    for name, g, w in zip(("pose", "depth", "conf", "track_feat"), got, want):
        assert g.shape == w.shape, name
        if name == "depth":
            np.testing.assert_allclose(g, w, rtol=TOL_DEPTH, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=TOL, err_msg=name)
    poses, depth, conf, focal = rec.run(imgs)
    jp, _jd, _jc, jf = j_ff.FeedforwardReconstruction(o, params=params, example_hw=HW).run(jnp.asarray(imgs))
    np.testing.assert_allclose(poses.R.numpy(), np.asarray(jp.R), atol=TOL)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jp.t), atol=TOL)
    np.testing.assert_allclose(focal.numpy(), np.asarray(jf), atol=TOL)


def test_more_frames_than_the_frame_embedding_raise():
    _o, params = _params(1, (32, 32))
    rec = ff.FeedforwardReconstruction(ff.FeedforwardOptions(**SMALL), convert.feedforward_state_dict(params),
                                       example_hw=(32, 32), device="cpu")
    with pytest.raises(ValueError, match="32 rows"):
        rec.run(_images(33, (32, 32)))


def _predictions(B=4, hw=(48, 64), P=16, seed=1):
    """Seeded poses, depth, patch confidence, unit track features and a
    calibration, in both packages."""
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=0.1, size=(B, 3)).astype(np.float32)
    t = rng.normal(size=(B, 3)).astype(np.float32)
    R = torch.linalg.matrix_exp(torch.as_tensor(np.cross(np.eye(3)[None], w[:, None, :]))).numpy().astype(np.float32)
    depth = rng.uniform(2, 6, (B,) + hw).astype(np.float32)
    conf = rng.uniform(0, 1, (B, hw[0] // P, hw[1] // P)).astype(np.float32)
    base = rng.normal(size=(hw[0] // P, hw[1] // P, 8)).astype(np.float32)
    feat = base[None] + 0.1 * rng.normal(size=(B,) + base.shape).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    f, u0, v0 = np.full(B, 50.0, np.float32), np.full(B, hw[1] / 2, np.float32), np.full(B, hw[0] / 2, np.float32)
    z = np.zeros(B, np.float32)
    cal = (f, z, z, u0, v0)
    j = (JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), JCal.create(*(jnp.asarray(a) for a in cal)))
    p = (SE3(R=torch.as_tensor(R), t=torch.as_tensor(t)), Cal3Bundler.create(*(torch.as_tensor(a) for a in cal)))
    return j, p, depth, conf, feat


def _assert_sfm_equal(got, want, tol):
    want = jax.tree.map(np.asarray, want)
    for k in ("track_mask", "meas_cam", "meas_track", "meas_mask", "pose_mask"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(want, k), err_msg=k)
    np.testing.assert_allclose(got.meas_uv.numpy(), want.meas_uv, atol=tol)
    np.testing.assert_allclose(got.points.numpy(), want.points, atol=tol, rtol=tol)


def test_tracking_helpers_match_reference():
    _j, _p, _depth, _conf, feat = _predictions()
    np.testing.assert_allclose(ff.rank_frames(torch.as_tensor(feat)).numpy(),
                               np.asarray(j_ff.rank_frames(jnp.asarray(feat))), atol=1e-6)
    q = feat[1].reshape(-1, 8)[::3]
    xy_t, vis_t = ff.track_queries(torch.as_tensor(feat), torch.as_tensor(q))
    xy_j, vis_j = j_ff.track_queries(jnp.asarray(feat), jnp.asarray(q))
    np.testing.assert_allclose(xy_t.numpy(), np.asarray(xy_j), atol=1e-5)
    np.testing.assert_allclose(vis_t.numpy(), np.asarray(vis_j), atol=1e-6)
    rng = np.random.default_rng(2)
    vis = rng.uniform(size=(40, 5))
    valid = vis > 0.4
    np.testing.assert_array_equal(ff.select_tracks_for_ba(vis, valid, 3), j_ff.select_tracks_for_ba(vis, valid, 3))


def test_sfm_conversions_match_reference():
    (jposes, jcal), (poses, cal), depth, conf, feat = _predictions()
    _assert_sfm_equal(ff.feedforward_to_sfm_data(poses, depth, conf, cal, max_tracks=50),
                      j_ff.feedforward_to_sfm_data(jposes, depth, conf, jcal, max_tracks=50), 1e-4)
    got = ff.feedforward_tracks_to_sfm_data(poses, depth, conf, cal, torch.as_tensor(feat))
    want = j_ff.feedforward_tracks_to_sfm_data(jposes, depth, conf, jcal, jnp.asarray(feat))
    assert got.number_tracks() == want.number_tracks() > 4
    _assert_sfm_equal(got, want, 1e-4)


@pytest.mark.parametrize("fast", [False, True])
def test_cluster_slot_matches_reference(restore_caches, fast):
    stride = 4 if fast else 1
    o, params = _params(stride)
    imgs = _images()
    B = len(imgs)
    f = np.full(B, 60.0, np.float32)
    z = np.zeros(B, np.float32)
    jcal = JCal.create(jnp.asarray(f), jnp.asarray(z), jnp.asarray(z), jnp.full(B, 40.0), jnp.full(B, 32.0))
    cal = Cal3Bundler.create(torch.as_tensor(f), torch.as_tensor(z), torch.as_tensor(z), torch.full((B,), 40.0),
                             torch.full((B,), 32.0))
    jcls, tcls = (j_cf.ClusterFastFeedforward, cf.ClusterFastFeedforward) if fast else (j_cf.ClusterFeedforward,
                                                                                       cf.ClusterFeedforward)
    sd = convert.feedforward_state_dict(params)
    for post_ba in (False, True):
        jo = j_cf.ClusterFeedforwardOptions(model=o, conf_threshold=0.3, run_post_ba=post_ba)
        to = cf.ClusterFeedforwardOptions(model=ff.FeedforwardOptions(**SMALL, global_kv_stride=stride),
                                          conf_threshold=0.3, run_post_ba=post_ba)
        want, wm = jcls(jo, params=params).run(imgs, jcal)
        got, gm = tcls(to, state_dict=sd, device="cpu").run(imgs, cal)
        assert gm["num_tracks_ff"] == wm["num_tracks_ff"] > 4
        if not post_ba:
            _assert_sfm_equal(got, want, TOL)
            np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(want.poses.t), atol=TOL)
            continue
        g, w = gm["post_ba"], wm["post_ba"]
        np.testing.assert_allclose(g["initial_cost"], w["initial_cost"], rtol=TOL_DEPTH)
        assert g["final_cost"] < g["initial_cost"] and w["final_cost"] < w["initial_cost"]


def test_depth_to_splats_matches_reference():
    (jposes, jcal), (poses, cal), depth, conf, _feat = _predictions()
    imgs = np.random.default_rng(3).uniform(size=depth.shape).astype(np.float32)
    want = jax.tree.map(np.asarray, j_cf.depth_to_splats(jposes, depth, conf, jcal, images=imgs, stride=4,
                                                          max_gaussians=300))
    got = cf.depth_to_splats(poses, depth, conf, cal, images=imgs, stride=4, max_gaussians=300)
    assert got.max_gaussians == want.means.shape[0] == 300
    for k in ("means", "log_scales", "quats", "opacity_logit", "colors"):
        np.testing.assert_allclose(getattr(got, k).numpy(), getattr(want, k), atol=1e-4, err_msg=k)
