"""The port's AnySplat-class model and the vggt_exact cluster slot against
the reference, on the CPU, at the reduced dims of
tests/frontend/test_anysplat.py (``_SMALL``) and of the reference's
weight-free vggt_exact model (cluster_feedforward.py's reduced VGGT and
track head).

- ``AnySplatModel``: the reference's ``AnySplatModel(_SMALL, seed=0)``
  draws (backbone ``PRNGKey(0)``, gaussian head ``PRNGKey(1)``) carried
  across: cameras to 2e-4, depth and confidence to 5e-4 (test_vggt_exact's
  tolerances), the raw gaussian field to 5e-4, and the assembly on one set
  of inputs equal; the assembled gaussians of both runs, every pixel kept,
  as sets (each field's columns sorted, to 1e-4 relative: the pixels'
  order follows an argsort of confidences that saturate at 1 in float32,
  so ties order as float32 rounding falls);
- ``ClusterFeedforward`` with ``backbone="vggt_exact"`` and no weights
  path: the reference builds its reduced model from ``PRNGKey(0)`` and
  ``PRNGKey(1)``, the port's cache gets the same draws; poses,
  calibrations, depth and pooled confidence to 5e-4, the frame-0 queries
  through the track head (4 iterations) and the same tracks (index arrays
  equal, measurements to 2e-2 px: test_torch_vggt.py's 4-iteration
  tolerance);
- the anysplat slot's gaussians (``SceneOptimizer._feedforward_splats``,
  VGGT again and AnySplat's own pass) with the reference's head swapped in
  for the port's seeded draw, every pixel kept, as sets;
- ``gaussian_means_as_tracks`` and the PLY writer and reader.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend import anysplat as j_as
from gtsfm_tpu.frontend import vggt as j_vggt
from gtsfm_tpu.frontend import vggt_track as j_track
from gtsfm_tpu.geometry import Cal3Bundler as JCal
from gtsfm_tpu.io import ply as j_ply
from gtsfm_tpu.scene import cluster_feedforward as j_cf
from gtsfm_tpu.scene.scene_optimizer import SceneOptimizer as JSceneOptimizer
from gtsfm_tpu_torch.frontend import anysplat, vggt
from gtsfm_tpu_torch.frontend.vggt_track import TrackOptions
from gtsfm_tpu_torch.geometry import Cal3Bundler
from gtsfm_tpu_torch.io import ply
from gtsfm_tpu_torch.scene import cluster_feedforward as cf
from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads

cap_threads()

SMALL = dict(embed_dim=64, depth=2, num_heads=4, dino_depth=2, dino_heads=4, dino_pretrain_grid=4,
             camera_trunk_depth=2, camera_iterations=2, dpt_features=32, dpt_out_channels=(16, 32, 64, 64),
             intermediate_layer_idx=(0, 0, 1, 1))
TOL_CAM = 2e-4
TOL = 5e-4
TOL_TRACK_PX_4 = 2e-2


def _split(sd: dict):
    """A converted state_dict -> (the VGGT keys, the gaussian head's DPTHead)."""
    head = anysplat.DPTHead(vggt.VGGTOptions(**SMALL), SMALL["dpt_features"], SMALL["dpt_out_channels"],
                            anysplat.GAUSSIAN_CHANNELS)
    head.load_state_dict({k[len("gaussian_head."):]: v for k, v in sd.items() if k.startswith("gaussian_head.")})
    return {k: v for k, v in sd.items() if not k.startswith("gaussian_head.")}, head


@pytest.fixture
def restore_caches():
    saved_j, saved_t = dict(j_cf._MODEL_CACHE), dict(cf._MODEL_CACHE)
    yield
    j_cf._MODEL_CACHE.clear()
    j_cf._MODEL_CACHE.update(saved_j)
    cf._MODEL_CACHE.clear()
    cf._MODEL_CACHE.update(saved_t)


ALL = 2 * 56 * 56  # every pixel of two 56x56 frames
GS_FIELDS = ("means", "log_scales", "quats", "opacity_logit", "colors")


def _assert_gaussian_sets_equal(got, want, rtol=1e-4):
    want = jax.tree.map(np.asarray, want)
    assert got.max_gaussians == want.means.shape[0]
    for k in GS_FIELDS:
        g, w = getattr(got, k).numpy(), getattr(want, k)
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(np.sort(g, axis=0), np.sort(w, axis=0), rtol=rtol, atol=rtol * scale,
                                   err_msg=k)


@pytest.fixture(scope="module")
def pair():
    jm = j_as.AnySplatModel(j_vggt.VGGTOptions(**SMALL),
                            splat_options=j_as.AnySplatOptions(max_gaussians=ALL, conf_threshold=0.0))
    sd, head = _split(convert.vggt_state_dict(jax.tree.map(np.asarray, jm.params)))
    tm = anysplat.AnySplatModel(vggt.VGGTModel(vggt.VGGTOptions(**SMALL), state_dict=sd, device="cpu"),
                                anysplat.AnySplatOptions(max_gaussians=ALL, conf_threshold=0.0), gaussian_head=head)
    return jm, tm


def test_anysplat_matches_reference(pair):
    jm, tm = pair
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 56, 56, 3)).astype(np.float32)
    want = jm.run(jnp.asarray(imgs))
    got = tm.run(imgs)
    for k in ("extrinsic", "intrinsic"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL_CAM, atol=TOL_CAM, err_msg=k)
    for k in ("depth", "depth_conf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL, err_msg=k)
    fields_j = [np.asarray(a) for a in j_as._anysplat_forward(jm.params, jnp.asarray(imgs), jm.options)]
    with torch.no_grad():
        raw = anysplat._gaussian_field(tm.vggt.net, tm.gaussian_head, torch.as_tensor(imgs).permute(0, 3, 1, 2))[-1]
    np.testing.assert_allclose(raw.numpy(), fields_j[-1], rtol=TOL, atol=TOL)
    same = jax.tree.map(np.asarray, jm._assemble_gaussians(*fields_j))
    mine = tm._assemble_gaussians(*fields_j)
    for k in GS_FIELDS + ("alive",):
        np.testing.assert_array_equal(getattr(mine, k).numpy(), getattr(same, k), err_msg=k)
    _assert_gaussian_sets_equal(got["gaussians"], want["gaussians"])
    np.testing.assert_allclose(np.linalg.norm(got["gaussians"].quats.numpy(), axis=-1), 1.0, atol=1e-5)


def _reference_vggt_exact_sd():
    """The reference's weight-free vggt_exact model's draws, converted."""
    vo = j_vggt.VGGTOptions(**cf.REDUCED_VGGT)
    params = j_vggt.init_params(jax.random.PRNGKey(0), vo)
    params["track_head"] = j_track.init_track_params(
        jax.random.PRNGKey(1), j_track.TrackOptions(**{k: v for k, v in cf.REDUCED_TRACK.items()
                                                       if k != "dpt_features"}), vo)
    return convert.vggt_state_dict(jax.tree.map(np.asarray, params))


def _cal(B, f=60.0, c=32.0):
    z = np.zeros(B, np.float32)
    full = [np.full(B, v, np.float32) for v in (f, c, c)]
    return (JCal.create(jnp.asarray(full[0]), jnp.asarray(z), jnp.asarray(z), jnp.asarray(full[1]),
                        jnp.asarray(full[2])),
            Cal3Bundler.create(torch.as_tensor(full[0]), torch.as_tensor(z), torch.as_tensor(z),
                               torch.as_tensor(full[1]), torch.as_tensor(full[2])))


def test_vggt_exact_slot_matches_reference(restore_caches):
    imgs = np.random.default_rng(1).uniform(size=(3, 64, 64)).astype(np.float32)
    jcal, cal = _cal(3)
    model = vggt.VGGTModel(vggt.VGGTOptions(**cf.REDUCED_VGGT), state_dict=_reference_vggt_exact_sd(), device="cpu")
    assert model.track_options == TrackOptions(**{**cf.REDUCED_TRACK, "iters": 4})
    cf._MODEL_CACHE[("vggt_exact", "", (64, 64), "cpu")] = model
    opts = dict(backbone="vggt_exact", run_post_ba=False, conf_threshold=0.3)
    want, wm, (wp, wd, wc) = j_cf.ClusterFeedforward(j_cf.ClusterFeedforwardOptions(**opts)).run_raw(imgs, jcal)
    got, gm, (tp, td, tc) = cf.ClusterFeedforward(cf.ClusterFeedforwardOptions(**opts), device="cpu").run_raw(imgs, cal)
    np.testing.assert_allclose(tp.R.numpy(), np.asarray(wp.R), atol=TOL_CAM)
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(wp.t), atol=TOL_CAM)
    np.testing.assert_allclose(td, np.asarray(wd), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc, np.asarray(wc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.cal.f.numpy(), np.asarray(want.cal.f), rtol=TOL_CAM)
    assert gm["num_tracks_ff"] == wm["num_tracks_ff"] > 0
    want = jax.tree.map(np.asarray, want)
    for k in ("track_mask", "meas_cam", "meas_track", "meas_mask"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(want, k), err_msg=k)
    np.testing.assert_allclose(got.meas_uv.numpy(), want.meas_uv, atol=TOL_TRACK_PX_4)
    np.testing.assert_allclose(got.points.numpy(), want.points, rtol=TOL, atol=TOL)


def test_anysplat_slot_splats_match_reference(restore_caches, monkeypatch):
    imgs = np.random.default_rng(2).uniform(size=(2, 64, 64)).astype(np.float32)
    jcal, cal = _cal(2)
    sd = _reference_vggt_exact_sd()
    cf._MODEL_CACHE[("vggt_exact", "", (64, 64), "cpu")] = vggt.VGGTModel(vggt.VGGTOptions(**cf.REDUCED_VGGT),
                                                                          state_dict=sd, device="cpu")
    j_head = j_as.init_gaussian_head(jax.random.PRNGKey(1), j_vggt.VGGTOptions(**cf.REDUCED_VGGT))
    _, head = _split(convert.vggt_state_dict({**jax.tree.map(np.asarray, {"gaussian_head": j_head}),
                                              **_reference_params_stub()}))
    monkeypatch.setattr(anysplat, "init_gaussian_head", lambda o, seed: head)
    opts = dict(backbone="vggt_exact", run_post_ba=False, conf_threshold=0.0)
    jo, to = j_cf.ClusterFeedforwardOptions(**opts), cf.ClusterFeedforwardOptions(**opts)
    want = JSceneOptimizer._feedforward_splats(j_cf.ClusterFeedforward(jo), imgs, None, None, jcal, None, jo)
    got = SceneOptimizer._feedforward_splats(cf.ClusterFeedforward(to, device="cpu"), imgs, None, None, cal, None, to)
    assert got.max_gaussians == ALL
    _assert_gaussian_sets_equal(got, want)


def _reference_params_stub():
    """The reduced model's backbone keys, so vggt_state_dict parses a tree
    that carries only a gaussian head."""
    vo = j_vggt.VGGTOptions(**cf.REDUCED_VGGT)
    return jax.tree.map(np.asarray, j_vggt.init_params(jax.random.PRNGKey(0), vo))


def test_gaussian_points_and_ply_match_reference(pair, tmp_path):
    jm, _tm = pair
    imgs = np.random.default_rng(3).uniform(0, 1, (2, 56, 56, 3)).astype(np.float32)
    gj = jm.run(jnp.asarray(imgs))["gaussians"]
    pts_j, cols_j = j_as.gaussian_means_as_tracks(None, gj, max_points=100)
    pts_t, cols_t = anysplat.gaussian_means_as_tracks(None, convert.gs_data(jax.tree.map(np.asarray, gj)),
                                                      max_points=100)
    np.testing.assert_array_equal(pts_t, pts_j)
    np.testing.assert_array_equal(cols_t, cols_j)
    ply.write_ply(str(tmp_path / "t.ply"), pts_t, cols_t)
    j_ply.write_ply(str(tmp_path / "j.ply"), pts_t, cols_t)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back, back_cols = ply.read_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(back, pts_t)
    gray = np.linspace(0, 1, len(pts_t))
    ply.write_ply(str(tmp_path / "g.ply"), pts_t, gray)
    j_ply.write_ply(str(tmp_path / "gj.ply"), pts_t, gray)
    assert (tmp_path / "g.ply").read_bytes() == (tmp_path / "gj.ply").read_bytes()
    assert ply.read_ply(str(tmp_path / "g.ply"))[0].shape == (len(pts_t), 3)
