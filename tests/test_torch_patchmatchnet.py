"""The port's PatchmatchNet against the reference, on the CPU.

One seeded state_dict in the official model_000007.ckpt layout
(``chip_smoke.pmnet_fixture``, random BatchNorm statistics) feeds both
packages: the reference through its ``convert_torch_state_dict``, the port
as it is.

- the feature net on 3 views at 64x80: each stage within 1e-5 of the
  stage's largest magnitude (float32 convolutions in another order);
- the full forward at 64x80, V=3, with the reference's stage-3 random
  draw (``jax.random.uniform`` of its key) replayed: depth within 1e-4
  relative (and absolute, where the refinement takes it near 0) on every
  pixel, confidence within 1e-4 on every pixel but those where the
  photometric confidence's integer index sits on a boundary;
- ``convert.patchmatchnet_state_dict`` both ways: the reference's tree
  carried to the official layout and back through
  ``convert_torch_state_dict`` is the same tree (to 1e-6), and the port
  on the carried state_dict gives the original's forward;
- ``PatchmatchNetMVS`` raises without weights (the reference raises), and
  on ``make_synthetic_scene`` with the same draw in both packages gives
  the reference's views, depth maps (1e-4 on >= 99% of the pixels) and a
  dense point count within 1%;
- ``load_torch_weights`` reads a checkpoint saved as the official one is
  (``{"model": ...}`` with ``module.`` prefixes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.densify import mvs as j_mvs
from gtsfm_tpu.densify import patchmatchnet as j_pm
from gtsfm_tpu_torch.densify import mvs
from gtsfm_tpu_torch.densify import patchmatchnet as pm
from gtsfm_tpu_torch.utils import convert
from tests.common.test_sfm_data import make_synthetic_scene
from tests.torch_threads import cap_threads

cap_threads()

V, H, W = 3, 64, 80
FEAT_TOL = 1e-5
TOL = 1e-4
PIXEL_SHARE = 0.99


@pytest.fixture(scope="module")
def weights():
    sd = chip_smoke.pmnet_fixture(0)
    return sd, j_pm.convert_torch_state_dict(sd)


def _net(sd) -> pm.PatchmatchNet:
    return pm.build_net(sd, device="cpu")


def _inputs(seed=0):
    """Random images and a rig of V views (the reference test's, its
    baseline along x, here also along y: with a pure x baseline every
    sample of the last row lands on the row H - 1 itself, where the warp's
    in-bounds test decides on float32 rounding): (V, H, W, 3) images,
    per-stage (V, 4, 4) projections, the depth range."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    projs = []
    for scale in (0.5, 0.25, 0.125):
        K = np.array([[W * scale, 0, W * scale / 2], [0, W * scale, H * scale / 2], [0, 0, 1]], np.float32)
        mats = []
        for v in range(V):
            E = np.eye(4, dtype=np.float32)
            E[0, 3] = 0.08 * v
            E[1, 3] = 0.03 * v
            P = np.eye(4, dtype=np.float32)
            P[:3, :4] = K @ E[:3, :4]
            mats.append(P)
        projs.append(np.stack(mats))
    return imgs, projs, np.float32(1.0), np.float32(4.0)


def _port_forward(net, imgs, projs, dmin, dmax, u):
    return net(torch.as_tensor(imgs).permute(0, 3, 1, 2), *(torch.as_tensor(p) for p in projs), dmin, dmax,
               init_uniform=torch.as_tensor(np.array(u)))


def _jax_draw(seed=0):
    return jax.random.uniform(jax.random.PRNGKey(seed), (pm.RANDOM_INIT_SAMPLES, H // 8, W // 8))


def _conf_boundary(sd, imgs, projs, dmin, dmax, u):
    """Pixels (H, W) whose photometric index, sum_d d p(d) over stage 1,
    lies within 1e-4 of an integer: the integer part may differ there."""
    net = _net(sd)
    captured = {}
    real = pm._regress_depth

    def spy(depth_sample, score, stage_idx, last_iter):
        if stage_idx == 0:
            captured["score"] = score
        return real(depth_sample, score, stage_idx, last_iter)

    pm._regress_depth = spy
    try:
        _port_forward(net, imgs, projs, dmin, dmax, u)
    finally:
        pm._regress_depth = real
    s = captured["score"]
    idx = torch.sum(torch.arange(s.shape[0], dtype=torch.float32)[:, None, None] * s, 0).numpy()
    near = np.abs(idx - np.round(idx)) < 1e-4
    return np.repeat(np.repeat(near, 2, 0), 2, 1)


def test_feature_net_matches_reference(weights):
    sd, params = weights
    img = np.random.default_rng(1).uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    with torch.no_grad():
        got = _net(sd).feature(torch.as_tensor(img).permute(0, 3, 1, 2))
    for v in range(V):
        want = j_pm.feature_net(params["feature"], jnp.asarray(img[v]))
        for stage in (1, 2, 3):
            tv = got[stage][v].permute(1, 2, 0).numpy()
            jv = np.asarray(want[stage])
            assert np.abs(tv - jv).max() <= FEAT_TOL * max(np.abs(jv).max(), 1.0), (v, stage)


def test_upsample_matches_jax_resize_at_the_edges():
    x = np.random.default_rng(2).standard_normal((5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (10, 14, 3), method="linear"))
    got = pm._upsample_linear2x(torch.as_tensor(x).permute(2, 0, 1)[None])[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_forward_matches_reference(weights):
    sd, params = weights
    imgs, projs, dmin, dmax = _inputs()
    u = _jax_draw()
    want = j_pm.patchmatchnet_forward(params, jnp.asarray(imgs), *(jnp.asarray(p) for p in projs), jnp.float32(dmin),
                                      jnp.float32(dmax), jax.random.PRNGKey(0))
    got = _port_forward(_net(sd), imgs, projs, dmin, dmax, u)
    jd, jc = np.asarray(want.depth), np.asarray(want.confidence)
    td, tc = got.depth.numpy(), got.confidence.numpy()
    assert td.shape == jd.shape == (H, W) and tc.shape == (H, W)
    np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
    boundary = _conf_boundary(sd, imgs, projs, dmin, dmax, u)
    assert boundary.mean() < 0.01
    np.testing.assert_allclose(tc[~boundary], jc[~boundary], atol=TOL)


def test_state_dict_converter_both_ways(weights):
    sd, params = weights
    carried = convert.patchmatchnet_state_dict(params)
    assert set(carried) == set(pm.PatchmatchNet().state_dict())
    back = j_pm.convert_torch_state_dict(carried)
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-7)
    imgs, projs, dmin, dmax = _inputs(3)
    u = _jax_draw(3)
    a = _port_forward(_net(sd), imgs, projs, dmin, dmax, u)
    b = _port_forward(_net(carried), imgs, projs, dmin, dmax, u)
    np.testing.assert_allclose(b.depth.numpy(), a.depth.numpy(), rtol=TOL, atol=TOL)


def test_load_torch_weights_reads_the_official_layout(weights, tmp_path):
    path = str(tmp_path / "model_000007.ckpt")
    chip_smoke.write_mvs_weights(path, 0)
    sd = pm.load_torch_weights(path)
    assert set(sd) == set(pm.PatchmatchNet().state_dict())
    for k, v in weights[0].items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
    jax.tree.map(np.testing.assert_array_equal, j_pm.load_torch_weights(path), weights[1])


def test_patchmatchnet_mvs_matches_reference(weights, monkeypatch):
    sd, params = weights
    with pytest.raises(RuntimeError, match="requires"):
        j_pm.PatchmatchNetMVS(j_mvs.MVSOptions())
    with pytest.raises(RuntimeError, match="requires"):
        pm.PatchmatchNetMVS(mvs.MVSOptions(), device="cpu")
    data = make_synthetic_scene(n_cams=4, n_tracks=60)
    images = np.random.default_rng(0).uniform(0, 1, (4, 48, 64)).astype(np.float32)
    opts = dict(num_source_views=2)
    t_mvs = pm.PatchmatchNetMVS(mvs.MVSOptions(**opts), state_dict=sd, seed=0, device="cpu")
    # the reference on the port's draw: one torch.Generator draw for the run
    u = jnp.asarray(torch.rand((pm.RANDOM_INIT_SAMPLES, 6, 8), generator=torch.Generator().manual_seed(0)).numpy())
    monkeypatch.setattr(j_pm, "_depth_init_random",
                        lambda key, dmin, dmax, h, w: 1.0 / (1.0 / dmax + (u + jnp.arange(48.0)[:, None, None]) / 48
                                                             * (1.0 / dmin - 1.0 / dmax)))
    monkeypatch.setattr(j_pm, "patchmatchnet_forward", jax.jit(j_pm.patchmatchnet_forward.__wrapped__))
    j_run = j_pm.PatchmatchNetMVS(j_mvs.MVSOptions(**opts), params=params)
    j_depths, _ = j_run.compute_depths(data, images)
    jp, _jc, jm = j_mvs.fuse_depth_maps(*j_run.compute_depths(data, images), data, images, j_run.options)
    t_data = convert.sfm_data(jax.tree.map(np.asarray, data))
    t_depths, _ = t_mvs.compute_depths(t_data, images)
    tp, _tc, tm = t_mvs.run(t_data, images)
    assert sorted(t_depths) == sorted(j_depths) and len(j_depths) >= 2
    for i in j_depths:
        close = np.abs(t_depths[i] - j_depths[i]) <= TOL * np.maximum(np.abs(j_depths[i]), 1e-3)
        assert close.mean() >= PIXEL_SHARE
    assert tm["num_views_with_depth"] == jm["num_views_with_depth"]
    assert abs(tm["num_dense_points"] - jm["num_dense_points"]) <= 0.01 * max(jm["num_dense_points"], 1)
    assert {"source_selection_sec", "depth_sec", "fusion_sec"} <= set(tm)


def test_patchmatchnet_mvs_defaults_to_the_card(weights):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.PatchmatchNetMVS(mvs.MVSOptions(), state_dict=weights[0])
