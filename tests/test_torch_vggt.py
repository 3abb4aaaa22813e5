"""The port's VGGT and its track head against the reference, on the CPU, at
the reduced dims of tests/frontend/test_vggt_exact.py (``_OPTS``: 64-d, 4
heads, 2 layer pairs, a 4x4 pretrain grid, DPT 32 / (16, 32, 64, 64)).

- The reference's ``init_params`` and ``init_track_params`` (their
  ``jax.random`` draws) carried across by ``convert.vggt_state_dict``:
  every aggregator layer and the camera head to 2e-4, depth and confidence
  to 5e-4 (the reference test's tolerances), at the pretrain grid (56x56)
  and at interpolated ones (42x56, 70x84: the bicubic position embedding,
  one axis at the pretrain size);
- the track head (features, correlation pyramid, update former) on
  replayed query points: after 2 iterations tracks to 5e-3 px, visibility
  and confidence to 1e-4 (test_vggt_track_exact.py's setup and
  tolerances); ``VGGTModel.track`` (4 iterations, as the reference reads
  the options off the weights) with tracks to 2e-2 px: the seeded head
  amplifies float32 rounding about 20 times an iteration (1e-6, 1e-5,
  2e-4, 5e-3 px after iterations 1-4, the same in both packages' orders),
  visibility and confidence to 1e-4;
- ``options_from_state_dict`` reads the reference converter's dims, the
  pose encoding's convention, the RoPE helper, and the chunked attention
  against one pass.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend import mast3r as j_mast3r
from gtsfm_tpu.frontend import vggt as j_vggt
from gtsfm_tpu.frontend import vggt_track as j_track
from gtsfm_tpu_torch.frontend import mast3r, vggt, vggt_track
from gtsfm_tpu_torch.utils import convert, numerics
from tests.torch_threads import cap_threads

cap_threads()

OPTS = dict(embed_dim=64, depth=2, num_heads=4, dino_depth=2, dino_heads=4, dino_pretrain_grid=4,
            num_register_tokens=4, camera_trunk_depth=2, camera_iterations=2, dpt_features=32,
            dpt_out_channels=(16, 32, 64, 64), intermediate_layer_idx=(0, 0, 1, 1))
TRACK = dict(latent_dim=32, hidden_size=48, corr_levels=3, corr_radius=2, depth=2, num_heads=8,
             num_virtual_tracks=8, iters=2)
TOL_AGG = 2e-4
TOL_DEPTH = 5e-4
TOL_TRACK_PX = 5e-3
TOL_TRACK_PX_4 = 2e-2  # after 4 iterations
TOL_VIS = 1e-4


@pytest.fixture(scope="module")
def models():
    jo = j_vggt.VGGTOptions(**OPTS)
    params = jax.tree.map(np.asarray, j_vggt.init_params(jax.random.PRNGKey(0), jo))
    params["track_head"] = jax.tree.map(np.asarray, j_track.init_track_params(
        jax.random.PRNGKey(1), j_track.TrackOptions(**TRACK), jo))
    sd = convert.vggt_state_dict(params)
    port = vggt.VGGTModel(vggt.VGGTOptions(**OPTS), state_dict=sd, device="cpu")
    return jo, params, port


def _images(hw, seed=0, S=2):
    return np.random.default_rng(seed).uniform(0, 1, (S, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("hw", [(56, 56), (42, 56), (70, 84)])
def test_forward_matches_reference(models, hw):
    jo, params, port = models
    imgs = _images(hw)
    outs_j, ps_j = j_vggt.aggregator_forward(params["aggregator"], jnp.asarray(imgs), jo)
    x = torch.as_tensor(imgs).permute(0, 3, 1, 2)
    with torch.no_grad():
        outs_t, ps_t = port.net.aggregator(x)
    assert ps_t == ps_j == 1 + OPTS["num_register_tokens"]
    for li, (a, b) in enumerate(zip(outs_j, outs_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL_AGG, err_msg=f"layer {li}")
    pose_j = np.asarray(j_vggt.camera_head_forward(params["camera_head"], outs_j, jo))
    with torch.no_grad():
        pose_t = port.net.camera_head(outs_t[-1]).numpy()
    np.testing.assert_allclose(pose_t, pose_j, atol=TOL_AGG)
    want = {k: np.asarray(v) for k, v in j_vggt.VGGTModel(jo, params=params).run(jnp.asarray(imgs)).items()}
    got = {k: v.numpy() for k, v in port.run(imgs).items()}
    for k in ("extrinsic", "intrinsic"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_AGG, atol=TOL_AGG, err_msg=k)
    assert got["depth"].shape == want["depth"].shape == (2, hw[0] // 14 * 14, hw[1] // 14 * 14)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=TOL_DEPTH, atol=TOL_DEPTH)
    np.testing.assert_allclose(got["depth_conf"], want["depth_conf"], rtol=TOL_DEPTH, atol=TOL_DEPTH)


def test_track_head_matches_reference(models, iters=2):
    jo, params, port = models
    imgs = _images((56, 70), seed=1, S=3)
    qp = np.random.default_rng(2).uniform(2, 50, (7, 2)).astype(np.float32)
    topts = j_track.track_options_from_params(params["track_head"])
    outs_j, ps_j = j_vggt.aggregator_forward(params["aggregator"], jnp.asarray(imgs), jo)
    coords_j, vis_j, conf_j = j_track.track_head_forward(params["track_head"], outs_j, ps_j, (56, 70),
                                                         jnp.asarray(qp), jo, topts, iters=iters)
    x = torch.as_tensor(imgs).permute(0, 3, 1, 2)
    to = vggt_track.track_options_from_state_dict(port.net.state_dict())
    assert (to.latent_dim, to.hidden_size, to.corr_levels, to.corr_radius, to.depth, to.num_heads,
            to.num_virtual_tracks) == (topts.latent_dim, topts.hidden_size, topts.corr_levels, topts.corr_radius,
                                       topts.depth, topts.num_heads, topts.num_virtual_tracks)
    with torch.no_grad():
        outs_t, ps_t = port.net.aggregator(x)
        coords_t, vis_t, conf_t = port.net.track_head(outs_t, ps_t, (56, 70), torch.as_tensor(qp), to,
                                                      iters=iters)
    assert len(coords_t) == iters
    np.testing.assert_allclose(coords_t[-1].numpy(), np.asarray(coords_j[-1]), atol=TOL_TRACK_PX)
    np.testing.assert_allclose(vis_t.numpy(), np.asarray(vis_j), atol=TOL_VIS)
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), atol=TOL_VIS)


def test_model_track_matches_reference(models):
    """VGGTModel.track: the aggregator again, then 4 iterations (the
    options read off the weights, as the reference reads them)."""
    jo, params, port = models
    imgs = _images((56, 56), seed=3)
    qp = np.random.default_rng(4).uniform(2, 50, (5, 2)).astype(np.float32)
    want = j_vggt.VGGTModel(jo, params=params).track(jnp.asarray(imgs), jnp.asarray(qp))
    got = port.track(imgs, qp)
    np.testing.assert_allclose(got["tracks"].numpy(), np.asarray(want["tracks"]), atol=TOL_TRACK_PX_4)
    for k in ("vis", "conf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=TOL_VIS, err_msg=k)


def test_sampling_and_embedding_match_reference():
    rng = np.random.default_rng(5)
    fmap = rng.normal(size=(5, 7, 3)).astype(np.float32)
    xy = rng.uniform(-2, 8, (11, 2)).astype(np.float32)
    for pad in ("zeros", "border"):
        want = np.asarray(j_track._bilinear_sample(jnp.asarray(fmap), jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]),
                                                   pad))
        got = vggt_track._bilinear_sample(torch.as_tensor(fmap), torch.as_tensor(xy[:, 0]),
                                          torch.as_tensor(xy[:, 1]), pad).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    odd = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(vggt_track._avg_pool2(torch.as_tensor(odd)).numpy(),
                               np.asarray(j_track._avg_pool2(jnp.asarray(odd))), atol=1e-6)
    flows = rng.normal(size=(4, 3, 2)).astype(np.float32) * 10
    np.testing.assert_allclose(vggt_track.get_2d_embedding(torch.as_tensor(flows), 16).numpy(),
                               np.asarray(j_track.get_2d_embedding(jnp.asarray(flows), 16)), atol=2e-5)
    tok = rng.normal(size=(2, 3, 6, 8)).astype(np.float32)
    pos = rng.integers(0, 5, (6, 2))
    np.testing.assert_allclose(mast3r.apply_rope2d(torch.as_tensor(tok), torch.as_tensor(pos), 100.0).numpy(),
                               np.asarray(j_mast3r.apply_rope2d(jnp.asarray(tok), jnp.asarray(pos), 100.0)),
                               atol=1e-6)


def test_options_read_off_the_state_dict(models):
    jo, params, port = models
    o, t = vggt.options_from_state_dict(port.net.state_dict(), vggt.VGGTOptions(**OPTS))
    assert o == vggt.VGGTOptions(**OPTS)
    assert t.dpt_features == OPTS["dpt_features"] and t.iters == 4
    # the public layout (no camera-trunk qk norm, refinenet4 without its
    # first residual unit) loads without the options
    sd = {k: v for k, v in port.net.state_dict().items() if "camera_head.trunk" not in k or "_norm" not in k}
    o2, _ = vggt.options_from_state_dict(sd)
    assert not o2.camera_qk_norm and o2.embed_dim == 64 and o2.dpt_out_channels == (16, 32, 64, 64)
    assert not any("refinenet4.resConfUnit1" in k for k in sd)


def test_pose_encoding_convention():
    enc = np.array([[0.1, -0.2, 0.3, 0, 0, 0, 1.0, 0.8, 0.9], [0.5, 0.1, -0.4, 0.2, -0.1, 0.3, 0.9, 1.1, 0.7]],
                   np.float32)
    ex_t, K_t = vggt.pose_encoding_to_extri_intri(torch.as_tensor(enc), (100, 200))
    ex_j, K_j = j_vggt.pose_encoding_to_extri_intri(jnp.asarray(enc), (100, 200))
    np.testing.assert_allclose(ex_t.numpy(), np.asarray(ex_j), atol=1e-6)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=1e-6)
    assert abs(float(K_t[0, 0, 0]) - 200 / 2 / math.tan(0.45)) < 1e-3


def test_chunked_attention_equals_one_pass(monkeypatch):
    rng = np.random.default_rng(6)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, n, 4, 8)).astype(np.float32)) for n in (37, 29, 29))
    one = numerics.attention(q, k, v, q_scale=8**-0.5)
    monkeypatch.setattr(numerics, "SCORE_BYTES", 2 * 4 * 29 * 4 * 5)  # 5 query rows a chunk
    chunked = numerics.attention(q, k, v, q_scale=8**-0.5)
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), atol=1e-6)
