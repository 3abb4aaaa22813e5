"""The port's LoFTR and compact dense matcher against the reference.

- ``LoFTRNet`` at reduced widths (coarse 32, fine 16, 4 heads, backbone
  16/24/32) on a seeded smooth image pair, the reference's flax init
  carried across by ``convert.loftr_state_dict``: every coarse stage (the
  backbone's coarse and fine maps, the transformer's tokens, the dual-softmax
  confidences) within 1e-4, and the whole forward: at least 99% of the
  reference's coarse matches (i, j) identical, the fine coordinates of the
  common ones within 1e-3 px and their scores within 1e-4.
- The official layout: the same weights written as an outdoor_ds.ckpt-style
  checkpoint (``state_dict``, ``matcher.`` prefixes) through
  ``load_torch_weights`` give the same matches.
- ``DenseMatcherNet`` (the compact net) at dim 32: the correlation within
  1e-4, and ``DenseImageMatcher.match_images``' match set against the
  reference's.
- A direct-branch run of skydio_front_end with LoFTR at the reduced
  widths through both packages' scene optimizers (test_torch_correspondence's
  ``direct_runs`` and folder): registered equal, AUC@5 within 0.02,
  correspondences per pair within 2 + 3%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gtsfm_tpu.frontend.matchers.dense_matcher import (
    DenseImageMatcher as JDenseMatcher,
    DenseMatcherOptions as JDenseOptions,
)
from gtsfm_tpu.frontend.matchers.loftr import LoFTRMatcher as JLoFTRMatcher, LoFTROptions as JOpts
from gtsfm_tpu_torch.frontend.matchers.dense_matcher import DenseImageMatcher, DenseMatcherOptions
from gtsfm_tpu_torch.frontend.matchers.loftr import LoFTRMatcher, LoFTROptions, load_torch_weights
from gtsfm_tpu_torch.utils import convert
from tests.test_torch_correspondence import direct_runs, folder  # noqa: F401 (the fixture)
from tests.torch_threads import cap_threads, threads

cap_threads()

TOL = 1e-4
FINE_TOL_PX = 1e-3
MATCH_SHARE = 0.99
SMALL = dict(d_coarse=32, d_fine=16, nhead=4, initial_dim=16, block_dims=(16, 24, 32), max_matches=64)


def smooth_pair(hw=(64, 80), seed=0, shift=(3, 5)):
    """A seeded smooth image and a shifted copy, (H, W) float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    H, W = hw
    big = rng.uniform(0, 1, (H // 4 + 4, W // 4 + 4)).astype(np.float32)
    up = np.kron(big, np.ones((4, 4), np.float32))
    k = np.ones(5, np.float32) / 5
    up = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, up)
    up = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, up)
    dy, dx = shift
    return up[8 : 8 + H, 8 : 8 + W].copy(), up[8 + dy : 8 + dy + H, 8 + dx : 8 + dx + W].copy()


def _jax_loftr(opts):
    return JLoFTRMatcher(JOpts(**opts._asdict()), example_hw=(64, 80))


def _matches_agree(tag, got, want):
    """got / want: (uv0, uv1, score, mask) numpy; the coarse pairs (uv0, the
    coarse uv1) as sets, the common ones' fine uv1 and scores."""
    def pairs(out):
        uv0, uv1, sc, m = out
        return {(tuple(a), tuple(np.round(b / 8.0).astype(int))): (b, s)
                for a, b, s in zip(uv0[m].tolist(), np.asarray(uv1)[m], sc[m])}

    g, w = pairs(got), pairs(want)
    assert len(w) > 0, f"{tag}: the reference made no match"
    common = set(g) & set(w)
    assert len(common) >= MATCH_SHARE * max(len(g), len(w)), f"{tag}: {len(common)} of {len(w)} / {len(g)}"
    for k in common:
        np.testing.assert_allclose(g[k][0], w[k][0], atol=FINE_TOL_PX, rtol=0)
        np.testing.assert_allclose(g[k][1], w[k][1], atol=TOL, rtol=0)


def _np(out):
    return tuple(np.asarray(a) for a in out)


def test_loftr_stages_and_matches_against_reference():
    opts = LoFTROptions(**SMALL, match_threshold=0.01)
    jm = _jax_loftr(opts)
    params = jax.tree.map(np.asarray, jm.params)
    tm = LoFTRMatcher(opts, state_dict=convert.loftr_state_dict(params))
    im0, im1 = smooth_pair()
    want = jm.net.apply({"params": jm.params}, jnp.asarray(im0), jnp.asarray(im1), method="coarse_forward")
    with torch.no_grad():
        got = tm.net.coarse_forward(torch.as_tensor(im0), torch.as_tensor(im1))
    for name, g, w in zip(("fc0", "ff0", "fc1", "ff1", "t0", "t1", "conf"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0, err_msg=name)
    _matches_agree("LoFTR", _np(tm.match_images(torch.as_tensor(im0), torch.as_tensor(im1))),
                   _np(jm.match_images(jnp.asarray(im0), jnp.asarray(im1))))


def test_loftr_official_layout_checkpoint(tmp_path):
    opts = LoFTROptions(**SMALL, match_threshold=0.01)
    jm = _jax_loftr(opts)
    sd = convert.loftr_state_dict(jax.tree.map(np.asarray, jm.params))
    path = tmp_path / "outdoor_ds.ckpt"
    torch.save({"state_dict": {f"matcher.{k}": v for k, v in sd.items()}}, str(path))
    loaded = load_torch_weights(str(path))
    assert set(loaded) == set(sd)
    tm = LoFTRMatcher(opts, state_dict=loaded)
    # 0-255 input is scaled by both
    im0, im1 = (a * 255.0 for a in smooth_pair(seed=1))
    _matches_agree("LoFTR checkpoint", _np(tm.match_images(torch.as_tensor(im0), torch.as_tensor(im1))),
                   _np(jm.match_images(jnp.asarray(im0), jnp.asarray(im1))))


def test_dense_matcher_against_reference():
    opts = DenseMatcherOptions(dim=32, num_blocks=2, max_matches=64, match_threshold=0.0)
    jm = JDenseMatcher(JDenseOptions(**opts._asdict()), example_hw=(64, 80))
    tm = DenseImageMatcher(opts, state_dict=convert.dense_matcher_state_dict(jax.tree.map(np.asarray, jm.params)))
    im0, im1 = smooth_pair(seed=2)
    corr_j, hw_j = jm.net.apply({"params": jm.params}, jnp.asarray(im0), jnp.asarray(im1))
    with torch.no_grad():
        corr_t, hw_t = tm.net(torch.as_tensor(im0), torch.as_tensor(im1))
    assert tuple(hw_t) == tuple(hw_j)
    np.testing.assert_allclose(corr_t.numpy(), np.asarray(corr_j), atol=TOL, rtol=0)
    got = _np(tm.match_images(torch.as_tensor(im0), torch.as_tensor(im1)))
    want = _np(jm.match_images(jnp.asarray(im0), jnp.asarray(im1)))
    g = {tuple(a) + tuple(b) for a, b in zip(got[0][got[3]].tolist(), got[1][got[3]].tolist())}
    w = {tuple(a) + tuple(b) for a, b in zip(want[0][want[3]].tolist(), want[1][want[3]].tolist())}
    assert w and len(g & w) >= MATCH_SHARE * max(len(g), len(w))
    assert got[0].shape == (64, 2) and got[3].dtype == bool


@threads(4)
def test_loftr_direct_run(folder):
    """skydio_front_end with LoFTR at the reduced widths (threshold 0.01)
    through both packages' scene optimizers on the 6-view folder, the
    reference's init in both."""
    def share(so_t, so_j):
        so_t.correspondence.matcher.net.load_state_dict(
            convert.loftr_state_dict(jax.tree.map(np.asarray, so_j.correspondence.matcher.params)))

    small = [f"correspondence.{k}={list(v) if isinstance(v, tuple) else v}" for k, v in SMALL.items()]
    out = direct_runs(folder["data"], "skydio_front_end", small + ["correspondence.match_threshold=0.01"],
                      share_weights=share)
    assert sum(out["counts"]["jax"].values()) > 0
