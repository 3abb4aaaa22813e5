"""The port's SuperGlue matcher against the reference.

- ``SuperGlueNet`` at reduced widths (dim 32, 2 layer pairs, 4 heads,
  encoder 8/16) on seeded descriptors and keypoints, K0 != K1 with padded
  slots, the reference's flax init carried across by
  ``convert.superglue_state_dict``: the log-assignment within 1e-4 where
  both rows are real (padded rows are -inf in both) and ``match_batch``'s
  matches identical, with the scores within 1e-4.
- The official layout: the same weights saved as a superglue_outdoor.pth
  state_dict, built through ``registry.build_matcher`` with
  ``weights_path``, give the same matches.
- ``log_optimal_transport`` on a padded problem gives the unpadded one's
  values (the padded slots carry no mass), as in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gtsfm_tpu.frontend.matchers.superglue import SuperGlueMatcher as JMatcher, SuperGlueOptions as JOpts
from gtsfm_tpu_torch.frontend.matchers.superglue import (
    SuperGlueMatcher,
    SuperGlueOptions,
    log_optimal_transport,
    normalize_keypoints_sg,
)
from gtsfm_tpu_torch.frontend.registry import build_matcher
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads

cap_threads()

TOL = 1e-4
SMALL = dict(dim=32, num_layers=2, num_heads=4, encoder_layers=(8, 16), match_threshold=0.0)
HW = (120, 160)


def _inputs(P=2, K0=48, K1=40, D=32, seed=0):
    """Seeded unit descriptors with shared structure (pair p's image 2 holds
    noisy copies of image 1's first descriptors), pixel keypoints and
    masks with padded tails, padded to K = max(K0, K1)."""
    rng = np.random.default_rng(seed)
    K = max(K0, K1)
    d1 = rng.normal(size=(P, K, D)).astype(np.float32)
    d2 = rng.normal(size=(P, K, D)).astype(np.float32)
    d2[:, : K1 // 2] = d1[:, : K1 // 2] + 0.1 * rng.normal(size=(P, K1 // 2, D))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    xy1 = (rng.uniform(size=(P, K, 2)) * [HW[1], HW[0]]).astype(np.float32)
    xy2 = (xy1 + rng.normal(0, 2.0, (P, K, 2))).astype(np.float32)
    m1 = np.arange(K)[None].repeat(P, 0) < K0 - 3 * np.arange(P)[:, None]
    m2 = np.arange(K)[None].repeat(P, 0) < K1
    return d1, d2, xy1, xy2, m1, m2


def _jax(opts):
    return JMatcher(JOpts(**opts._asdict()))


def _both(jm, tm, inputs):
    d1, d2, xy1, xy2, m1, m2 = inputs
    size = (HW[1], HW[0])
    got = tm.match_batch(*(torch.as_tensor(a) for a in inputs), image_size=size)
    want = jm.match_batch(*(jnp.asarray(a) for a in inputs), image_size=size)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_superglue_net_and_matches_against_reference():
    opts = SuperGlueOptions(**SMALL)
    jm = _jax(opts)
    tm = SuperGlueMatcher(opts, state_dict=convert.superglue_state_dict(jax.tree.map(np.asarray, jm.params)))
    inputs = _inputs()
    d1, d2, xy1, xy2, m1, m2 = inputs
    size = (HW[1], HW[0])
    c1, c2 = (normalize_keypoints_sg(torch.as_tensor(a), size).numpy() for a in (xy1, xy2))
    z_want = np.asarray(jm._fwd_batch(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(c1), jnp.asarray(c2),
                                      jnp.asarray(m1, jnp.float32), jnp.asarray(m2, jnp.float32),
                                      jnp.asarray(m1), jnp.asarray(m2)))
    z_got = tm.log_assignment(*(torch.as_tensor(a) for a in inputs), image_size=size).numpy()
    rows = np.pad(m1, ((0, 0), (0, 1)), constant_values=True)[:, :, None] & \
        np.pad(m2, ((0, 0), (0, 1)), constant_values=True)[:, None, :]
    np.testing.assert_allclose(z_got[rows], z_want[rows], atol=TOL, rtol=0)
    assert np.isneginf(z_got[~np.pad(m1, ((0, 0), (0, 1)), constant_values=True)]).all()
    got, want = _both(jm, tm, inputs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() > 0
    np.testing.assert_allclose(got[2], want[2], atol=TOL, rtol=0)


def test_superglue_official_layout_through_registry(tmp_path):
    opts = SuperGlueOptions(**SMALL)
    jm = _jax(opts)
    path = tmp_path / "superglue_outdoor.pth"
    torch.save(convert.superglue_state_dict(jax.tree.map(np.asarray, jm.params)), str(path))
    tm = build_matcher({"name": "superglue", "weights_path": str(path), **SMALL})
    assert isinstance(tm, SuperGlueMatcher) and tm.options == opts
    got, want = _both(jm, tm, _inputs(seed=1))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], atol=TOL, rtol=0)


def test_optimal_transport_padding_carries_no_mass():
    rng = np.random.default_rng(3)
    s = torch.as_tensor(rng.normal(size=(1, 5, 4)).astype(np.float32))
    alpha = torch.tensor(0.7)
    full = log_optimal_transport(s, alpha, 20, torch.ones(1, 5, dtype=torch.bool), torch.ones(1, 4, dtype=torch.bool))
    pad = torch.full((1, 7, 6), -1e9)
    pad[:, :5, :4] = s
    m0 = torch.arange(7)[None] < 5
    m1 = torch.arange(6)[None] < 4
    padded = log_optimal_transport(pad, alpha, 20, m0, m1)
    np.testing.assert_allclose(padded[0, :5, :4].numpy(), full[0, :5, :4].numpy(), atol=1e-5)
    np.testing.assert_allclose(padded[0, :5, -1].numpy(), full[0, :5, -1].numpy(), atol=1e-5)
