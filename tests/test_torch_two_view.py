"""Port two-view estimation against the JAX reference on replayed draws.

The reference draws RANSAC's minimal sets from ``jax.random``; the tests
recompute those draws from the same key, exactly as the reference does,
and hand them to the port as ``sample_idx``.
- ``ransac_essential``: E (up to sign and scale) and R agree to 1e-4;
  inlier masks agree except for correspondences whose Sampson error lies
  within 1e-6 of the threshold (float32 order of operations).
- ``run_two_view_batch`` on the descriptor feed: match counts and validity
  identical, R and t to 1e-4, inlier sets equal up to threshold-edge
  correspondences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from gtsfm_tpu.frontend.matchers.mutual_nn import match_descriptors as j_match
from gtsfm_tpu.frontend.two_view import run_two_view_batch as j_two_view
from gtsfm_tpu.frontend.verifiers.essential import (
    RansacOptions as JRansacOptions,
    _sampson_error as j_sampson,
    ransac_essential as j_ransac,
)
from gtsfm_tpu.geometry import Cal3Bundler as JCal
from gtsfm_tpu.loader.synthetic import spectral_ring_poses as j_ring
from gtsfm_tpu_torch.frontend.two_view import run_two_view_batch
from gtsfm_tpu_torch.frontend.verifiers.essential import RansacOptions, ransac_essential
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads

cap_threads()

P, K, F = 3, 256, 300.0


def _scene(seed):
    """Normalized correspondences of P random two-view geometries, 20%
    outliers, 0.5 px noise, a ragged valid mask."""
    rng = np.random.default_rng(seed)
    x1s, x2s, masks = [], [], []
    for _ in range(P):
        pts = rng.uniform([-2, -2, 4], [2, 2, 8], (K, 3))
        w = rng.normal(size=3) * 0.15
        th = np.linalg.norm(w)
        Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) + np.sin(th) / th * Wx + (1 - np.cos(th)) / th**2 * Wx @ Wx
        t = np.array([1.0, 0.1, 0.2]) + 0.1 * rng.normal(size=3)
        p2 = pts @ R.T + t
        x1 = pts[:, :2] / pts[:, 2:] + rng.normal(0, 0.5 / F, (K, 2))
        x2 = p2[:, :2] / p2[:, 2:] + rng.normal(0, 0.5 / F, (K, 2))
        out = rng.random(K) < 0.2
        x2[out] = rng.uniform(-0.5, 0.5, (out.sum(), 2))
        x1s.append(x1)
        x2s.append(x2)
        masks.append(rng.random(K) > 0.1)
    sw = rng.uniform(0.1, 1.0, (P, K))
    return (np.asarray(x1s, np.float32), np.asarray(x2s, np.float32), np.asarray(masks),
            sw.astype(np.float32))


def _replay_sample_idx(x1, mask, key, sample_weights, H):
    """The reference's minimal-set draws (essential.py:300-333), verbatim."""
    Kk = x1.shape[0]
    maskf = mask.astype(x1.dtype)
    sw = jnp.maximum(sample_weights, 1e-6) * maskf
    pool = min(Kk, max(256, 4 * 8))
    key, k_tie = jax.random.split(key)
    tie = jax.random.uniform(k_tie, (Kk,), minval=0.5, maxval=1.0)
    pool_idx = jax.lax.top_k(jnp.where(mask, sw * tie, -1.0), pool)[1]
    sw_pool = sw[pool_idx]
    mask_pool = mask[pool_idx]

    def sample_one(k):
        u = jax.random.uniform(k, (pool,), minval=1e-12, maxval=1.0)
        keys_w = jnp.where(mask_pool, u ** (1.0 / sw_pool), -1.0)
        return pool_idx[jax.lax.top_k(keys_w, 8)[1]]

    return jax.vmap(sample_one)(jax.random.split(key, H))


def _unit_e(E):
    """E up to scale and sign: unit Frobenius norm, largest entry positive."""
    E = E / np.linalg.norm(E)
    return E * np.sign(E.flat[np.argmax(np.abs(E))])


def test_ransac_essential_matches_reference_on_replayed_draws():
    x1, x2, mask, sw = _scene(0)
    thresh = np.float32(4.0 / F)
    opts = JRansacOptions()
    keys = jax.random.split(jax.random.PRNGKey(7), P)
    ref, sidx = [], []
    for p in range(P):
        args = (jnp.asarray(x1[p]), jnp.asarray(x2[p]), jnp.asarray(mask[p]))
        ref.append(jax.tree.map(np.asarray, j_ransac(*args, keys[p], threshold=thresh, opts=opts,
                                                     sample_weights=jnp.asarray(sw[p]))))
        sidx.append(np.asarray(_replay_sample_idx(args[0], args[2], keys[p], jnp.asarray(sw[p]),
                                                  opts.num_hypotheses)))
    out = ransac_essential(
        torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(mask),
        torch.full((P,), float(thresh)), opts=RansacOptions(),
        sample_weights=torch.as_tensor(sw), sample_idx=torch.as_tensor(np.stack(sidx)),
    )
    for p in range(P):
        E_t = out["E"][p].numpy()
        E_j = ref[p]["E"]
        np.testing.assert_allclose(_unit_e(E_t), _unit_e(E_j), atol=1e-4)
        np.testing.assert_allclose(out["i2Ri1"][p].numpy(), ref[p]["i2Ri1"], atol=1e-4)
        np.testing.assert_allclose(out["i2Ui1"][p].numpy(), ref[p]["i2Ui1"], atol=1e-4)
        err = np.asarray(j_sampson(jnp.asarray(E_j), jnp.asarray(x1[p]), jnp.asarray(x2[p])))
        border = np.abs(err - thresh**2) < 1e-6
        differ = out["inliers"][p].numpy() != ref[p]["inliers"]
        assert not (differ & ~border).any()
        assert bool(out["success"][p]) == bool(ref[p]["success"])
        assert ref[p]["num_inliers"] > 100


def test_run_two_view_batch_matches_reference_on_replayed_draws():
    """The whole batched two-view unit (matching, RANSAC, 2-view GN polish,
    keep-best guard, inlier support) on three pairs of the descriptor feed.
    The reference keys pair p's RANSAC with fold_in(PRNGKey(seed), p); the
    test replays those draws from the reference's own matches and weights."""
    n, Kp = 8, 256
    ring = chip_smoke.ring_pairs(n)
    gt = j_ring(ring, n)
    kp_xy, kp_mask, descs = chip_smoke.descriptor_feed(np.array(gt.R), np.array(gt.t), chip_smoke.FOCAL,
                                                       chip_smoke.IMAGE_HW, Kp)
    pairs = ring[:3]
    i1, i2 = pairs[:, 0], pairs[:, 1]
    cal_np = {"f": np.full(3, chip_smoke.FOCAL, np.float32), "k1": np.zeros(3, np.float32),
              "k2": np.zeros(3, np.float32), "u0": np.full(3, 160.0, np.float32),
              "v0": np.full(3, 120.0, np.float32)}
    args = (kp_xy[i1], kp_xy[i2], descs[i1], descs[i2], kp_mask[i1], kp_mask[i2])
    key = jax.random.PRNGKey(0)
    pair_ids = np.arange(3, dtype=np.int32)
    cal_j = JCal(**{k: jnp.asarray(v) for k, v in cal_np.items()})
    ref = jax.tree.map(np.asarray, j_two_view(
        *(jnp.asarray(a) for a in args), cal_j, cal_j, jnp.ones(3, bool), key,
        pair_ids=jnp.asarray(pair_ids),
    ))

    sidx = []
    for p in range(3):
        midx, mmask, mscore = j_match(jnp.asarray(args[2][p]), jnp.asarray(args[3][p]),
                                      jnp.asarray(args[4][p]), jnp.asarray(args[5][p]), ratio=0.8)
        x1 = (args[0][p] - np.array([160.0, 120.0], np.float32)) / np.float32(chip_smoke.FOCAL)
        sw = jnp.clip((mscore + 1.0) * 0.5, 1e-3, 1.0) ** 4
        sidx.append(np.asarray(_replay_sample_idx(jnp.asarray(x1), mmask, jax.random.fold_in(key, p), sw, 512)))

    cal_t = convert.cal3_bundler(cal_np)
    got = run_two_view_batch(*(torch.as_tensor(a) for a in args), cal_t, cal_t, torch.ones(3, dtype=torch.bool),
                             sample_idx=torch.as_tensor(np.stack(sidx)))
    np.testing.assert_array_equal(got.num_matches.numpy(), ref.num_matches)
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    assert ref.valid.all()
    np.testing.assert_allclose(got.i2Ri1.numpy(), ref.i2Ri1, atol=1e-4)
    np.testing.assert_allclose(got.i2Ui1.numpy(), ref.i2Ui1, atol=1e-4)
    # inlier sets: equal up to correspondences on the threshold's edge
    assert np.abs(got.num_inliers.numpy() - ref.num_inliers).max() <= 1
    assert (got.corr_mask.numpy() != ref.corr_mask).sum() <= 3


def test_run_two_view_batch_with_precomputed_matches_matches_reference_on_replayed_draws():
    """Matches handed in as a learned matcher hands them (LightGlue's
    match_idx / match_mask / match_score contract): the mutual-NN matching
    is skipped, the scores weight RANSAC's sampling, and the rest of the
    unit agrees with the reference on replayed draws as above. The matches
    are the feed's true correspondences (keypoint k to keypoint k) where
    both keypoints are in view, with 15% of them sent to a wrong keypoint,
    and scores uniform in (0.1, 1)."""
    n, Kp = 8, 256
    ring = chip_smoke.ring_pairs(n)
    gt = j_ring(ring, n)
    kp_xy, kp_mask, descs = chip_smoke.descriptor_feed(np.array(gt.R), np.array(gt.t), chip_smoke.FOCAL,
                                                       chip_smoke.IMAGE_HW, Kp)
    pairs = ring[3:6]
    i1, i2 = pairs[:, 0], pairs[:, 1]
    rng = np.random.default_rng(11)
    midx = np.tile(np.arange(Kp, dtype=np.int32), (3, 1))
    wrong = rng.random((3, Kp)) < 0.15
    midx[wrong] = rng.integers(0, Kp, wrong.sum())
    mmask = kp_mask[i1] & kp_mask[i2]
    midx = np.where(mmask, midx, -1).astype(np.int32)
    mscore = rng.uniform(0.1, 1.0, (3, Kp)).astype(np.float32)
    cal_np = {"f": np.full(3, chip_smoke.FOCAL, np.float32), "k1": np.zeros(3, np.float32),
              "k2": np.zeros(3, np.float32), "u0": np.full(3, 160.0, np.float32),
              "v0": np.full(3, 120.0, np.float32)}
    args = (kp_xy[i1], kp_xy[i2], descs[i1], descs[i2], kp_mask[i1], kp_mask[i2])
    key = jax.random.PRNGKey(3)
    cal_j = JCal(**{k: jnp.asarray(v) for k, v in cal_np.items()})
    ref = jax.tree.map(np.asarray, j_two_view(
        *(jnp.asarray(a) for a in args), cal_j, cal_j, jnp.ones(3, bool), key,
        match_idx=jnp.asarray(midx), match_mask=jnp.asarray(mmask), match_score=jnp.asarray(mscore),
        pair_ids=jnp.arange(3, dtype=jnp.int32),
    ))

    sidx = []
    for p in range(3):
        x1 = (args[0][p] - np.array([160.0, 120.0], np.float32)) / np.float32(chip_smoke.FOCAL)
        sw = jnp.clip((jnp.asarray(mscore[p]) + 1.0) * 0.5, 1e-3, 1.0) ** 4
        sidx.append(np.asarray(_replay_sample_idx(jnp.asarray(x1), jnp.asarray(mmask[p]),
                                                  jax.random.fold_in(key, p), sw, 512)))

    cal_t = convert.cal3_bundler(cal_np)
    got = run_two_view_batch(*(torch.as_tensor(a) for a in args), cal_t, cal_t, torch.ones(3, dtype=torch.bool),
                             sample_idx=torch.as_tensor(np.stack(sidx)), match_idx=torch.as_tensor(midx),
                             match_mask=torch.as_tensor(mmask), match_score=torch.as_tensor(mscore))
    np.testing.assert_array_equal(got.num_matches.numpy(), ref.num_matches)
    np.testing.assert_array_equal(got.num_matches.numpy(), mmask.sum(1))
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    assert ref.valid.all()
    np.testing.assert_array_equal(got.corr_i2.numpy(), ref.corr_i2)
    np.testing.assert_allclose(got.i2Ri1.numpy(), ref.i2Ri1, atol=1e-4)
    np.testing.assert_allclose(got.i2Ui1.numpy(), ref.i2Ui1, atol=1e-4)
    assert np.abs(got.num_inliers.numpy() - ref.num_inliers).max() <= 1
    assert (got.corr_mask.numpy() != ref.corr_mask).sum() <= 3
