"""The port's two-view options against the JAX reference on replayed draws.

- ``ransac_essential`` under each scoring (MSAC, LMedS, inlier count), on
  the preemptive subset and on every correspondence: E (up to sign and
  scale), R and t agree to 1e-4; inlier masks agree except for points
  whose Sampson error lies within 1e-4 relative of the threshold.
- ``ransac_essential_pixels`` on pixel correspondences with per-pair
  calibrations: the same tolerances.
- ``essential_information_spectrum``: the extreme eigenvalues agree to
  1e-4 relative to the largest; one correspondence alone is rank
  deficient in both.
- ``run_two_view_batch`` with the new options, on a batch that holds two
  ring pairs of the descriptor feed, a planar pair and a pair whose
  keypoints collapse to one pixel: validity identical, R and t of valid
  pairs to 1e-4, inlier sets equal up to threshold-edge points. The
  planar pair fails the homography check and the collapsed pair the
  indeterminacy check in both packages; with the checks off both pass.

Every JAX option set compiles once per module (module-scoped fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.frontend.matchers.mutual_nn import match_descriptors as j_match
from gtsfm_tpu.frontend.two_view import TwoViewOptions as JTwoViewOptions, run_two_view_batch as j_two_view
from gtsfm_tpu.frontend.verifiers.essential import (
    RansacOptions as JRansacOptions,
    _sampson_error as j_sampson,
    essential_information_spectrum as j_spectrum,
    ransac_essential as j_ransac,
    ransac_essential_pixels as j_ransac_pixels,
)
from gtsfm_tpu.geometry import Cal3Bundler as JCal
from gtsfm_tpu.loader.synthetic import spectral_ring_poses as j_ring
from gtsfm_tpu_torch.frontend.two_view import TwoViewOptions, run_two_view_batch
from gtsfm_tpu_torch.frontend.verifiers.essential import (
    RansacOptions,
    essential_information_spectrum,
    ransac_essential,
    ransac_essential_pixels,
)
from gtsfm_tpu_torch.utils import convert
from tests.test_torch_two_view import _replay_sample_idx, _unit_e
from tests.torch_threads import cap_threads

cap_threads()

P, K, F = 3, 320, 300.0
TOL = 1e-4
H_RAT, EIG_RAT = 0.85, 1e-5  # the reference's own test values (tests/frontend/test_two_view.py)


def _scene(seed):
    """P random two-view geometries in normalized coordinates, 20%
    outliers, 0.5 px noise, a ragged valid mask; sample weights."""
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
    return (np.asarray(x1s, np.float32), np.asarray(x2s, np.float32), np.asarray(masks), sw.astype(np.float32))


def _assert_same_ransac(got, ref, x1, x2, mask, thresh, count_ties=False):
    """E, R, t to TOL and inliers off the threshold's edge, pair by pair.
    With ``count_ties`` (inlier-count quality), a pair may instead end on
    another model of the same score: the keep-best guard compares integer
    counts, and a polished model one threshold-edge point from a tie is
    kept by one package and not the other. Such a pair must score the
    reference's inlier count under the reference's own Sampson error, and
    its inliers are held against its own model; most pairs must agree."""
    tied = 0
    for p in range(len(ref)):
        E_t = got["E"][p].numpy()
        E_held = ref[p]["E"]
        if count_ties and np.abs(_unit_e(E_t) - _unit_e(E_held)).max() > TOL:
            E_held = E_t
            tied += 1
        else:
            np.testing.assert_allclose(_unit_e(E_t), _unit_e(E_held), atol=TOL)
            np.testing.assert_allclose(got["i2Ri1"][p].numpy(), ref[p]["i2Ri1"], atol=TOL)
            np.testing.assert_allclose(got["i2Ui1"][p].numpy(), ref[p]["i2Ui1"], atol=TOL)
        err = np.asarray(j_sampson(jnp.asarray(E_held), jnp.asarray(x1[p]), jnp.asarray(x2[p])))
        inl = mask[p] & (err < thresh[p] ** 2)
        assert int(inl.sum()) == int(ref[p]["num_inliers"]) or E_held is ref[p]["E"]
        border = np.abs(err - thresh[p] ** 2) < TOL * thresh[p] ** 2
        assert not ((got["inliers"][p].numpy() != inl) & ~border).any()
        assert bool(got["success"][p]) == bool(ref[p]["success"])
        assert ref[p]["num_inliers"] > 100
    assert tied < len(ref) / 2


@pytest.fixture(scope="module")
def scene():
    x1, x2, mask, sw = _scene(0)
    keys = jax.random.split(jax.random.PRNGKey(5), P)
    sidx = np.stack([np.asarray(_replay_sample_idx(jnp.asarray(x1[p]), jnp.asarray(mask[p]), keys[p],
                                                   jnp.asarray(sw[p]), 512)) for p in range(P)])
    return x1, x2, mask, sw, keys, sidx


@pytest.mark.parametrize("scoring,subset", [("msac", 256), ("lmeds", 256), ("lmeds", 0), ("inliers", 256)])
def test_ransac_scoring_matches_reference_on_replayed_draws(scene, scoring, subset):
    """LMedS votes by the median of an even count (256, or K = 320 with
    the masked points at +inf): the mean of the two middle values, as
    jnp.median takes it."""
    x1, x2, mask, sw, keys, sidx = scene
    thresh = np.full(P, 4.0 / F, np.float32)
    ref = [jax.tree.map(np.asarray, j_ransac(
        jnp.asarray(x1[p]), jnp.asarray(x2[p]), jnp.asarray(mask[p]), keys[p], threshold=thresh[p],
        opts=JRansacOptions(scoring=scoring, score_subset=subset), sample_weights=jnp.asarray(sw[p])))
        for p in range(P)]
    got = ransac_essential(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(mask), torch.as_tensor(thresh),
                           opts=RansacOptions(scoring=scoring, score_subset=subset), sample_weights=torch.as_tensor(sw),
                           sample_idx=torch.as_tensor(sidx))
    _assert_same_ransac(got, ref, x1, x2, mask, thresh, count_ties=scoring == "inliers")


def test_ransac_essential_pixels_matches_reference():
    """Pixel correspondences with a different calibration per pair; the
    reference's default (mask-weighted) draws replayed."""
    x1, x2, mask, _ = _scene(1)
    f = np.array([280.0, 300.0, 330.0], np.float32)
    c = np.array([[160.0, 120.0], [150.0, 125.0], [170.0, 110.0]], np.float32)
    uv1 = (x1 * f[:, None, None] + c[:, None]).astype(np.float32)
    uv2 = (x2 * f[:, None, None] + c[:, None]).astype(np.float32)
    cal_np = {"f": f, "k1": np.zeros(P, np.float32), "k2": np.zeros(P, np.float32), "u0": c[:, 0], "v0": c[:, 1]}
    keys = jax.random.split(jax.random.PRNGKey(9), P)
    ref, sidx = [], []
    for p in range(P):
        cal_p = JCal(**{k: jnp.asarray(v[p]) for k, v in cal_np.items()})
        ref.append(jax.tree.map(np.asarray, j_ransac_pixels(jnp.asarray(uv1[p]), jnp.asarray(uv2[p]),
                                                            jnp.asarray(mask[p]), cal_p, cal_p, keys[p])))
        xn = jnp.asarray((uv1[p] - c[p]) / f[p])
        sidx.append(np.asarray(_replay_sample_idx(xn, jnp.asarray(mask[p]), keys[p], jnp.ones(K), 512)))
    cal_t = convert.cal3_bundler(cal_np)
    got = ransac_essential_pixels(torch.as_tensor(uv1), torch.as_tensor(uv2), torch.as_tensor(mask), cal_t, cal_t,
                                  sample_idx=torch.as_tensor(np.stack(sidx)))
    xn1 = (uv1 - c[:, None]) / f[:, None, None]
    xn2 = (uv2 - c[:, None]) / f[:, None, None]
    _assert_same_ransac(got, ref, xn1, xn2, mask, 4.0 / f)


def test_information_spectrum_matches_reference(scene):
    """At each pair's reference pose with its inliers as weights; then all
    weight on one correspondence, which leaves the pose undetermined."""
    x1, x2, mask, sw, keys, _ = scene
    ref = [j_ransac(jnp.asarray(x1[p]), jnp.asarray(x2[p]), jnp.asarray(mask[p]), keys[p], threshold=4.0 / F,
                    sample_weights=jnp.asarray(sw[p])) for p in range(P)]
    R = np.stack([np.asarray(r["i2Ri1"]) for r in ref])
    t = np.stack([np.asarray(r["i2Ui1"]) for r in ref])
    w = np.stack([np.asarray(r["inliers"], np.float32) for r in ref])
    one = np.zeros_like(w)
    one[:, 0] = 1.0
    for weights in (w, one):
        want = np.array([[float(v) for v in j_spectrum(jnp.asarray(x1[p]), jnp.asarray(x2[p]), jnp.asarray(weights[p]),
                                                        jnp.asarray(R[p]), jnp.asarray(t[p]))] for p in range(P)])
        mn, mx = essential_information_spectrum(*(torch.as_tensor(a) for a in (x1, x2, weights, R, t)))
        got = np.stack([mn.numpy(), mx.numpy()], -1)
        assert np.all(np.abs(got - want) <= TOL * want[:, 1:]), (got, want)
    assert np.all(want[:, 0] < 1e-6 * want[:, 1])  # one correspondence: rank deficient


def _batch():
    """Four pairs at K=256, f=300, 240x320: ring pairs 0 and 1 of the
    descriptor feed; a planar pair (200 points on z = 5, the second camera
    0.6 to the side, identical descriptors); ring pair 2 with every
    keypoint collapsed onto one pixel plus 0.1 px jitter."""
    n, Kp = 8, 256
    ring = chip_smoke.ring_pairs(n)
    gt = j_ring(ring, n)
    kp_xy, kp_mask, descs = chip_smoke.descriptor_feed(np.array(gt.R), np.array(gt.t), chip_smoke.FOCAL,
                                                       chip_smoke.IMAGE_HW, Kp)
    i1, i2 = ring[:3, 0], ring[:3, 1]
    xy1, xy2, d1, d2 = kp_xy[i1], kp_xy[i2], descs[i1], descs[i2]
    m1, m2 = kp_mask[i1], kp_mask[i2]
    rng = np.random.default_rng(4)
    pts = np.stack([rng.uniform(-1.5, 1.5, Kp), rng.uniform(-1, 1, Kp), np.full(Kp, 5.0)], -1)
    plane = []
    for c in ((0.0, 0.0, 0.0), (0.6, 0.1, 0.0)):
        pc = pts - np.asarray(c)
        plane.append(chip_smoke.FOCAL * pc[:, :2] / pc[:, 2:] + np.array([160.0, 120.0]))
    dp = rng.normal(size=(Kp, d1.shape[-1]))
    dp /= np.linalg.norm(dp, axis=-1, keepdims=True)
    live = np.arange(Kp) < 200
    col1 = xy1[2][:1] + 0.1 * rng.normal(size=(Kp, 2))
    col2 = xy2[2][:1] + 0.1 * rng.normal(size=(Kp, 2))
    xy1 = np.stack([xy1[0], xy1[1], plane[0], col1]).astype(np.float32)
    xy2 = np.stack([xy2[0], xy2[1], plane[1], col2]).astype(np.float32)
    d1 = np.stack([d1[0], d1[1], dp, d1[2]]).astype(np.float32)
    d2 = np.stack([d2[0], d2[1], dp, d2[2]]).astype(np.float32)
    m1 = np.stack([m1[0], m1[1], live, m1[2]])
    m2 = np.stack([m2[0], m2[1], live, m2[2]])
    return xy1, xy2, d1, d2, m1, m2


def _replayed_draws(args, key, opts):
    """The reference's essential and homography draws of every pair, from
    its own matches (pair p keyed by fold_in(key, p), the homography's by
    fold_in of that with 1)."""
    xy1, _, d1, d2, m1, m2 = args
    sidx, hidx = [], []
    for p in range(len(xy1)):
        midx, mmask, mscore = j_match(jnp.asarray(d1[p]), jnp.asarray(d2[p]), jnp.asarray(m1[p]),
                                      jnp.asarray(m2[p]), ratio=0.8)
        kp = jax.random.fold_in(key, p)
        x1 = (xy1[p] - np.array([160.0, 120.0], np.float32)) / np.float32(chip_smoke.FOCAL)
        sw = jnp.clip((mscore + 1.0) * 0.5, 1e-3, 1.0) ** 4
        sidx.append(np.asarray(_replay_sample_idx(jnp.asarray(x1), mmask, kp, sw, opts.ransac.num_hypotheses)))
        maskf = mmask.astype(jnp.float32)
        hidx.append(np.asarray(jax.vmap(lambda k: jax.lax.top_k(jax.random.uniform(k, (len(maskf),)) * maskf, 4)[1])(
            jax.random.split(jax.random.fold_in(kp, 1), opts.homography_hypotheses))))
    return torch.as_tensor(np.stack(sidx)), torch.as_tensor(np.stack(hidx))


OPTION_SETS = {
    # the chip phase's two-view overrides
    "checks": dict(ransac=dict(scoring="lmeds"), homography_degeneracy_ratio=H_RAT, indeterminacy_eig_ratio=EIG_RAT),
    "plain": dict(ransac=dict(scoring="inliers"), run_two_view_ba=False, use_pallas_matcher=True),
}


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.mark.parametrize("name", list(OPTION_SETS))
def test_run_two_view_batch_options_match_reference_on_replayed_draws(batch, name):
    kw = dict(OPTION_SETS[name])
    ransac = kw.pop("ransac")
    j_opts = JTwoViewOptions(ransac=JRansacOptions(**ransac), **kw)
    opts = TwoViewOptions(ransac=RansacOptions(**ransac), **kw)
    n = len(batch[0])
    cal_np = {"f": np.full(n, chip_smoke.FOCAL, np.float32), "k1": np.zeros(n, np.float32),
              "k2": np.zeros(n, np.float32), "u0": np.full(n, 160.0, np.float32), "v0": np.full(n, 120.0, np.float32)}
    cal_j = JCal(**{k: jnp.asarray(v) for k, v in cal_np.items()})
    key = jax.random.PRNGKey(2)
    ref = jax.tree.map(np.asarray, j_two_view(*(jnp.asarray(a) for a in batch), cal_j, cal_j, jnp.ones(n, bool), key,
                                              opts=j_opts, pair_ids=jnp.arange(n, dtype=jnp.int32)))
    sidx, hidx = _replayed_draws(batch, key, j_opts)
    cal_t = convert.cal3_bundler(cal_np)
    args = [torch.as_tensor(a) for a in batch] + [cal_t, cal_t, torch.ones(n, dtype=torch.bool)]
    got = run_two_view_batch(*args, opts=opts, sample_idx=sidx, h_sample_idx=hidx)
    np.testing.assert_array_equal(got.num_matches.numpy(), ref.num_matches)
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    ring = slice(0, 2)  # well-posed pairs: the pose is held; planar and collapsed ones have none
    assert ref.valid[ring].all()
    np.testing.assert_allclose(got.i2Ri1.numpy()[ring], ref.i2Ri1[ring], atol=TOL)
    np.testing.assert_allclose(got.i2Ui1.numpy()[ring], ref.i2Ui1[ring], atol=TOL)
    assert np.abs(got.num_inliers.numpy()[ring] - ref.num_inliers[ring]).max() <= 1
    assert (got.corr_mask.numpy()[ring] != ref.corr_mask[ring]).sum() <= 3
    if name == "checks":
        # each check rejects its pair, and only that one
        np.testing.assert_array_equal(ref.valid, [True, True, False, False])
        hf, eig = got.hf_ratio.numpy(), got.eig_ratio.numpy()
        assert hf[2] >= H_RAT and (hf[ring] < H_RAT).all(), hf
        assert eig[3] <= EIG_RAT and (eig[ring] > EIG_RAT).all(), eig
        # and the port's own draws reach the same decisions
        own = run_two_view_batch(*args, opts=opts)
        np.testing.assert_array_equal(own.valid.numpy(), ref.valid)
    else:
        assert ref.valid[2]  # the planar pair passes with the checks off
        assert np.isnan(got.hf_ratio.numpy()).all() and np.isnan(got.eig_ratio.numpy()).all()
