"""The port's fundamental.py against the JAX reference on replayed draws.

The reference draws each minimal set as the top 8 (F) or 4 (H) of
uniforms times the valid mask; the tests recompute those indices from the
same keys and hand them to the port as ``sample_idx``. Degensac's draws
depend on the F inliers, so its uniforms are replayed instead.
- ``ransac_homography`` on a planar and a general pair (a ragged mask):
  H up to sign and scale to 1e-4, inlier masks equal except points whose
  transfer error lies within 1e-4 relative of the threshold; with the
  essential / F inliers, ``gric_select_model`` flags the planar pair in
  both, with H/F ratios to 1e-6;
- ``ransac_fundamental`` on the reference test's pairs: F up to sign and
  scale to 1e-4 in the Hartley-normalized frame where it is estimated
  (the pixel F's norm is about 1e-2 of its summands', so its unit scaling
  magnifies float32 rounding 100-fold), inliers as above; on noisier pairs
  see the test;
- Degensac on the reference test's dominant plane (280 plane points, 6
  off the plane, 40 outliers): on, F agrees to 1e-4 and both recover every
  off-plane point; off, both are fooled by the plane (the plane fit leaves
  F's other dimensions free, so only the outcome is held);
- ``fundamental_to_essential``: E up to sign to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.verifiers import fundamental as jf
from gtsfm_tpu_torch.frontend.verifiers import fundamental as tf
from tests.frontend.test_essential import _make_two_view
from tests.torch_threads import cap_threads

cap_threads()

TOL = 1e-4
KMAT = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1.0]])


def _unit(M):
    """M up to scale and sign: unit Frobenius norm, largest entry positive."""
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


def _project(P, R, t):
    uv = (KMAT @ ((R @ P.T).T + t).T).T
    return uv[:, :2] / uv[:, 2:3]


def _rot_y(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])


def _pair(rng, n, planar, outlier_frac=0.2, noise=0.4):
    """Pixel correspondences of n points (on z = 5 when ``planar``), a
    fifth of them replaced by outliers."""
    z = np.full(n, 5.0) if planar else rng.uniform(4.0, 8.0, n)
    P = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z], 1)
    R, t = _rot_y(rng.uniform(0.05, 0.2)), np.array([0.8, 0.15, 0.1]) + 0.05 * rng.normal(size=3)
    uv1 = _project(P, np.eye(3), np.zeros(3)) + rng.normal(0, noise, (n, 2))
    uv2 = _project(P, R, t) + rng.normal(0, noise, (n, 2))
    out = rng.random(n) < outlier_frac
    uv2[out] = rng.uniform([0, 0], [640, 480], (out.sum(), 2))
    return uv1.astype(np.float32), uv2.astype(np.float32)


def _replay_idx(key, mask, H, size):
    """The reference's minimal sets: top ``size`` of uniform * mask per key."""
    maskf = jnp.asarray(mask, jnp.float32)
    return np.asarray(jax.vmap(lambda k: jax.lax.top_k(jax.random.uniform(k, (len(mask),)) * maskf, size)[1])(
        jax.random.split(key, H)))


def _border(err, thresh2):
    return np.abs(err - thresh2) < TOL * thresh2


def _normalized(uv1, uv2, mask, px):
    """The reference's Hartley-normalized points, transforms and squared
    threshold."""
    w = jnp.asarray(mask, jnp.float32)
    (x1n, T1), (x2n, T2) = jf._hartley_normalize(jnp.asarray(uv1), w), jf._hartley_normalize(jnp.asarray(uv2), w)
    return x1n, x2n, np.asarray(T1), np.asarray(T2), float((px * (0.5 * (T1[0, 0] + T2[0, 0]))) ** 2)


@pytest.fixture(scope="module")
def pairs():
    """A planar pair and two general pairs of 300 points, ragged masks."""
    rng = np.random.default_rng(0)
    uv = [_pair(rng, 300, planar) for planar in (True, False, False)]
    uv1 = np.stack([u[0] for u in uv])
    uv2 = np.stack([u[1] for u in uv])
    mask = rng.random((3, 300)) > 0.1
    return uv1, uv2, mask


def test_homography_and_gric_match_reference_on_replayed_draws(pairs):
    uv1, uv2, mask = pairs
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    ref = [jax.tree.map(np.asarray, jf.ransac_homography(jnp.asarray(uv1[p]), jnp.asarray(uv2[p]),
                                                         jnp.asarray(mask[p]), keys[p], 2.0, 256)) for p in range(3)]
    idx = np.stack([_replay_idx(keys[p], mask[p], 256, 4) for p in range(3)])
    got = tf.ransac_homography(torch.as_tensor(uv1), torch.as_tensor(uv2), torch.as_tensor(mask), 2.0, 256,
                               sample_idx=torch.as_tensor(idx))
    for p in range(3):
        np.testing.assert_allclose(_unit(got["H"][p].numpy()), _unit(ref[p]["H"]), atol=TOL)
        x1n, x2n, _, _, t2 = _normalized(uv1[p], uv2[p], mask[p], 2.0)
        err = np.asarray(jf._h_transfer_err(jnp.asarray(ref[p]["H"]), x1n, x2n))
        assert not ((got["inliers"][p].numpy() != ref[p]["inliers"]) & ~_border(err, t2)).any()
    # F inliers from the reference's F RANSAC: the planar pair is degenerate
    f_inl = np.stack([np.asarray(jf.ransac_fundamental(jnp.asarray(uv1[p]), jnp.asarray(uv2[p]), jnp.asarray(mask[p]),
                                                       keys[p], 2.0)["inliers"]) for p in range(3)])
    degen_j, ratio_j = zip(*(jf.gric_select_model(jnp.asarray(f_inl[p]), jnp.asarray(ref[p]["inliers"]),
                                                  jnp.asarray(mask[p])) for p in range(3)))
    degen_t, ratio_t = tf.gric_select_model(torch.as_tensor(f_inl), torch.as_tensor(np.stack([r["inliers"] for r in ref])),
                                            torch.as_tensor(mask))
    np.testing.assert_array_equal(degen_t.numpy(), np.asarray(degen_j))
    np.testing.assert_array_equal(degen_t.numpy(), [True, False, False])
    np.testing.assert_allclose(ratio_t.numpy(), np.asarray(ratio_j), atol=1e-6)


def _reference_test_pairs():
    """tests/frontend/test_fundamental.py's scene (200 points, 0.25 px at
    f = 500, 30% outliers), seeds 0 and 1, a ragged mask."""
    out = [_make_two_view(n=200, outlier_frac=0.3, noise=5e-4, seed=s) for s in (0, 1)]
    uv1 = np.stack([o[2] * 500 + np.array([320, 240]) for o in out]).astype(np.float32)
    uv2 = np.stack([o[3] * 500 + np.array([320, 240]) for o in out]).astype(np.float32)
    return uv1, uv2, np.random.default_rng(2).random((2, 200)) > 0.05


@pytest.mark.parametrize("scene", ["reference_test", "noisy"])
def test_fundamental_matches_reference_on_replayed_draws(pairs, scene):
    """On the reference test's scene, F to 1e-4 in the Hartley frame and
    inliers off the threshold's edge. On the noisier pairs (0.4 px, 20%
    outliers) the one LO refit that is accepted inherits the minimal
    solve's summation-order difference (4e-3 in the hypothesis, 2e-4 after
    the refit, measured): there the inlier counts agree within 2 and every
    reference inlier's Sampson distance within 0.25 px (threshold 2 px)."""
    if scene == "noisy":
        uv1, uv2, mask = (a[1:] for a in pairs)
    else:
        uv1, uv2, mask = _reference_test_pairs()
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    opts_j, opts_t = jf.FundamentalOptions(num_hypotheses=256), tf.FundamentalOptions(num_hypotheses=256)
    ref = [jax.tree.map(np.asarray, jf.ransac_fundamental(jnp.asarray(uv1[p]), jnp.asarray(uv2[p]),
                                                          jnp.asarray(mask[p]), keys[p], 2.0, opts_j)) for p in range(2)]
    idx = np.stack([_replay_idx(keys[p], mask[p], 256, 8) for p in range(2)])
    got = tf.ransac_fundamental(torch.as_tensor(uv1), torch.as_tensor(uv2), torch.as_tensor(mask), 2.0, opts_t,
                                sample_idx=torch.as_tensor(idx))
    for p in range(2):
        assert bool(got["success"][p]) and ref[p]["num_inliers"] > 120
        if scene == "noisy":
            assert abs(int(got["num_inliers"][p]) - int(ref[p]["num_inliers"])) <= 2

            def dist(F):
                return np.sqrt(np.asarray(jf._sampson_f(jnp.asarray(F), jnp.asarray(uv1[p]), jnp.asarray(uv2[p]))))

            inl = ref[p]["inliers"]
            assert np.abs(dist(got["F"][p].numpy()) - dist(ref[p]["F"]))[inl].max() < 0.25
            continue
        x1n, x2n, T1, T2, t2 = _normalized(uv1[p], uv2[p], mask[p], 2.0)

        def normalized(F_px):  # back to the Hartley frame, where F is estimated
            return _unit(np.linalg.inv(T2).T @ np.asarray(F_px, np.float64) @ np.linalg.inv(T1))

        F_n = normalized(ref[p]["F"])
        np.testing.assert_allclose(normalized(got["F"][p].numpy()), F_n, atol=TOL)
        err = np.asarray(jf._sampson_f(jnp.asarray(F_n, jnp.float32), x1n, x2n))
        assert not ((got["inliers"][p].numpy() != ref[p]["inliers"]) & ~_border(err, t2)).any()


def _dominant_plane():
    """tests/frontend/test_fundamental.py::test_degensac_recovers_from_dominant_plane's scene."""
    rng = np.random.default_rng(0)
    n_plane, n_off, n_out, noise = 280, 6, 40, 0.4
    R, t = _rot_y(0.15), np.array([0.8, 0.15, 0.1])
    pp = np.stack([rng.uniform(-2, 2, n_plane), rng.uniform(-1.5, 1.5, n_plane), np.full(n_plane, 5.0)], 1)
    po = np.stack([rng.uniform(-2, 2, n_off), rng.uniform(-1.5, 1.5, n_off), rng.uniform(2.2, 3.5, n_off)], 1)
    pts = np.concatenate([pp, po])
    uv1 = _project(pts, np.eye(3), np.zeros(3)) + rng.normal(0, noise, (len(pts), 2))
    uv2 = _project(pts, R, t) + rng.normal(0, noise, (len(pts), 2))
    o1 = rng.uniform([0, 0], [640, 480], (n_out, 2))
    o2 = rng.uniform([0, 0], [640, 480], (n_out, 2))
    return (np.concatenate([uv1, o1]).astype(np.float32), np.concatenate([uv2, o2]).astype(np.float32),
            slice(n_plane, n_plane + n_off))


@pytest.mark.parametrize("degensac", [False, True])
def test_degensac_on_a_dominant_plane_matches_reference(degensac):
    uv1, uv2, off = _dominant_plane()
    K = len(uv1)
    mask = np.ones(K, bool)
    key = jax.random.PRNGKey(0)
    ref = jax.tree.map(np.asarray, jf.ransac_fundamental(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask), key,
                                                         2.0, jf.FundamentalOptions(degensac=degensac)))
    opts = tf.FundamentalOptions(degensac=degensac)
    k77 = jax.random.fold_in(key, 77)
    u_h = jax.vmap(lambda k: jax.random.uniform(k, (K,)))(jax.random.split(k77, opts.degensac_h_hypotheses))

    def two(k):
        ka, kb = jax.random.split(k)
        return jnp.stack([jax.random.uniform(ka, (K,)), jax.random.uniform(kb, (K,))])

    u_pp = jax.vmap(two)(jax.random.split(jax.random.fold_in(k77, 1), 4 * opts.degensac_h_hypotheses))
    got = tf.ransac_fundamental(
        torch.as_tensor(uv1)[None], torch.as_tensor(uv2)[None], torch.as_tensor(mask)[None], 2.0, opts,
        sample_idx=torch.as_tensor(_replay_idx(key, mask, opts.num_hypotheses, 8))[None],
        degensac_uniforms=(torch.as_tensor(np.asarray(u_h))[None], torch.as_tensor(np.asarray(u_pp))[None]))
    inl_t, inl_j = got["inliers"][0].numpy(), ref["inliers"]
    if degensac:
        np.testing.assert_allclose(_unit(got["F"][0].numpy()), _unit(ref["F"]), atol=TOL)
        np.testing.assert_array_equal(inl_t, inl_j)
        assert inl_j[off].all() and inl_t[off].all()
        assert inl_t[off.stop:].sum() <= 3
    else:
        assert inl_j[off].mean() < 0.5 and inl_t[off].mean() < 0.5  # both fit the plane
        assert abs(int(inl_t.sum()) - int(inl_j.sum())) <= 5


def test_fundamental_to_essential_matches_reference():
    rng = np.random.default_rng(3)
    F = rng.normal(size=(4, 3, 3)).astype(np.float32)
    K1 = np.tile(KMAT.astype(np.float32), (4, 1, 1))
    K2 = K1 * np.float32(1.1)
    K2[:, 2, 2] = 1.0
    got = tf.fundamental_to_essential(torch.as_tensor(F), torch.as_tensor(K1), torch.as_tensor(K2)).numpy()
    for p in range(4):
        want = np.asarray(jf.fundamental_to_essential(jnp.asarray(F[p]), jnp.asarray(K1[p]), jnp.asarray(K2[p])))
        np.testing.assert_allclose(_unit(got[p]), _unit(want), atol=1e-5)
