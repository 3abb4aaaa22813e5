"""The port's DoG-SIFT detector and tiny global descriptor against the JAX
reference, on the CPU.

The same seeded numpy images go through ``gtsfm_tpu``'s
``detect_and_describe`` (per image, batched with ``jax.vmap`` as its
registry's adapter does) and the port's batched ``detect_and_describe``.

Tolerances, and why:
- the masked keypoint sets are equal, and so are the coordinates (integer
  pixels times powers of two);
- responses: 1e-5 relative plus 1e-6 absolute. XLA's ``exp`` (the blur
  weights) and its convolution sum in another order than PyTorch's, so the
  blurred images differ by up to 4.2e-7 (a few float32 ulps of values
  near 0.5), and a response, about 0.01 or more, is the difference of two
  of them: up to 8.4e-7 apart (measured: 5.4e-7, 2.5e-5 relative);
- the order of keypoints may differ only where two responses lie within
  that tolerance of each other (the final top-K sorts by response);
- descriptors of the same keypoint agree to 1e-4 on at least 99% of the
  keypoints; the others are orientation histograms whose two highest bins
  lie within float32 round-off, where argmax may take the other bin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from gtsfm_tpu.frontend.detectors.dog_sift import DoGSiftOptions as JOptions, detect_and_describe as j_detect
from gtsfm_tpu.frontend.global_descriptors.descriptors import TinyImageDescriptor as JTiny
from gtsfm_tpu_torch.frontend.detectors.dog_sift import (
    DoGSift,
    DoGSiftOptions,
    detect_and_describe,
    resize_linear,
    stable_topk,
)
from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import TinyImageDescriptor
from tests.torch_threads import cap_threads

cap_threads()

RESP_RTOL, RESP_ATOL = 1e-5, 1e-6
DESC_TOL = 1e-4
DESC_SHARE = 0.01  # at most this share of keypoints may differ beyond DESC_TOL


def _test_image(h=160, w=160, seed=0):
    """The reference test's image (tests/frontend/test_dog_sift.py): a
    smoothed blocky random image."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(h // 8, w // 8)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))
    return ndi.gaussian_filter(img, 1.0)


def _reference(images: np.ndarray, **kw):
    """JAX's detect_and_describe over the batch with vmap: (coordinates,
    scales, responses, mask, descriptors) as numpy."""
    opts = JOptions(**kw)
    kps, desc = jax.jit(jax.vmap(lambda im: j_detect(im, opts)))(jnp.asarray(images))
    return tuple(np.asarray(a) for a in (kps.coordinates, kps.scales, kps.responses, kps.mask, desc))


def _port(images: np.ndarray, **kw):
    return tuple(a.numpy() for a in detect_and_describe(torch.as_tensor(images), DoGSiftOptions(**kw)))


def _assert_agree(ref, got):
    """Hold one image's port output against the reference's (the module
    docstring's tolerances). Returns the share of keypoints whose
    descriptors differ by more than DESC_TOL."""
    (jc, js, jr, jm, jd), (tc, ts, tr, tm, td) = ref, got
    assert jm.sum() == tm.sum()
    np.testing.assert_array_equal(jc[~jm], tc[~tm])  # the padded rows
    key_j = {(x, y, s): i for i, (x, y, s) in enumerate(zip(jc[jm, 0], jc[jm, 1], js[jm]))}
    key_t = {(x, y, s): i for i, (x, y, s) in enumerate(zip(tc[tm, 0], tc[tm, 1], ts[tm]))}
    assert key_j.keys() == key_t.keys()
    idx_j = np.flatnonzero(jm)[list(key_j.values())]
    idx_t = np.flatnonzero(tm)[[key_t[k] for k in key_j]]
    np.testing.assert_allclose(tr[idx_t], jr[idx_j], rtol=RESP_RTOL, atol=RESP_ATOL)
    # a keypoint may sit at another rank only among responses within the tolerance
    moved = idx_j != idx_t
    for i_j, i_t in zip(idx_j[moved], idx_t[moved]):
        lo, hi = sorted((i_j, i_t))
        assert jr[lo] - jr[hi] <= RESP_ATOL + RESP_RTOL * jr[lo], (jr[lo], jr[hi])
    off = np.abs(td[idx_t] - jd[idx_j]).max(axis=-1) > DESC_TOL
    return float(off.mean()) if off.size else 0.0


def test_reference_test_image():
    kw = dict(max_keypoints=256, num_octaves=3, contrast_threshold=0.01)
    img = _test_image()[None]
    share = _assert_agree([a[0] for a in _reference(img, **kw)], [a[0] for a in _port(img, **kw)])
    assert share <= DESC_SHARE, share


def test_padded_batch_of_four_at_k2048():
    """Four procedural images zero-padded into one 240x320 batch, as the
    loader pads a scene's images; K=2048 > 12 levels x 170, so the final
    selection pads (the reference's padding branch)."""
    kw = dict(max_keypoints=2048, contrast_threshold=0.01)
    batch = np.zeros((4, 240, 320), np.float32)
    for b, (h, w) in enumerate([(240, 320), (200, 320), (240, 256), (160, 200)]):
        batch[b, :h, :w] = _test_image(h, w, seed=10 + b)
    ref, got = _reference(batch, **kw), _port(batch, **kw)
    assert got[0].shape == (4, 2048, 2) and got[4].shape == (4, 2048, 128)
    shares = [_assert_agree([a[b] for a in ref], [a[b] for a in got]) for b in range(4)]
    assert max(shares) <= DESC_SHARE, shares
    assert all(got[3][b].sum() > 100 for b in range(4))
    # the detector component's contract: numpy, border mask left to the scene optimizer
    coords, mask, descs = DoGSift(DoGSiftOptions(**kw)).detect_batch(batch)
    np.testing.assert_array_equal(coords, got[0])
    np.testing.assert_array_equal(mask, got[3])
    np.testing.assert_array_equal(descs, got[4])


def test_blank_image():
    kw = dict(max_keypoints=256, num_octaves=3, contrast_threshold=0.01)
    img = np.full((1, 96, 128), 0.5, np.float32)
    ref, got = _reference(img, **kw), _port(img, **kw)
    assert not got[3].any() and not ref[3].any()
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)


def test_ties_take_the_lowest_index_first():
    # stable_topk against jax.lax.top_k on rows full of equal values
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, size=(5, 1000)).astype(np.float32)
    x[:, 900] = x[:, 5] = 7.0
    vals, idx = stable_topk(torch.as_tensor(x), 64)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx[0, 0] == 5 and idx[0, 1] == 900
    # a detector input with many equal responses: identical blobs on a grid
    img = np.zeros((128, 128), np.float32)
    for y in range(16, 112, 16):
        for x_ in range(16, 112, 16):
            img[y - 2 : y + 3, x_ - 2 : x_ + 3] = 1.0
    img = ndi.gaussian_filter(img, 1.0)[None]
    kw = dict(max_keypoints=64, num_octaves=2, contrast_threshold=0.01)
    ref, got = _reference(img, **kw), _port(img, **kw)
    assert ref[3].sum() > 0
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize("shape,size", [((480, 640), (240, 320)), ((241, 321), (120, 160)),
                                        ((480, 640), (32, 32)), ((120, 160), (240, 320))])
def test_antialiased_resize(shape, size):
    """resize_linear against jax.image.resize(..., "linear") (antialiased
    when it downsamples), to 1e-6."""
    x = np.random.default_rng(1).random((2, *shape), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size), "linear"))
    np.testing.assert_allclose(resize_linear(torch.as_tensor(x), size).numpy(), want, atol=1e-6, rtol=0)


def test_tiny_image_descriptor():
    x = np.random.default_rng(2).random((3, 240, 320), dtype=np.float32)
    want = JTiny().describe_batch(x)
    got = TinyImageDescriptor().describe_batch(x)
    assert got.shape == (3, 1024)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
