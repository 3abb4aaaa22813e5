"""The port's mutual-NN matcher against the reference.

The plain PyTorch matcher (what CPU tensors run) is held against the JAX
``match_descriptors`` with its bf16 similarity and against the Pallas
kernel in interpret mode, on the same seeded inputs. Descriptors are
rounded to bf16 up front so the Pallas kernel's float32 dot sees the same
values. Tolerances: ``idx`` / ``ok`` exact; ``best`` 1e-5 where matched
(sums of exact bf16 products, float32, different order). The CUDA kernel
itself is held against the plain version in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.matchers.mutual_nn import match_descriptors as jax_match
from gtsfm_tpu.frontend.matchers.pallas_matcher import pallas_match_descriptors
from gtsfm_tpu_torch.frontend.matchers import fused_matcher
from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors

P, K, D = 4, 256, 128


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16).to(torch.float32).numpy()


def _inputs(case: str):
    rng = np.random.default_rng({"partial_masks": 0, "all_masked": 1, "duplicates": 2}[case])
    d1 = _unit(rng.normal(size=(P, K, D)))
    d2 = np.concatenate([
        _unit(d1[:, : K // 2] + 0.05 * rng.normal(size=(P, K // 2, D))),
        _unit(rng.normal(size=(P, K // 2, D))),
    ], axis=1)
    for p in range(P):
        d2[p] = d2[p][rng.permutation(K)]
    m1 = np.ones((P, K), bool)
    m2 = np.ones((P, K), bool)
    if case == "partial_masks":
        m1 = rng.random((P, K)) > 0.2
        m2 = rng.random((P, K)) > 0.2
    elif case == "all_masked":
        m1[1] = False
        m2[1] = False
        m2[2] = False
    elif case == "duplicates":
        # duplicated rows of desc1: the column argmax must pick the first
        d1[:, 11] = d1[:, 10]
        d1[:, 41] = d1[:, 40]
    return _bf16(d1).astype(np.float32), _bf16(d2).astype(np.float32), m1, m2


def _assert_same(got, want):
    gi, gok, gb = (np.asarray(a) for a in got)
    wi, wok, wb = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gb[wok], wb[wok], atol=1e-5, rtol=0)


CASES = ["partial_masks", "all_masked", "duplicates"]


@pytest.mark.parametrize("case", CASES)
def test_plain_matcher_matches_jax_bf16(case):
    d1, d2, m1, m2 = _inputs(case)
    want = jax.vmap(lambda a, b, c, d: jax_match(a, b, c, d, use_bf16=True))(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2)
    )
    got = match_descriptors(torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(m1), torch.as_tensor(m2))
    _assert_same(got, want)
    if case == "all_masked":
        assert not np.asarray(got[1])[1].any() and not np.asarray(got[1])[2].any()
    if case == "duplicates":
        ok = np.asarray(got[1])
        idx = np.asarray(got[0])
        for first, dup in ((10, 11), (40, 41)):
            # the duplicate row never wins the column it ties on
            assert not (ok[:, dup] & ok[:, first] & (idx[:, dup] == idx[:, first])).any()
            assert ok[:, first].any()


@pytest.mark.parametrize("case", CASES)
def test_plain_matcher_matches_pallas_interpret(case):
    d1, d2, m1, m2 = _inputs(case)
    want = [
        pallas_match_descriptors(jnp.asarray(d1[p]), jnp.asarray(d2[p]), jnp.asarray(m1[p]),
                                 jnp.asarray(m2[p]), tile_m=128, interpret=True)
        for p in range(P)
    ]
    want = tuple(np.stack([np.asarray(w[i]) for w in want]) for i in range(3))
    got = match_descriptors(torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(m1), torch.as_tensor(m2))
    _assert_same(got, want)


def test_wrapper_uses_plain_version_on_cpu():
    d1, d2, m1, m2 = (torch.as_tensor(a) for a in _inputs("partial_masks"))
    before = fused_matcher.launch_count
    got = fused_matcher.fused_match_descriptors(d1, d2, m1, m2)
    want = match_descriptors(d1, d2, m1, m2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused_matcher.launch_count == before  # CPU tensors never launch the kernel


@pytest.mark.parametrize("bad", ["rank", "width", "mask_dtype", "mask_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    d1, d2, m1, m2 = (torch.as_tensor(a) for a in _inputs("partial_masks"))
    if bad == "rank":
        d1 = d1[0]
    elif bad == "width":
        d1, d2 = d1[..., :100], d2[..., :100]
    elif bad == "mask_dtype":
        m1 = m1.to(torch.uint8)
    else:
        m2 = m2[:, :10]
    with pytest.raises((ValueError, TypeError)):
        fused_matcher.fused_match_descriptors(d1, d2, m1, m2)
