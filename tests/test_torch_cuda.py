"""The port on a CUDA card: the fused matcher and attention kernels against
their plain PyTorch versions, and the back end's run-to-run
reproducibility.

These tests need a CUDA card (marker ``cuda``) and skip elsewhere. The
file imports no JAX, so it also runs on a card's machine without it; there
run it without tests/conftest.py, which sets JAX up for the reference tests:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Matcher shapes cover what the kernel takes beyond the slice's (P, 1024, 128):
ragged K1 != K2 that are not multiples of the 64-row tile, narrow and wide
D, a single keypoint, an all-masked pair and exact ties. Tolerances: ``best``
1e-5 everywhere; ``idx`` / ``ok`` exact on every row whose best and
second-best similarities differ by more than 1e-4 (float32 sums of exact
bf16 products in another order can swap nearer ties).

Attention shapes cover what the kernel takes beyond LightGlue's
(96, 2048, 4 heads of 64): ragged K0 != K1 that are not multiples of the
64-row tile, one pair, narrow (16, 32) and wide (128) head dims, and a
fully masked key set, through all four entries. Tolerance: chip_smoke's
``attention_agrees`` (ATTN_TOL_V * max|v| + ATTN_TOL_OUT * |want|, the two
bf16 roundings the kernel and the plain version place differently).
"""

import numpy as np
import pytest
import torch

from chip_smoke import KERNEL_TOL_BEST, attention_agrees, attention_entries, kernel_agrees
from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
from gtsfm_tpu_torch.utils.numerics import precise

# name: (P, K1, K2, D)
SHAPES = {
    "square": (4, 256, 256, 128),
    "ragged": (3, 1000, 777, 128),
    "narrow": (2, 70, 130, 24),
    "wide": (2, 128, 192, 512),
    "single": (2, 1, 1, 8),
    "all_masked": (2, 64, 64, 128),
    "ties": (2, 256, 256, 128),
}


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(case: str):
    P, K1, K2, D = SHAPES[case]
    rng = np.random.default_rng(sorted(SHAPES).index(case))
    d1 = _unit(rng.normal(size=(P, K1, D)))
    n_true = min(K1, K2) // 2
    d2 = _unit(rng.normal(size=(P, K2, D)))
    d2[:, :n_true] = _unit(d1[:, :n_true] + 0.05 * rng.normal(size=(P, n_true, D)))
    for p in range(P):
        d2[p] = d2[p][rng.permutation(K2)]
    m1 = rng.random((P, K1)) > 0.1
    m2 = rng.random((P, K2)) > 0.1
    if case == "single":
        m1[:] = True
        m2[:] = True
    elif case == "all_masked":
        m1[1] = False
    elif case == "ties":
        d1[:, 11] = d1[:, 10]
        d2[:, 21] = d2[:, 20]
    return tuple(torch.as_tensor(a, device="cuda") for a in (
        d1.astype(np.float32), d2.astype(np.float32), m1, m2))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    d1, d2, m1, m2 = _inputs(case)
    before = fused_matcher.launch_count
    with precise():
        got = fused_matcher.fused_match_descriptors(d1, d2, m1, m2)
        want = match_descriptors(d1, d2, m1, m2)
    assert fused_matcher.launch_count == before + 1
    gi, gok, gb = got
    assert gi.dtype == torch.int32 and gok.dtype == torch.bool and gb.dtype == torch.float32
    err, n_decisive, n_differ = kernel_agrees(got, want, d1, d2, m1, m2)
    assert err <= KERNEL_TOL_BEST
    assert n_decisive > 0
    assert n_differ == 0
    if case == "all_masked":
        assert not bool(gok[1].any())
    if case == "ties":
        # row 11 duplicates row 10: it never wins the column they tie on
        assert not bool((gok[:, 11] & (gi[:, 11] == gi[:, 10]) & gok[:, 10]).any())
        # columns 20 and 21 are equal: a row whose best is one of them has
        # an equal second best, so the ratio test rejects it
        assert not bool((gok & ((gi == 20) | (gi == 21))).any())


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d1, d2, m1, m2 = _inputs("square")
    with pytest.raises(ValueError):
        fused_matcher.fused_match_descriptors(d1[..., :100], d2[..., :100], m1, m2)
    with pytest.raises(ValueError):
        fused_matcher.fused_match_descriptors(d1, d2.cpu(), m1, m2)


# name: (P, K0, K1, heads, dh)
ATTN_SHAPES = {
    "ragged": (3, 1000, 777, 4, 64),
    "one_pair": (1, 130, 70, 4, 64),
    "narrow16": (2, 200, 96, 2, 16),
    "narrow32": (2, 96, 200, 8, 32),
    "wide128": (2, 300, 257, 2, 128),
    "all_masked": (2, 128, 128, 4, 64),
}
ATTN_ENTRIES = ["fused_attention", "fused_attention_merged", "fused_cross_attention",
                "fused_cross_attention_merged"]


def _attention_inputs(case: str):
    P, K0, K1, heads, dh = ATTN_SHAPES[case]
    rng = np.random.default_rng(sorted(ATTN_SHAPES).index(case))

    def x(K):
        return torch.as_tensor(rng.normal(size=(P, K, heads * dh)).astype(np.float32),
                               device="cuda").to(torch.bfloat16)

    m0 = torch.as_tensor(rng.random((P, K0)) > 0.2, device="cuda")
    m1 = torch.as_tensor(rng.random((P, K1)) > 0.2, device="cuda")
    if case == "all_masked":
        m0[:] = False
        m1[:] = False
    return (x(K0), x(K1), x(K0), x(K1), m0, m1), heads


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ATTN_ENTRIES)
@pytest.mark.parametrize("case", sorted(ATTN_SHAPES))
def test_attention_kernel_matches_plain_version(case, entry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    (q0, q1, v0, v1, m0, m1), heads = _attention_inputs(case)
    name, kern, plain, vs = next(e for e in attention_entries(q0, q1, v0, v1, m0, m1, heads) if e[0] == entry)
    before = fused_attention.launch_count
    with precise():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
    assert fused_attention.launch_count == before + len(got)  # one launch per direction
    for g, w, v in zip(got, want, vs):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err, ratio, finite = attention_agrees(g, w, v)
        assert finite and ratio <= 1.0, (err, ratio)
    if case == "all_masked":  # the -1e9 fill: every row is the mean of v
        o = got[0] if got[0].dim() == 3 else fused_attention.merge_heads(got[0])
        assert attention_agrees(o, v1.float().mean(dim=1, keepdim=True).expand(o.shape), v1)[1] <= 1.0


@pytest.mark.cuda
def test_attention_wrapper_raises_on_what_the_kernel_does_not_take_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (q0, q1, v0, v1, m0, m1), heads = _attention_inputs("one_pair")
    with pytest.raises(TypeError):  # float32 on the card: no silent plain version
        fused_attention.fused_attention_merged(q0.float(), q1.float(), v1.float(), heads, m1)
    with pytest.raises(ValueError):  # head dim 48
        fused_attention.fused_attention_merged(q0[..., :192], q1[..., :192], v1[..., :192], heads, m1)
    with pytest.raises(ValueError):
        fused_attention.fused_attention_merged(q0, q1, v1, heads, m1.cpu())


@pytest.mark.cuda
def test_averaging_is_bitwise_reproducible_on_the_card():
    """Rotation and translation averaging of a noisy 32-camera ring, twice
    each on the card: the results are bit for bit the same (the normal
    matrices are assembled without float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.averaging.rotation.averaging import RotationAveraging
    from gtsfm_tpu_torch.averaging.translation.averaging import TranslationAveraging
    from gtsfm_tpu_torch.geometry import so3
    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses

    n = 32
    edges = np.asarray(sorted({(min(i, (i + k) % n), max(i, (i + k) % n))
                               for i in range(n) for k in (1, 2, 3)}), np.int64)
    gt = spectral_ring_poses(edges, n)
    R, t = gt.R.numpy().astype(np.float64), gt.t.numpy().astype(np.float64)
    rng = np.random.default_rng(0)
    rel = np.einsum("eji,ejk->eik", R[edges[:, 1]], R[edges[:, 0]])
    noise = so3.expmap(torch.as_tensor(rng.normal(0, np.radians(1.0), (len(edges), 3)), dtype=torch.float32))
    i2Ri1 = torch.as_tensor(np.einsum("eij,ejk->eik", noise.numpy(), rel), dtype=torch.float32, device="cuda")
    d = np.einsum("eji,ej->ei", R[edges[:, 1]], t[edges[:, 0]] - t[edges[:, 1]]) + rng.normal(0, 0.05, (len(edges), 3))
    i2Ui1 = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32, device="cuda")
    inliers = rng.integers(50, 200, len(edges))

    wRi = [RotationAveraging().run(n, edges, i2Ri1, num_inliers=inliers)[0] for _ in range(2)]
    assert torch.equal(wRi[0], wRi[1])
    wti = [TranslationAveraging().run(n, edges, i2Ui1, wRi[0])[0] for _ in range(2)]
    assert torch.equal(wti[0], wti[1])
    assert bool(torch.isfinite(wti[0]).all())
