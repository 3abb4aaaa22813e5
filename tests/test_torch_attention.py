"""The port's attention entries against the reference's.

The plain versions (what CPU tensors run) of the four entries of
fused_attention.py are held against:
- the reference's Pallas kernels in interpret mode, as
  tests/frontend/test_pallas_matcher.py runs them, at K multiples of the
  128-row query tile (float32; the Pallas kernels take one pair, so the
  reference runs pair by pair);
- the reference's XLA formula (``_attend``, ``_cross_attend``) at K = 200
  and 384, where the Pallas kernels leave trailing query rows unwritten
  (their query tile is widened without checking that it divides K), in
  float32 and in bf16.
Every case has the production head shape (4 heads of 64), one pair with a
fully masked key set (the -1e9 fill gives the mean of v) and K0 != K1 for
the cross entries. Tolerances: float32 2e-5 (the reference's own kernel
tests); bf16 one bf16 ulp of the output plus 2^-8 max|v|, the two bf16
roundings (probabilities, output) that XLA and PyTorch may place
differently. The CUDA kernel itself is held against the plain versions in
test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.matchers import pallas_attention as jpa
from gtsfm_tpu.frontend.matchers.lightglue import _attend as j_attend, _cross_attend as j_cross_attend
from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa

H, DH = 4, 64
F32_TOL = 2e-5


def _inputs(P, K0, K1, seed):
    """qk/v of both images (P, K, H*DH) float32, key masks (P, K) with pair
    0's keys all masked in both images."""
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(P, K, H * DH)).astype(np.float32) for K in (K0, K1, K0, K1)]
    m0 = rng.random((P, K0)) > 0.25
    m1 = rng.random((P, K1)) > 0.25
    m0[0] = False
    m1[0] = False
    return x, m0, m1


def _split(a):
    """(P, K, H*DH) numpy -> (P, H, K, DH)."""
    P, K, _ = a.shape
    return a.reshape(P, K, H, DH).transpose(0, 2, 1, 3)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


def _bf16_close(got, want, v):
    """|got - want| <= one bf16 ulp of want (2^-7 relative) + 2^-8 max|v|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = 2.0**-7 * np.abs(want) + 2.0**-8 * np.abs(np.asarray(v, np.float32)).max()
    assert np.all(np.abs(got - want) <= bound), float(np.abs(got - want).max())


ENTRIES = ["fused_attention", "fused_attention_merged", "fused_cross_attention",
           "fused_cross_attention_merged"]


def _port(entry, x, m0, m1, dtype=torch.float32):
    """The port's entry on CPU tensors -> list of numpy outputs in the
    merged layout."""
    qk0, qk1, v0, v1 = (_t(a, dtype) for a in x)
    t0, t1 = torch.as_tensor(m0), torch.as_tensor(m1)
    split = [fa.split_heads(a, H) for a in (qk0, qk1, v0, v1)]
    if entry == "fused_attention":
        out = [fa.merge_heads(fa.fused_attention(split[0], split[1], split[3], t1))]
    elif entry == "fused_attention_merged":
        out = [fa.fused_attention_merged(qk0, qk1, v1, H, t1)]
    elif entry == "fused_cross_attention":
        out = [fa.merge_heads(o) for o in fa.fused_cross_attention(*split, t0, t1)]
    else:
        out = list(fa.fused_cross_attention_merged(qk0, qk1, v0, v1, H, t0, t1))
    return [o.float().numpy() for o in out]


def _pallas(entry, x, m0, m1):
    """The reference's Pallas entry in interpret mode, pair by pair ->
    outputs in the merged layout."""
    outs = []
    for p in range(x[0].shape[0]):
        qk0, qk1, v0, v1 = (jnp.asarray(a[p]) for a in x)
        sp = [jnp.asarray(_split(a[p : p + 1])[0]) for a in x]
        b0, b1 = jnp.asarray(m0[p]), jnp.asarray(m1[p])
        if entry == "fused_attention":
            o = [jpa.fused_attention(sp[0], sp[1], sp[3], kv_mask=b1, interpret=True)]
        elif entry == "fused_attention_merged":
            o = [jpa.fused_attention_merged(qk0, qk1, v1, heads=H, kv_mask=b1, interpret=True)]
        elif entry == "fused_cross_attention":
            o = list(jpa.fused_cross_attention(*sp, mask0=b0, mask1=b1, interpret=True))
        else:
            o = list(jpa.fused_cross_attention_merged(qk0, qk1, v0, v1, heads=H, mask0=b0, mask1=b1,
                                                      interpret=True))
        o = [np.asarray(a) for a in o]
        outs.append([a.transpose(1, 0, 2).reshape(a.shape[1], H * DH) if a.ndim == 3 and a.shape[0] == H
                     else a for a in o])
    return [np.stack([outs[p][i] for p in range(len(outs))]) for i in range(len(outs[0]))]


@pytest.mark.parametrize("entry", ENTRIES)
def test_plain_matches_pallas_interpret(entry):
    x, m0, m1 = _inputs(2, 256, 128, seed=ENTRIES.index(entry))
    got = _port(entry, x, m0, m1)
    want = _pallas(entry, x, m0, m1)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    # pair 0 sees only masked keys: every query row gets the mean of v
    np.testing.assert_allclose(got[0][0], np.broadcast_to(x[3][0].mean(0), got[0][0].shape), atol=1e-5)


def _xla(entry, x, m0, m1, dtype):
    """The reference's XLA formula pair by pair (split layout) -> outputs
    in the merged layout."""
    outs = []
    for p in range(x[0].shape[0]):
        sp = [jnp.asarray(_split(a[p : p + 1])[0]) for a in x]
        b0, b1 = jnp.asarray(m0[p]), jnp.asarray(m1[p])
        if entry in ("fused_attention", "fused_attention_merged"):
            o = [j_attend(sp[0], sp[1], sp[3], kv_mask=b1, dtype=dtype)]
        else:
            o = list(j_cross_attend(*sp, mask0=b0, mask1=b1, dtype=dtype))
        outs.append([np.asarray(a.astype(jnp.float32)).transpose(1, 0, 2).reshape(a.shape[1], H * DH)
                     for a in o])
    return [np.stack([outs[p][i] for p in range(len(outs))]) for i in range(len(outs[0]))]


@pytest.mark.parametrize("K0,K1", [(200, 200), (384, 384), (384, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_xla_formula(K0, K1, dtype):
    x, m0, m1 = _inputs(2, K0, K1, seed=K0 + K1)
    if dtype == "bfloat16":  # the same bf16 values reach both packages
        x = [_t(a, torch.bfloat16).float().numpy() for a in x]
    for entry in ENTRIES:
        got = _port(entry, x, m0, m1, getattr(torch, dtype))
        want = _xla(entry, x, m0, m1, getattr(jnp, dtype))
        vs = [x[3], x[2]]  # o0 weighs v1, o1 weighs v0
        for g, w, v in zip(got, want, vs):
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
            else:
                _bf16_close(g, w, v)


def test_wrappers_run_the_plain_version_on_cpu():
    x, m0, m1 = _inputs(2, 128, 96, seed=7)
    before = fa.launch_count
    for entry in ENTRIES:
        got = _port(entry, x, m0, m1, torch.bfloat16)
        assert all(np.isfinite(g).all() for g in got)
    qk0, qk1, v0, v1 = (_t(a, torch.bfloat16) for a in x)
    got = fa.fused_attention_merged(qk0, qk1, v1, H, torch.as_tensor(m1))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fa.attend_merged(qk0, qk1, v1, H, torch.as_tensor(m1)))
    assert fa.launch_count == before  # CPU tensors never launch the kernel


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "mask_dtype", "mask_shape", "dtype_mix"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    x, m0, m1 = _inputs(2, 128, 96, seed=8)
    q, k, v = (fa.split_heads(_t(a), H) for a in (x[0], x[1], x[3]))
    mask = torch.as_tensor(m1)
    if bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        v = v[:, :, :50]
    elif bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif bad == "mask_shape":
        mask = mask[:, :10]
    else:
        k = k.to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        fa.fused_attention(q, k, v, mask)
