"""Fused multi-head attention: the hand-written CUDA kernel, its four
entries and their plain PyTorch versions.

Port of gtsfm_tpu/frontend/matchers/pallas_attention.py, with a pair axis
written out in front of every argument:

| entry                          | layout                              | reference kernel          |
|--------------------------------|-------------------------------------|---------------------------|
| ``fused_attention``            | q (P, h, Kq, dh), k/v (P, h, Kk, dh) | ``_attn_kernel``          |
| ``fused_attention_merged``     | q (P, Kq, h*dh), k/v (P, Kk, h*dh)   | ``_attn_kernel_2d``       |
| ``fused_cross_attention``      | (P, h, K0|K1, dh), both directions   | ``_cross_kernel``         |
| ``fused_cross_attention_merged`` | (P, K0|K1, h*dh), both directions  | ``_attn_kernel_2d`` twice |

All four run one kernel, csrc/fused_attention.cu, which addresses q, k, v
and the output through pair, row and head strides, so neither layout is
copied. A cross entry launches it twice with the images' roles swapped:
the reference's column softmax of S = qk0 qk1^T is a row softmax of S^T.

The plain versions (``attend``, ``attend_merged``, ``cross_attend``,
``cross_attend_merged``) are the reference's XLA formula
(lightglue.py ``_attend`` / ``_cross_attend``): float32 scores, a masked
key set to -1e9 (so a fully masked key set gives the mean of v), float32
softmax, the probabilities cast to the working dtype, a float32-accumulated
product with v, and the output in the input dtype. They run in chunks of
pairs so that one chunk's float32 score tensor stays under
``PLAIN_SCORE_BYTES``.

A CPU tensor runs the plain version. A CUDA tensor launches the kernel, or
raises: the kernel takes bf16 only, with dh in ``HEAD_DIMS``. Neither falls
back to the other. What bounds the kernel on the card and how it is built
is written in the CUDA source and in utils/cuda_build.py.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gtsfm_tpu_torch.utils import cuda_build

MASK_FILL = -1e9
HEAD_DIMS = (16, 32, 64, 128)
PLAIN_SCORE_BYTES = 1 << 30

# launches of the CUDA kernel in this process (a cross entry launches it
# twice; never incremented by the CPU path)
launch_count = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _pair_chunks(P: int, per_pair_bytes: int):
    step = max(1, PLAIN_SCORE_BYTES // max(per_pair_bytes, 1))
    return [slice(s, s + step) for s in range(0, P, step)]


def _attend_chunk(q, k, v, kv_mask):
    dt = q.dtype
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, MASK_FILL)
    a = torch.softmax(s, dim=-1)
    return torch.matmul(a.to(dt).float(), v.float()).to(dt)


def attend(q, k, v, kv_mask=None):
    """The XLA formula on the split layout: q (P, h, Kq, dh), k/v
    (P, h, Kk, dh), kv_mask (P, Kk) bool or None -> (P, h, Kq, dh) in q's
    dtype."""
    P, h, Kq, _ = q.shape
    out = [
        _attend_chunk(q[c], k[c], v[c], None if kv_mask is None else kv_mask[c])
        for c in _pair_chunks(P, 4 * h * Kq * k.shape[2])
    ]
    return torch.cat(out) if len(out) > 1 else out[0]


def cross_attend(qk0, qk1, v0, v1, mask0=None, mask1=None):
    """The XLA formula of bidirectional cross attention from one score
    matrix S = qk0 qk1^T / sqrt(dh): a row softmax under mask1 times v1
    gives o0, a column softmax under mask0 contracted with v0 gives o1.
    (P, h, K0|K1, dh) -> (o0, o1) in the input dtype."""
    P, h, K0, dh = qk0.shape
    dt = qk0.dtype
    o0, o1 = [], []
    for c in _pair_chunks(P, 4 * h * K0 * qk1.shape[2]):
        s = torch.matmul(qk0[c].float(), qk1[c].float().transpose(-1, -2)) / math.sqrt(dh)
        s0 = s if mask1 is None else torch.where(mask1[c][:, None, None, :], s, MASK_FILL)
        s1 = s if mask0 is None else torch.where(mask0[c][:, None, :, None], s, MASK_FILL)
        a0 = torch.softmax(s0, dim=-1)
        a1 = torch.softmax(s1, dim=-2)  # down the image-0 axis of the same s
        o0.append(torch.matmul(a0.to(dt).float(), v1[c].float()).to(dt))
        o1.append(torch.matmul(a1.to(dt).float().transpose(-1, -2), v0[c].float()).to(dt))
    return torch.cat(o0), torch.cat(o1)


def split_heads(x, heads: int):
    """(P, K, h*dh) -> the (P, h, K, dh) view (no copy when the last
    dimension is contiguous)."""
    P, K, D = x.shape
    return x.reshape(P, K, heads, D // heads).transpose(1, 2)


def merge_heads(x):
    P, h, K, dh = x.shape
    return x.transpose(1, 2).reshape(P, K, h * dh)


def attend_merged(q, k, v, heads: int, kv_mask=None):
    """``attend`` on the merged layout: q (P, Kq, h*dh), k/v (P, Kk, h*dh),
    heads as column slices -> (P, Kq, h*dh)."""
    return merge_heads(attend(split_heads(q, heads), split_heads(k, heads),
                               split_heads(v, heads), kv_mask))


def cross_attend_merged(qk0, qk1, v0, v1, heads: int, mask0=None, mask1=None):
    """``cross_attend`` on the merged layout: (P, K0|K1, h*dh) -> (o0, o1)."""
    o0, o1 = cross_attend(*(split_heads(x, heads) for x in (qk0, qk1, v0, v1)), mask0, mask1)
    return merge_heads(o0), merge_heads(o1)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------
def _kernel():
    return cuda_build.function(
        "fused_attention", "gtsfm_fused_attention",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )


def _check(q, k, v, kv_mask):
    """q (P, h, Kq, dh), k/v (P, h, Kk, dh) views; kv_mask (P, Kk) bool."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-d: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    P, h, _, dh = q.shape
    Kk = k.shape[2]
    if tuple(k.shape) != (P, h, Kk, dh) or tuple(v.shape) != (P, h, Kk, dh):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (P, Kk):
            raise ValueError(f"kv_mask must be (P, Kk) = {(P, Kk)}: {tuple(kv_mask.shape)}")
        if kv_mask.dtype != torch.bool:
            raise TypeError("kv_mask must be bool")
    for t in (k, v) + (() if kv_mask is None else (kv_mask,)):
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
    if not q.dtype.is_floating_point or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one floating dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if min(q.shape) == 0 or Kk == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, Kk={Kk}")


def _addressable(x):
    """A (P, h, K, dh) view the kernel can read with 4-byte loads: the head
    dimension contiguous, every other stride even, the base 4-byte
    aligned. Otherwise a contiguous copy."""
    ok = x.stride(3) == 1 and all(s % 2 == 0 for s in x.stride()[:3]) and x.data_ptr() % 4 == 0
    return x if ok else x.contiguous()


def _launch(q, k, v, kv_mask, out):
    """One kernel launch over (P, h, K, dh) views; writes ``out``."""
    global launch_count
    P, h, Kq, dh = q.shape
    Kk = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bf16 on the card, got {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if P > 65535 or h > 65535:
        raise ValueError(f"unsupported sizes P={P} h={h}")
    q, k, v = _addressable(q), _addressable(k), _addressable(v)
    mask = None if kv_mask is None else kv_mask.contiguous()
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(2), t.stride(1)]  # pair, row, head
    strides.append(Kk)
    c_strides = (ctypes.c_longlong * 13)(*strides)
    kernel = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if mask is None else mask.data_ptr(),
            out.data_ptr(), ctypes.addressof(c_strides), P, h, Kq, Kk, dh, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused attention launch failed: cudaError {rc}")
    launch_count += 1
    return out


def fused_attention(q, k, v, kv_mask=None):
    """Masked attention on the split layout: q (P, h, Kq, dh), k/v
    (P, h, Kk, dh), kv_mask (P, Kk) bool or None -> (P, h, Kq, dh) in q's
    dtype. CPU tensors run ``attend``; CUDA tensors launch the kernel."""
    _check(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return attend(q, k, v, kv_mask)
    return _launch(q, k, v, kv_mask, torch.empty(q.shape, dtype=q.dtype, device=q.device))


def fused_attention_merged(q, k, v, heads: int, kv_mask=None):
    """Masked attention on the merged layout: q (P, Kq, h*dh), k/v
    (P, Kk, h*dh), heads as column slices -> (P, Kq, h*dh). CPU tensors run
    ``attend_merged``; CUDA tensors launch the kernel on strided views."""
    if q.dim() != 3 or q.shape[-1] % heads != 0:
        raise ValueError(f"q must be (P, Kq, heads*dh) with heads={heads}: {tuple(q.shape)}")
    qh, kh, vh = (split_heads(x, heads) for x in (q, k, v))
    _check(qh, kh, vh, kv_mask)
    if q.device.type == "cpu":
        return attend_merged(q, k, v, heads, kv_mask)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(qh, kh, vh, kv_mask, split_heads(out, heads))
    return out


def fused_cross_attention(qk0, qk1, v0, v1, mask0=None, mask1=None):
    """Bidirectional cross attention on the split layout: qk0/v0
    (P, h, K0, dh), qk1/v1 (P, h, K1, dh) -> (o0 (P, h, K0, dh),
    o1 (P, h, K1, dh)). CPU tensors run ``cross_attend``; CUDA tensors
    launch the kernel twice (0 -> 1 under mask1, 1 -> 0 under mask0)."""
    _check(qk0, qk1, v1, mask1)
    _check(qk1, qk0, v0, mask0)
    if qk0.device.type == "cpu":
        return cross_attend(qk0, qk1, v0, v1, mask0, mask1)
    o0 = _launch(qk0, qk1, v1, mask1, torch.empty(qk0.shape, dtype=qk0.dtype, device=qk0.device))
    o1 = _launch(qk1, qk0, v0, mask0, torch.empty(qk1.shape, dtype=qk1.dtype, device=qk1.device))
    return o0, o1


def fused_cross_attention_merged(qk0, qk1, v0, v1, heads: int, mask0=None, mask1=None):
    """Bidirectional cross attention on the merged layout: qk0/v0
    (P, K0, h*dh), qk1/v1 (P, K1, h*dh) -> (o0, o1) in the same layout.
    CPU tensors run ``cross_attend_merged``; CUDA tensors launch the kernel
    twice, as the reference calls its merged kernel twice."""
    if qk0.device.type == "cpu":
        for a, b, c, m in ((qk0, qk1, v1, mask1), (qk1, qk0, v0, mask0)):
            _check(*(split_heads(x, heads) for x in (a, b, c)), m)
        return cross_attend_merged(qk0, qk1, v0, v1, heads, mask0, mask1)
    return (fused_attention_merged(qk0, qk1, v1, heads, kv_mask=mask1),
            fused_attention_merged(qk1, qk0, v0, heads, kv_mask=mask0))
