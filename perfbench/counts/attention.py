"""Work of one call of an attention entry of LightGlue, from its inputs:
every query row against the valid keys, q.k and p.v at 2 operations per
multiply-add (4 * h*dh * Kq * valid keys a direction), and the bytes of
each input read once and each output written once. The arithmetic of the
port's kernel table (PERF.md, kernels #2-#4).

The operations come back as a device tensor (a sum over the key mask, not
copied to the host inside the window)."""

from __future__ import annotations

import torch


def _keys(mask, P: int, K: int):
    return torch.tensor(float(P * K)) if mask is None else mask.sum(dtype=torch.float64)


def _mask_bytes(*masks) -> int:
    return sum(0 if m is None else m.nbytes for m in masks)


def attention_work(entry: str, *args, **kwargs) -> tuple:
    """(operations, bytes) of ``entry`` called with these arguments."""
    if entry == "fused_attention_merged":  # q, k, v (P, K, h*dh), heads
        q, k, v = args[:3]
        mask = kwargs.get("kv_mask", args[4] if len(args) > 4 else None)
        flops = 4.0 * q.shape[-1] * q.shape[1] * _keys(mask, k.shape[0], k.shape[1])
        return flops, 2 * q.nbytes + k.nbytes + v.nbytes + _mask_bytes(mask)
    if entry == "fused_attention":  # q, k, v (P, h, K, dh)
        q, k, v = args[:3]
        mask = kwargs.get("kv_mask", args[3] if len(args) > 3 else None)
        flops = 4.0 * q.shape[1] * q.shape[-1] * q.shape[2] * _keys(mask, k.shape[0], k.shape[2])
        return flops, 2 * q.nbytes + k.nbytes + v.nbytes + _mask_bytes(mask)
    if entry in ("fused_cross_attention_merged", "fused_cross_attention"):
        qk0, qk1, v0, v1 = args[:4]
        rest = list(args[5:] if entry.endswith("merged") else args[4:])
        mask0 = kwargs.get("mask0", rest[0] if len(rest) > 0 else None)
        mask1 = kwargs.get("mask1", rest[1] if len(rest) > 1 else None)
        if entry.endswith("merged"):
            width, k0, k1 = qk0.shape[-1], qk0.shape[1], qk1.shape[1]
        else:
            width, k0, k1 = qk0.shape[1] * qk0.shape[-1], qk0.shape[2], qk1.shape[2]
        P = qk0.shape[0]
        flops = 4.0 * width * (k0 * _keys(mask1, P, k1) + k1 * _keys(mask0, P, k0))
        nbytes = 2 * (qk0.nbytes + qk1.nbytes) + v0.nbytes + v1.nbytes + _mask_bytes(mask0, mask1)
        return flops, nbytes
    raise ValueError(f"unknown attention entry {entry!r}")
