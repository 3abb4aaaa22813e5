"""Mutual nearest-neighbor descriptor matching with the Lowe ratio test.

Port of gtsfm_tpu/frontend/matchers/mutual_nn.py, batched over pairs: the
JAX version is vmapped over a leading pair axis, this one takes (..., K, D)
tensors directly. This is the plain PyTorch version of the fused matcher
kernel (fused_matcher.py): CPU tensors run it, and the kernel is held
against it on the card.
"""

from __future__ import annotations

import torch

NEG = -1e9


def match_descriptors(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    mask1: torch.Tensor,
    mask2: torch.Tensor,
    ratio: float = 0.8,
):
    """Mutual-NN matching of L2-normalized descriptors with the Lowe ratio
    test: the reference's ``match_descriptors(..., ratio_test=True,
    use_bf16=True)``, the only form the kernel computes.

    desc1 (..., K1, D), desc2 (..., K2, D); mask1 (..., K1), mask2 (..., K2).
    Returns (match_idx int32 (..., K1) — index into desc2 or -1,
             match_mask bool (..., K1), best similarity f32 (..., K1)).

    The descriptors are rounded to bf16 and their products summed in
    float32, the reference's bf16 similarity with f32 accumulation. TF32
    must be off (``numerics.precise``) for that sum to be float32 on the
    card.
    """
    a = desc1.to(torch.bfloat16).to(torch.float32)
    b = desc2.to(torch.bfloat16).to(torch.float32)
    sim = torch.matmul(a, b.transpose(-1, -2))
    neg = torch.full((), NEG, dtype=sim.dtype, device=sim.device)
    sim = torch.where(mask1[..., :, None] & mask2[..., None, :], sim, neg)

    nn12 = torch.argmax(sim, dim=-1)  # first index of the max
    nn21 = torch.argmax(sim, dim=-2)
    K1 = desc1.shape[-2]
    mutual = torch.arange(K1, device=sim.device) == torch.gather(nn21, -1, nn12)

    best = torch.amax(sim, dim=-1)
    second = torch.amax(sim.scatter(-1, nn12[..., None], NEG), dim=-1)
    d2_best = torch.clamp(2.0 - 2.0 * best, min=0.0)
    d2_second = torch.clamp(2.0 - 2.0 * second, min=1e-12)
    ok = mask1 & mutual & (best > -1e8) & (d2_best < (ratio**2) * d2_second)
    match_idx = torch.where(ok, nn12, -1).to(torch.int32)
    return match_idx, ok, best
