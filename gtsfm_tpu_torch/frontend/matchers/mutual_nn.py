"""Mutual nearest-neighbor descriptor matching with the Lowe ratio test.

Port of gtsfm_tpu/frontend/matchers/mutual_nn.py, batched over pairs: the
JAX version is vmapped over a leading pair axis, this one takes (..., K, D)
tensors directly. Its default form (ratio test, bf16 similarity) is the
plain PyTorch version of the fused matcher kernel (fused_matcher.py): CPU
tensors run it, and the kernel is held against it on the card. Also
``matches_to_pairs``, the padded (i1, i2) index pairs of a match table.
"""

from __future__ import annotations

import torch

from gtsfm_tpu_torch.utils.numerics import precise

NEG = -1e9
TILE = 128  # desc1 rows per tile: the CUDA kernel's block height


def match_descriptors(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    mask1: torch.Tensor,
    mask2: torch.Tensor,
    ratio: float = 0.8,
    ratio_test: bool = True,
    use_bf16: bool = True,
):
    """Mutual-NN matching of L2-normalized descriptors with an optional
    Lowe ratio test on L2 distances (d^2 = 2 - 2 s).

    desc1 (..., K1, D), desc2 (..., K2, D); mask1 (..., K1), mask2 (..., K2).
    Returns (match_idx int32 (..., K1) — index into desc2 or -1,
             match_mask bool (..., K1), best similarity f32 (..., K1)).

    With ``use_bf16`` the descriptors are rounded to bf16 before their
    products are summed in float32, the reference's bf16 similarity with
    f32 accumulation; without it the similarity is float32.

    It is ``finish_tiles`` of ``tile_outputs``, the kernel's two steps, so
    that a split of desc1's rows (``tile_outputs`` on each part, the parts
    concatenated) gives the same matches bit for bit. The default,
    ``ratio_test=True, use_bf16=True``, is what the fused matcher kernel
    computes.
    """
    return finish_tiles(*tile_outputs(desc1, desc2, mask1, mask2, use_bf16=use_bf16), mask1, ratio,
                        ratio_test=ratio_test)


def matches_to_pairs(match_idx: torch.Tensor, match_mask: torch.Tensor, max_matches: int):
    """Per-keypoint match indices (..., K1) -> padded (i1_kp, i2_kp) index
    pairs (..., max_matches, 2) int32 and their mask: the valid matches
    first, in keypoint order, then padding (zeros, masked)."""
    order = torch.argsort((~match_mask).to(torch.int8), dim=-1, stable=True)
    sel = order[..., :max_matches]
    pairs = torch.stack([sel, torch.gather(match_idx.to(torch.int64), -1, sel)], dim=-1)
    mask = torch.gather(match_mask, -1, sel)
    pairs = torch.where(mask[..., None], pairs, torch.zeros_like(pairs))
    return pairs.to(torch.int32), mask


def tile_outputs(desc1: torch.Tensor, desc2: torch.Tensor, mask1: torch.Tensor, mask2: torch.Tensor,
                row0: int = 0, use_bf16: bool = True) -> tuple:
    """The tile kernel's outputs, plain: desc1 (..., K1, D) holds the rows
    row0 .. row0 + K1 of a larger desc1 (row0 a multiple of TILE), desc2
    (..., K2, D) all of desc2. Returns (best, second, bidx (..., K1): each
    row's best similarity, its second best (over every column but the
    first-index argmax one) and that argmax; colbest, colidx (...,
    ceil(K1 / TILE), K2): each column's best over each TILE-row tile and
    the lowest (global) row that holds it). The similarity is taken one
    TILE-row tile at a time, so a row's values do not depend on how the
    rows were split. Rows past K1 count as masked. The descriptors are
    rounded to bf16 first unless ``use_bf16`` is False; the products are
    summed in float32 (TF32 off, ``numerics.precise``)."""
    if row0 % TILE:
        raise ValueError(f"row0={row0} is not a multiple of {TILE}")
    if use_bf16:
        desc1, desc2 = desc1.to(torch.bfloat16), desc2.to(torch.bfloat16)
    a, bt = desc1.to(torch.float32), desc2.to(torch.float32).transpose(-1, -2)
    K1, K2 = desc1.shape[-2], desc2.shape[-2]
    with precise():
        sim = torch.cat([torch.matmul(a[..., r : r + TILE, :], bt) for r in range(0, K1, TILE)], dim=-2)
    neg = torch.full((), NEG, dtype=sim.dtype, device=sim.device)
    sim = torch.where(mask1[..., :, None] & mask2[..., None, :], sim, neg)

    bidx = torch.argmax(sim, dim=-1)  # first index of the max
    best = torch.amax(sim, dim=-1)
    second = torch.amax(sim.scatter(-1, bidx[..., None], NEG), dim=-1)
    n_rt = -(-K1 // TILE)
    pad = sim.new_full(sim.shape[:-2] + (n_rt * TILE - K1, K2), NEG)
    tiles = torch.cat([sim, pad], dim=-2).reshape(sim.shape[:-2] + (n_rt, TILE, K2))
    colbest = torch.amax(tiles, dim=-2)
    rows = row0 + TILE * torch.arange(n_rt, device=sim.device)[:, None]
    colidx = torch.argmax(tiles, dim=-2) + rows  # the lowest row of the max
    return best, second, bidx.to(torch.int32), colbest, colidx.to(torch.int32)


def finish_tiles(best, second, bidx, colbest, colidx, mask1, ratio, ratio_test: bool = True):
    """Cross-tile column argmax (first tile on ties, i.e. the lowest row),
    mutual check and (unless ``ratio_test`` is False) ratio test on
    ``tile_outputs``' outputs for all of desc1's rows — the part the
    reference leaves to XLA after its kernel.
    The plain version of the finish kernel in csrc/fused_matcher.cu, which
    must agree with it exactly."""
    K1 = best.shape[-1]
    blk = torch.argmax(colbest, dim=-2, keepdim=True)  # (..., 1, K2)
    nn21 = torch.gather(colidx, -2, blk).squeeze(-2).to(torch.int64)  # (..., K2)
    nn12 = bidx.to(torch.int64)
    mutual = torch.gather(nn21, -1, nn12) == torch.arange(K1, device=best.device)
    ok = mask1 & mutual & (best > -1e8)
    if ratio_test:
        d2_best = torch.clamp(2.0 - 2.0 * best, min=0.0)
        d2_second = torch.clamp(2.0 - 2.0 * second, min=1e-12)
        ok = ok & (d2_best < (ratio**2) * d2_second)
    return torch.where(ok, nn12, -1).to(torch.int32), ok, best
