"""Operations of one LightGlue forward (the official architecture) on a
pair with n0 and n1 valid keypoints, 2 per multiply-add, for width d,
input width d_in, head width dh and L layers:

- input projection 2 (n0 + n1) d_in d; positional encoding 2 (n0 + n1) dh;
- a self block on n rows: Wqkv 6 n d^2, attention 4 n^2 d, out_proj
  2 n d^2, ffn (2d -> 2d -> d) 12 n d^2;
- a cross block: to_qk, to_v and to_out 6 (n0 + n1) d^2, attention both
  ways 8 n0 n1 d, ffn 12 (n0 + n1) d^2;
- the last layer's assignment: final_proj 2 (n0 + n1) d^2, similarity
  2 n0 n1 d, matchability 2 (n0 + n1) d.

Only valid keypoints count: what the inputs need, not what padding adds."""

from __future__ import annotations


def lightglue_flops(n0, n1, d: int = 256, d_in: int = 256, dh: int = 64, layers: int = 9):
    """Works on numbers or tensors of per-pair counts (summed by the caller)."""
    n = n0 + n1
    per_layer = 38.0 * n * d * d + 4.0 * d * (n0 * n0 + n1 * n1 + 2.0 * n0 * n1)
    return 2.0 * n * d_in * d + 2.0 * n * dh + layers * per_layer + 2.0 * n * d * d + 2.0 * n0 * n1 * d + 2.0 * n * d
