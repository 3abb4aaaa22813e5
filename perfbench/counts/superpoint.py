"""Operations of one SuperPoint forward (the MagicLeap architecture) on an
image padded to H x W (multiples of 8), 2 per multiply-add: 3x3 convs
1-64-64 at full size, 64-64-64 at 1/2, 64-128-128 at 1/4, 128-128-128 at
1/8, then the heads at 1/8: 128-256 (3x3) and 256-65 (1x1) for the scores,
128-256 (3x3) and 256-256 (1x1) for the descriptors."""

from __future__ import annotations

LAYERS = (  # (downsampling, c_in, c_out, kernel)
    (1, 1, 64, 3), (1, 64, 64, 3), (2, 64, 64, 3), (2, 64, 64, 3), (4, 64, 128, 3), (4, 128, 128, 3),
    (8, 128, 128, 3), (8, 128, 128, 3), (8, 128, 256, 3), (8, 256, 65, 1), (8, 128, 256, 3), (8, 256, 256, 1),
)


def superpoint_flops(H: int, W: int) -> float:
    return float(sum(2.0 * (H // s) * (W // s) * cin * cout * k * k for s, cin, cout, k in LAYERS))
