"""2D rotary position embedding (croco's RoPE2D).

Port of the RoPE part of gtsfm_tpu/frontend/mast3r.py (``_rope_cos_sin``,
``_rotate_half``, ``apply_rope2d``): a GPT-NeoX rotary embedding on each
half of the head dimension, the first half rotated by the token's y
position and the second by its x. VGGT's frame and global blocks use it
(frontend/vggt.py). The MASt3R model itself is not ported (ROADMAP queue 1
item 10).
"""

from __future__ import annotations

import torch


def _rope_cos_sin(pos: torch.Tensor, dim_half: int, base: float) -> tuple:
    """pos (N,) integer positions -> (cos, sin), each (N, dim_half), the
    frequencies repeated once."""
    freqs = 1.0 / (base ** (torch.arange(0, dim_half, 2, dtype=torch.float32, device=pos.device) / dim_half))
    ang = pos[:, None].to(torch.float32) * freqs[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope2d(tokens: torch.Tensor, positions: torch.Tensor, base: float) -> torch.Tensor:
    """tokens (..., N, D), D even, split into (y, x) halves; positions (N, 2)
    integer (y, x)."""
    dh = tokens.shape[-1] // 2
    ty, tx = tokens[..., :dh], tokens[..., dh:]
    cy, sy = _rope_cos_sin(positions[:, 0], dh, base)
    cx, sx = _rope_cos_sin(positions[:, 1], dh, base)
    ty = ty * cy + _rotate_half(ty) * sy
    tx = tx * cx + _rotate_half(tx) * sx
    return torch.cat([ty, tx], dim=-1)
