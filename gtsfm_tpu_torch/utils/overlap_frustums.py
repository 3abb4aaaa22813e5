"""In-view tests of projected points.

Port of gtsfm_tpu/utils/overlap_frustums.py, ``points_in_view`` only (the
synthetic correspondence generator's visibility mask). Host numpy, a copy.
"""

from __future__ import annotations

import numpy as np


def points_in_view(uv: np.ndarray, z: np.ndarray, wh: np.ndarray, z_min: float = 1e-6) -> np.ndarray:
    """Batched in-view mask from already-projected points.

    uv: (..., K, 2) pixel coords; z: (..., K) depths; wh: (..., 2) per-view
    (width, height). The projection itself is the caller's (batched, on the
    device)."""
    uv = np.asarray(uv)
    z = np.asarray(z)
    wh = np.asarray(wh, np.float32)
    return (
        (z > z_min)
        & (uv[..., 0] >= 0) & (uv[..., 0] < wh[..., None, 0])
        & (uv[..., 1] >= 0) & (uv[..., 1] < wh[..., None, 1])
    )
