"""2D track formation via union-find (disjoint-set forest) over pairwise
matches.

The port's copy of gtsfm_tpu/tracks/dsf.py, unchanged in arithmetic.

Parity: GTSfM's gtsfm/data_association/cpp_dsf_tracks_estimator.py:74
(gtsam.gtsfm.tracksFromPairwiseMatches — C++ DSF) and the pure-Python
fallback dsf_tracks_estimator.py. Track formation is inherently sequential
graph contraction, so it stays on host: a vectorized numpy union-find here,
with an optional C++ extension (native/dsf.cpp) for large scenes —
mirroring the reference's C++ choice.

Output is the padded [T, K] track layout the triangulation stage consumes,
plus the flat CSR measurement layout SfmData uses.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None


def _native_lib():
    """Lazy-load the optional C++ DSF extension."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from gtsfm_tpu_torch.native.build import ensure_built

    so = ensure_built("libdsf.so")
    if so is not None:
        lib = ctypes.CDLL(so)
        lib.dsf_union_find.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
    else:
        _LIB = False
    return _LIB


def _union_find_numpy(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Union elements a[i] ~ b[i]; return root label per element (0..n-1)."""
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for x, y in zip(a, b):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[rx] = ry
    # final flatten
    for i in range(n):
        parent[i] = find(i)
    return parent


def _union_find(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    lib = _native_lib()
    if lib:
        out = np.empty(n, dtype=np.int64)
        lib.dsf_union_find(
            a.astype(np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b.astype(np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(a)),
            ctypes.c_int64(n),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out
    return _union_find_numpy(np.asarray(a, np.int64), np.asarray(b, np.int64), n)


def tracks_from_matches(
    pair_indices: np.ndarray,  # (P, 2) image index pairs (i1, i2)
    corr_i1: np.ndarray,  # (P, M) keypoint index in image i1
    corr_i2: np.ndarray,  # (P, M) keypoint index in image i2
    corr_mask: np.ndarray,  # (P, M)
    keypoints_xy: np.ndarray,  # (N, K, 2) per-image keypoint coordinates
    min_track_len: int = 2,
    max_track_len: Optional[int] = None,
):
    """Build 2D tracks by union-find over (image, keypoint) nodes.

    Returns (track_cam int32 (T, Kt), track_kp int32 (T, Kt),
             track_uv f32 (T, Kt, 2), track_mask bool (T, Kt)) where
    Kt = max observed track length (or max_track_len cap).

    Tracks with repeated images (merge collisions) are dropped, matching
    the reference DSF behavior of rejecting inconsistent tracks.
    """
    N, K, _ = keypoints_xy.shape
    pm = np.asarray(corr_mask, bool)
    p_idx, m_idx = np.nonzero(pm)
    i1 = np.asarray(pair_indices)[p_idx, 0]
    i2 = np.asarray(pair_indices)[p_idx, 1]
    k1 = np.asarray(corr_i1)[p_idx, m_idx]
    k2 = np.asarray(corr_i2)[p_idx, m_idx]

    a = i1.astype(np.int64) * K + k1
    b = i2.astype(np.int64) * K + k2

    # only nodes that appear in some match matter
    nodes, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    na = inv[: len(a)]
    nb = inv[len(a) :]
    roots = _union_find(na, nb, len(nodes))

    # group nodes by root
    order = np.argsort(roots, kind="stable")
    sorted_roots = roots[order]
    sorted_nodes = nodes[order]
    boundaries = np.nonzero(np.diff(sorted_roots))[0] + 1
    groups = np.split(sorted_nodes, boundaries)

    img_of = (sorted_nodes // K).astype(np.int32)
    kp_of = (sorted_nodes % K).astype(np.int32)
    group_slices = np.split(np.arange(len(sorted_nodes)), boundaries)

    tracks = []
    for sl in group_slices:
        if len(sl) < min_track_len:
            continue
        imgs = img_of[sl]
        if len(np.unique(imgs)) != len(imgs):
            continue  # inconsistent track (same image twice)
        if max_track_len and len(sl) > max_track_len:
            # TRUNCATE long tracks to an evenly-spread subset (dropping them
            # wholesale starves wide-visibility scenes of structure)
            keep = np.linspace(0, len(sl) - 1, max_track_len).round().astype(int)
            sl = sl[np.unique(keep)]
            imgs = img_of[sl]
        tracks.append((imgs, kp_of[sl]))

    T = len(tracks)
    Kt = max((len(t[0]) for t in tracks), default=2)
    track_cam = np.zeros((max(T, 1), Kt), np.int32)
    track_kp = np.zeros((max(T, 1), Kt), np.int32)
    track_mask = np.zeros((max(T, 1), Kt), bool)
    for j, (imgs, kps) in enumerate(tracks):
        L = len(imgs)
        track_cam[j, :L] = imgs
        track_kp[j, :L] = kps
        track_mask[j, :L] = True

    kxy = np.asarray(keypoints_xy)
    track_uv = kxy[track_cam, track_kp]  # (T, Kt, 2)
    track_uv = np.where(track_mask[..., None], track_uv, 0.0).astype(np.float32)
    return track_cam, track_kp, track_uv, track_mask
