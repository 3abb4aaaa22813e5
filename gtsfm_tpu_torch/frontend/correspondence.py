"""Direct image-correspondence generators and keypoint aggregation.

Port of gtsfm_tpu/frontend/correspondence.py. A direct generator gives
per-pair correspondences, ``generate(images, pairs) -> {(i1, i2): (uv1
(M, 2), uv2 (M, 2))}`` in pixels: ``ColmapCorrespondenceGenerator`` replays
an existing COLMAP model's tracks, ``DenseCorrespondenceGenerator`` runs a
dense matcher (LoFTR, the compact dense matcher) on each pair on the
scene's device. A keypoint aggregator merges the per-pair keypoints into
global per-image lists and per-pair index triples for the two-view batch:
``KeypointAggregatorUnique`` keeps every keypoint, ``KeypointAggregatorDedup``
merges those within ``merge_radius_px`` of one already kept (the first
kept wins, so the result depends on the pairs' order, as in the
reference). The aggregators and the COLMAP replay are host numpy, copies
of the reference's loops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AggregatorOptions(NamedTuple):
    merge_radius_px: float = 3.0  # keypoint_aggregator_dedup.py default
    max_keypoints_per_image: int = 4096


class KeypointAggregatorUnique:
    """Every per-pair keypoint becomes its own global keypoint (no dedup)."""

    def __init__(self, options: AggregatorOptions = AggregatorOptions()):
        self.options = options

    def aggregate(self, num_images: int, pair_corrs: dict):
        """pair_corrs: {(i1, i2): (uv1 (M, 2), uv2 (M, 2))} ->
        (keypoints_xy (N, K, 2), kp_mask (N, K),
         per-pair (corr_i1, corr_i2, corr_mask) dict)."""
        K = self.options.max_keypoints_per_image
        counts = np.zeros(num_images, np.int64)
        kp = np.zeros((num_images, K, 2), np.float32)
        out = {}
        for (i1, i2), (uv1, uv2) in pair_corrs.items():
            m = len(uv1)
            idx1 = np.arange(m) + counts[i1]
            idx2 = np.arange(m) + counts[i2]
            keep = (idx1 < K) & (idx2 < K)
            kp[i1, idx1[keep]] = uv1[keep]
            kp[i2, idx2[keep]] = uv2[keep]
            counts[i1] += m
            counts[i2] += m
            out[(i1, i2)] = (idx1[keep].astype(np.int32), idx2[keep].astype(np.int32), keep[keep])
        mask = np.arange(K)[None, :] < np.minimum(counts, K)[:, None]
        return kp, mask, out


class KeypointAggregatorDedup:
    """Merge per-pair keypoints within merge_radius_px into shared global
    keypoints — required so DSF can chain correspondences across pairs."""

    def __init__(self, options: AggregatorOptions = AggregatorOptions()):
        self.options = options

    def aggregate(self, num_images: int, pair_corrs: dict):
        K = self.options.max_keypoints_per_image
        r = self.options.merge_radius_px
        # per-image grid hash for near-duplicate lookup
        grids: list = [dict() for _ in range(num_images)]
        pts: list = [[] for _ in range(num_images)]

        def get_or_add(img, uv):
            cell = (int(uv[0] // r), int(uv[1] // r))
            g = grids[img]
            for dc in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1), (1, -1), (-1, 1)):
                key = (cell[0] + dc[0], cell[1] + dc[1])
                for idx in g.get(key, ()):
                    if np.hypot(*(pts[img][idx] - uv)) <= r:
                        return idx
            idx = len(pts[img])
            if idx >= K:
                return -1
            pts[img].append(np.asarray(uv, np.float32))
            g.setdefault(cell, []).append(idx)
            return idx

        out = {}
        for (i1, i2), (uv1, uv2) in pair_corrs.items():
            a = np.array([get_or_add(i1, u) for u in uv1], np.int32)
            b = np.array([get_or_add(i2, u) for u in uv2], np.int32)
            keep = (a >= 0) & (b >= 0)
            out[(i1, i2)] = (a, b, keep)

        kp = np.zeros((num_images, K, 2), np.float32)
        mask = np.zeros((num_images, K), bool)
        for img in range(num_images):
            n = len(pts[img])
            if n:
                kp[img, :n] = np.stack(pts[img])
                mask[img, :n] = True
        return kp, mask, out


class ColmapCorrespondenceGenerator:
    """Correspondences from an existing COLMAP reconstruction's tracks:
    each track gives a correspondence to every requested pair of images
    that observe it (read through the port's io/colmap.py, text or
    binary)."""

    def __init__(self, colmap_dir: str, binary: bool = False):
        from gtsfm_tpu_torch.io import colmap as colmap_io

        self.data = colmap_io.read_scene_binary(colmap_dir) if binary else colmap_io.read_scene(colmap_dir)

    def generate(self, images, pairs: np.ndarray) -> dict:
        """-> {(i1, i2): (uv1, uv2)} for the requested pairs; ``images`` is
        not read (the direct generators' contract)."""
        mcam, mtrk, muv, mask = (x.cpu().numpy() for x in (self.data.meas_cam, self.data.meas_track,
                                                            self.data.meas_uv, self.data.meas_mask))
        by_track: dict = {}
        for mi in np.nonzero(mask)[0]:
            by_track.setdefault(int(mtrk[mi]), []).append((int(mcam[mi]), muv[mi]))
        want = {tuple(p) for p in np.asarray(pairs).tolist()}
        out: dict = {tuple(p): ([], []) for p in want}
        for obs in by_track.values():
            for a in range(len(obs)):
                for b in range(a + 1, len(obs)):
                    (ia, uva), (ib, uvb) = obs[a], obs[b]
                    key = (min(ia, ib), max(ia, ib))
                    if key in want:
                        if ia <= ib:
                            out[key][0].append(uva)
                            out[key][1].append(uvb)
                        else:
                            out[key][0].append(uvb)
                            out[key][1].append(uva)
        return {
            k: (np.asarray(v[0], np.float32).reshape(-1, 2), np.asarray(v[1], np.float32).reshape(-1, 2))
            for k, v in out.items()
        }


class DenseCorrespondenceGenerator:
    """A per-pair dense matcher (``match_images(img1, img2) -> (uv1, uv2,
    scores, mask)``, tensors) as a direct generator. Each pair's gray images
    are padded with zeros at the bottom and right to the pair's largest
    height and width, as the matcher takes equal shapes, and matched on
    ``device``; the kept correspondences come back as numpy."""

    def __init__(self, matcher=None, device="cuda"):
        if matcher is None:
            from gtsfm_tpu_torch.frontend.matchers.dense_matcher import DenseImageMatcher

            matcher = DenseImageMatcher()
        self.matcher = matcher
        self.device = device

    def generate(self, images, pairs) -> dict:
        """images: (H, W) or (H, W, 3) float arrays, one per image; pairs
        (P, 2)."""
        out = {}
        for i1, i2 in np.asarray(pairs).tolist():
            im1 = np.asarray(images[i1], np.float32)
            im2 = np.asarray(images[i2], np.float32)
            H = max(im1.shape[0], im2.shape[0])
            W = max(im1.shape[1], im2.shape[1])
            p1 = np.zeros((H, W), np.float32)
            p2 = np.zeros((H, W), np.float32)
            p1[: im1.shape[0], : im1.shape[1]] = im1 if im1.ndim == 2 else im1.mean(-1)
            p2[: im2.shape[0], : im2.shape[1]] = im2 if im2.ndim == 2 else im2.mean(-1)
            uv1, uv2, _score, mask = self.matcher.match_images(torch.as_tensor(p1, device=self.device),
                                                               torch.as_tensor(p2, device=self.device))
            m = mask.cpu().numpy()
            out[(i1, i2)] = (uv1.cpu().numpy()[m].astype(np.float32), uv2.cpu().numpy()[m].astype(np.float32))
        return out
