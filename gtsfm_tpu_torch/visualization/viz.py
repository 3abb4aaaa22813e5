"""Scene figures: a 3D plot of the reconstruction, match and track overlays.

Port of gtsfm_tpu/visualization/viz.py. The reference draws with
matplotlib, which the card's machine does not have; the port draws the
same figures with PIL and numpy: an orthographic view of the scene from
matplotlib's default 3D angle (azimuth -60 deg, elevation 30 deg) with the
box scaled to a cube, the matches as lines across two images side by side,
and the patches around a track's measurements.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.utils.convert import to_numpy

_AZIM = np.deg2rad(-60.0)
_ELEV = np.deg2rad(30.0)
_CYCLE = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189), (140, 86, 75),
          (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207))


def _view(P: np.ndarray) -> np.ndarray:
    """Screen (x right, y up) of points (N, 3) in the unit cube's frame."""
    ca, sa, ce, se = np.cos(_AZIM), np.sin(_AZIM), np.cos(_ELEV), np.sin(_ELEV)
    x, y, z = P[:, 0], P[:, 1], P[:, 2]
    return np.stack([-sa * x + ca * y, -se * (ca * x + sa * y) + ce * z], axis=1)


def scatter_3d(path: str, points: list, segments: list = (), size: int = 880, legend: list = ()) -> None:
    """Write an orthographic 3D view to ``path`` (PNG): ``points`` a list of
    ((N, 3) array, RGB) drawn in order, ``segments`` a list of ((M, 2, 3)
    array, RGB) line segments, ``legend`` a list of (label, RGB). Each axis
    is scaled to the unit cube over everything drawn."""
    parts = [p for p, _ in points if len(p)] + [s.reshape(-1, 3) for s, _ in segments if len(s)]
    allp = np.concatenate(parts) if parts else np.zeros((1, 3))
    lo, hi = allp.min(axis=0), allp.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)

    def to_px(P):
        s = _view((P - lo) / span - 0.5)
        return np.stack([size / 2 + s[:, 0] * scale, size / 2 - s[:, 1] * scale], axis=1)

    corners = np.array([[i, j, k] for i in (-0.5, 0.5) for j in (-0.5, 0.5) for k in (-0.5, 0.5)])
    scale = 0.9 * size / np.ptp(_view(corners), axis=0).max()
    img = Image.new("RGB", (size, size), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    cube = to_px(corners * span + lo + span / 2)
    for a in range(8):
        for b in range(a + 1, 8):
            if np.abs(corners[a] - corners[b]).sum() == 1.0:  # a cube edge
                draw.line([tuple(cube[a]), tuple(cube[b])], fill=(220, 220, 220))
    for P, color in points:
        for u, v in to_px(np.asarray(P, np.float64)) if len(P) else ():
            draw.rectangle([u - 1, v - 1, u + 1, v + 1], fill=color)
    for S, color in segments:
        for a, b in zip(to_px(S[:, 0]), to_px(S[:, 1])) if len(S) else ():
            draw.line([tuple(a), tuple(b)], fill=color, width=2)
    for k, (label, color) in enumerate(legend):
        draw.rectangle([12, 12 + 18 * k, 24, 24 + 18 * k], fill=color)
        draw.text((30, 12 + 18 * k), label, fill=(0, 0, 0))
    img.save(path)


def plot_scene_3d(data: SfmData, output_path: str, max_points: int = 20000) -> None:
    """The tracks (gray) and each registered camera's axes (red, green,
    blue, a tenth of the camera centers' extent long) -> PNG."""
    pts = to_numpy(data.points)[to_numpy(data.track_mask)]
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).permutation(len(pts))[:max_points]]
    pm = to_numpy(data.pose_mask)
    centers = to_numpy(data.poses.t)[pm]
    Rs = to_numpy(data.poses.R)[pm]
    segments = []
    if len(centers):
        scale = 0.1 * (np.ptp(centers, axis=0).max() + 1e-6)
        for k, color in enumerate(((255, 0, 0), (0, 128, 0), (0, 0, 255))):
            axis = Rs[:, :, k]
            segments.append((np.stack([centers, centers + scale * axis], axis=1), color))
    scatter_3d(output_path, [(pts, (153, 153, 153))], segments)


def plot_matches(img1: np.ndarray, img2: np.ndarray, kp1: np.ndarray, kp2: np.ndarray, output_path: str,
                 max_draw: int = 150) -> None:
    """Two grayscale images side by side with lines between matched
    keypoints kp1 / kp2 (M, 2); at most ``max_draw`` of them, drawn at
    random with seed 0."""
    img1, img2 = np.asarray(img1, np.float32), np.asarray(img2, np.float32)
    h = max(img1.shape[0], img2.shape[0])
    canvas = np.zeros((h, img1.shape[1] + img2.shape[1]), np.float32)
    canvas[: img1.shape[0], : img1.shape[1]] = img1
    canvas[: img2.shape[0], img1.shape[1]:] = img2
    lo, hi = float(canvas.min()), float(canvas.max())
    gray = ((canvas - lo) / (hi - lo if hi > lo else 1.0) * 255).astype(np.uint8)
    img = Image.fromarray(gray).convert("RGB")
    draw = ImageDraw.Draw(img)
    off = img1.shape[1]
    sel = np.arange(len(kp1))
    if len(sel) > max_draw:
        sel = np.random.default_rng(0).permutation(len(sel))[:max_draw]
    for n, i in enumerate(sel):
        draw.line([(float(kp1[i, 0]), float(kp1[i, 1])), (float(kp2[i, 0]) + off, float(kp2[i, 1]))],
                  fill=_CYCLE[n % len(_CYCLE)], width=1)
    img.save(output_path)


def plot_track_reprojections(data: SfmData, images: np.ndarray, track_indices, output_path: str) -> None:
    """For each chosen track, the 32x32 patches around up to six of its
    measurements (drawn 4x), the measurement marked with a red x and its
    reprojection error above."""
    zoom, cell, title = 4, 32, 14
    err = to_numpy(data.reprojection_errors())
    mcam, mtrk, muv, mask = (to_numpy(a) for a in (data.meas_cam, data.meas_track, data.meas_uv, data.meas_mask))
    rows = len(track_indices)
    cols = min(max(int((mask & np.isin(mtrk, track_indices)).sum()) // max(rows, 1), 1), 6)
    img = Image.new("RGB", (cols * cell * zoom, rows * (cell * zoom + title)), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    for r, t in enumerate(track_indices):
        for c, m in enumerate(np.nonzero(mask & (mtrk == t))[0][:cols]):
            u, v = muv[m]
            y0, x0 = int(max(0, v - 16)), int(max(0, u - 16))
            patch = np.asarray(images[mcam[m]], np.float32)[y0: y0 + cell, x0: x0 + cell]
            tile = Image.fromarray((np.clip(patch, 0, 1) * 255).astype(np.uint8)).convert("RGB")
            tile = tile.resize((patch.shape[1] * zoom, patch.shape[0] * zoom), Image.NEAREST)
            px, py = c * cell * zoom, r * (cell * zoom + title) + title
            img.paste(tile, (px, py))
            draw.text((px + 2, py - title), f"e={err[m]:.2f}px", fill=(0, 0, 0))
            cx, cy = px + (u - x0) * zoom, py + (v - y0) * zoom
            draw.line([(cx - 4, cy - 4), (cx + 4, cy + 4)], fill=(255, 0, 0), width=2)
            draw.line([(cx - 4, cy + 4), (cx + 4, cy - 4)], fill=(255, 0, 0), width=2)
    img.save(output_path)
