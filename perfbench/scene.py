"""The benchmark's own scene: a textured piecewise-planar world seen from
cameras on a closed loop, rendered from the seed and written in Olsson's
layout (images/NNN.jpg and data.mat), which the port's OlssonLoader reads.

The world (meters, z up): a ground plane, a building (a box of four
facades and a roof) at the origin, and an enclosure of facades around it,
so that every ray hits a textured plane. Each plane carries value noise of
several octaves (seeded grids, smoothstep interpolation, amplitude falling
with frequency), so detectors find corners at every scale. The cameras
walk an ellipse around the building at eye height, each looking at the
building with a small seeded jitter; the loop closes on itself.

Everything random comes from one ``torch.Generator`` seeded with the run's
seed, drawn in a few large calls, so a seed renders the same views bit for
bit on one device. The traffic file gives the view count, the image size,
the focal length and the world's sizes.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TEXTURE_GRID = 256  # cells of one octave's periodic noise grid
JPEG_QUALITY = 95


def _look_at(center: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Camera-to-world rotations (N, 3, 3) whose columns are the camera's x
    (right), y (down) and z (forward) axes in the world."""
    fwd = target - center
    fwd = fwd / torch.linalg.vector_norm(fwd, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=center.dtype, device=center.device).expand_as(fwd)
    right = torch.linalg.cross(fwd, up, dim=-1)
    right = right / torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right, dim=-1)
    return torch.stack([right, down, fwd], dim=-1)


def _planes(world: dict, device) -> list:
    """Rectangles (origin, axis u, axis v, extent u, extent v) of the world."""
    bx, by, bz = world["building_half_extents"]
    r, hz = world["enclosure_radius"], world["enclosure_height"]
    g = world["ground_half_extent"]
    planes = [((-g, -g, 0.0), (1, 0, 0), (0, 1, 0), 2 * g, 2 * g)]  # ground
    planes += [((-bx, -by, 0.0), (1, 0, 0), (0, 0, 1), 2 * bx, bz),  # facades
               ((bx, -by, 0.0), (0, 1, 0), (0, 0, 1), 2 * by, bz),
               ((bx, by, 0.0), (-1, 0, 0), (0, 0, 1), 2 * bx, bz),
               ((-bx, by, 0.0), (0, -1, 0), (0, 0, 1), 2 * by, bz),
               ((-bx, -by, bz), (1, 0, 0), (0, 1, 0), 2 * bx, 2 * by)]  # roof
    sides = world["enclosure_sides"]
    for k in range(sides):  # the enclosure, a regular polygon of facades
        a0, a1 = 2 * math.pi * k / sides, 2 * math.pi * (k + 1) / sides
        p0 = (r * math.cos(a0), r * math.sin(a0), 0.0)
        d = (r * (math.cos(a1) - math.cos(a0)), r * (math.sin(a1) - math.sin(a0)), 0.0)
        length = math.hypot(d[0], d[1])
        planes.append((p0, (d[0] / length, d[1] / length, 0.0), (0, 0, 1), length, hz))
    as_t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return [(as_t(o), as_t(u), as_t(v), float(eu), float(ev)) for o, u, v, eu, ev in planes]


def _value_noise(grids: torch.Tensor, plane: torch.Tensor, s: torch.Tensor, t: torch.Tensor, freqs,
                 amps) -> torch.Tensor:
    """Sum over octaves of periodic value noise at plane coordinates (s, t)
    (meters) of each ray's plane. grids (planes, O, G, G) holds each
    octave's random cell values."""
    G = grids.shape[-1]
    out = torch.zeros_like(s)
    for o, (f, a) in enumerate(zip(freqs, amps)):
        x, y = s * f, t * f
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        fx, fy = fx * fx * (3 - 2 * fx), fy * fy * (3 - 2 * fy)
        i0 = torch.remainder(x0.to(torch.int64), G)
        j0 = torch.remainder(y0.to(torch.int64), G)
        i1, j1 = torch.remainder(i0 + 1, G), torch.remainder(j0 + 1, G)
        g = grids[:, o].reshape(-1)
        base = plane * (G * G)
        v = (g[base + j0 * G + i0] * (1 - fx) * (1 - fy) + g[base + j0 * G + i1] * fx * (1 - fy)
             + g[base + j1 * G + i0] * (1 - fx) * fy + g[base + j1 * G + i1] * fx * fy)
        out = out + a * v
    return out


def render(traffic: dict, seed: int, device) -> dict:
    """Render the traffic's views. Returns {"images": uint8 (N, H, W, 3)
    numpy, "R": camera-to-world (N, 3, 3) float64, "t": camera centers
    (N, 3) float64, "focal", "width", "height"}."""
    n, W, H = traffic["views"], traffic["width"], traffic["height"]
    focal = traffic["focal_px"]
    world = traffic["world"]
    ss = traffic["supersample"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    planes = _planes(world, device)
    n_oct = len(world["texture_octaves_per_m"])
    grids = torch.rand((len(planes), n_oct, TEXTURE_GRID, TEXTURE_GRID), generator=gen, device=device) * 2 - 1
    albedo = 0.35 + 0.3 * torch.rand((len(planes), 3), generator=gen, device=device)
    jitter = torch.randn((n, 4), generator=gen, device=device)

    loop = world["camera_loop"]
    ang = 2 * math.pi * torch.arange(n, dtype=torch.float32, device=device) / n
    center = torch.stack([loop["radius_x"] * torch.cos(ang), loop["radius_y"] * torch.sin(ang),
                          torch.full_like(ang, loop["height"])], dim=-1)
    center = center + loop["position_jitter"] * torch.cat([jitter[:, :2], torch.zeros_like(jitter[:, :1])], dim=-1)
    target = torch.tensor(loop["target"], dtype=torch.float32, device=device).expand(n, 3)
    target = target + loop["target_jitter"] * torch.cat([jitter[:, 2:], torch.zeros_like(jitter[:, :1])], dim=-1)
    R = _look_at(center, target)

    freqs = world["texture_octaves_per_m"]
    amps = [f ** -world["texture_falloff"] for f in freqs]
    norm = sum(amps)
    Hs, Ws = H * ss, W * ss
    v, u = torch.meshgrid(torch.arange(Hs, dtype=torch.float32, device=device),
                          torch.arange(Ws, dtype=torch.float32, device=device), indexing="ij")
    rays_cam = torch.stack([((u + 0.5) / ss - W / 2.0) / focal, ((v + 0.5) / ss - H / 2.0) / focal,
                            torch.ones_like(u)], dim=-1).reshape(-1, 3)
    normals = torch.stack([torch.linalg.cross(au, av, dim=-1) for _o, au, av, _eu, _ev in planes])
    images = torch.empty((n, H, W, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        d = rays_cam @ R[i].T  # world directions
        best_t = torch.full((d.shape[0],), float("inf"), device=device)
        best_p = torch.zeros((d.shape[0],), dtype=torch.int64, device=device)
        best_s, best_q = torch.zeros_like(best_t), torch.zeros_like(best_t)
        for p, (o, au, av, eu, ev) in enumerate(planes):
            denom = d @ normals[p]
            safe = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
            tt = ((o - center[i]) @ normals[p]) / safe
            hit = center[i] + tt[:, None] * d
            s = (hit - o) @ au
            q = (hit - o) @ av
            ok = (tt > 1e-3) & (tt < best_t) & (s >= 0) & (s <= eu) & (q >= 0) & (q <= ev)
            best_t = torch.where(ok, tt, best_t)
            best_p = torch.where(ok, p, best_p)
            best_s = torch.where(ok, s, best_s)
            best_q = torch.where(ok, q, best_q)
        tex = 0.5 + 0.5 * _value_noise(grids, best_p, best_s, best_q, freqs, amps) / norm * world["texture_contrast"]
        lit = tex[:, None] * albedo[best_p] * (1.0 + 0.25 * torch.abs(normals[best_p, 2:3]))
        shade = torch.where(torch.isfinite(best_t)[:, None], lit, torch.zeros_like(lit))
        img = shade.reshape(Hs, Ws, 3).permute(2, 0, 1)[None]
        img = torch.nn.functional.avg_pool2d(img, ss)[0].permute(1, 2, 0)
        images[i] = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
    return {"images": images.cpu().numpy(), "R": R.double().cpu().numpy(), "t": center.double().cpu().numpy(),
            "focal": float(focal), "width": W, "height": H}


def write_olsson(dirpath: str, scene: dict, threads: int = 4) -> None:
    """The scene as an Olsson folder: images/NNN.jpg (8-bit RGB JPEG at
    quality 95, as photo collections come) and data.mat with
    P_i = K [R_i^T | -R_i^T t_i] for the
    camera-to-world poses, K of the focal length with the principal point
    at the image center."""
    import scipy.io
    from PIL import Image

    os.makedirs(os.path.join(dirpath, "images"), exist_ok=True)
    w, h, f = scene["width"], scene["height"], scene["focal"]
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
    P = np.empty((1, len(scene["images"])), object)
    for i in range(len(scene["images"])):
        Rt = scene["R"][i].T
        P[0, i] = K @ np.concatenate([Rt, -Rt @ scene["t"][i][:, None]], axis=1)

    def save(i):
        Image.fromarray(scene["images"][i]).save(os.path.join(dirpath, "images", f"{i:03d}.jpg"), quality=JPEG_QUALITY)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(save, range(len(scene["images"]))))
    scipy.io.savemat(os.path.join(dirpath, "data.mat"), {"P": P})
