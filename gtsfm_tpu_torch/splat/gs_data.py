"""3D Gaussian splat container and PLY IO.

Port of gtsfm_tpu/splat/gs_data.py: a padded set of G gaussian slots with an
``alive`` mask, as a dataclass of tensors. ``from_points`` keeps the
reference's numpy arithmetic (and its ``default_rng(0)`` subsample for the
initial scale), so its output is bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gtsfm_tpu_torch.utils.numerics import TensorStruct

_SH_C0 = 0.28209479177387814  # degree-0 spherical-harmonic constant


@dataclasses.dataclass(frozen=True)
class GSData(TensorStruct):
    """Padded gaussian set (G slots, alive mask).

    means:         f32 [G, 3]
    log_scales:    f32 [G, 3]   (exp -> per-axis std dev)
    quats:         f32 [G, 4]   (w, x, y, z; normalized on use)
    opacity_logit: f32 [G]      (sigmoid -> alpha)
    colors:        f32 [G, 3]   (RGB in [0, 1] via sigmoid at render)
    alive:         bool [G], or float 0/1
    """

    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logit: torch.Tensor
    colors: torch.Tensor
    alive: torch.Tensor

    @property
    def max_gaussians(self) -> int:
        return self.means.shape[0]

    def num_alive(self) -> int:
        return int(self.alive.sum())

    @classmethod
    def from_points(
        cls,
        points: np.ndarray,
        colors: np.ndarray | None = None,
        max_gaussians: int | None = None,
        init_opacity: float = 0.5,
        device=None,
    ) -> "GSData":
        """Init from a sparse SfM point cloud (splatfacto-style): isotropic
        scale from the median nearest-neighbor distance of up to 2000
        points, the given colors (logit space), opacity ``init_opacity``."""
        points = np.asarray(points)
        n = len(points)
        G = max_gaussians or max(n, 1)
        if G < n:
            raise ValueError(f"{n} points do not fit {G} gaussian slots")
        pts = np.zeros((G, 3), np.float32)
        pts[:n] = points
        if n > 1:
            sub = points[np.random.default_rng(0).permutation(n)[: min(n, 2000)]]
            d2 = ((sub[:, None] - sub[None, :]) ** 2).sum(-1)
            np.fill_diagonal(d2, np.inf)
            nn = np.sqrt(np.min(d2, axis=1))
            scale = float(np.clip(np.median(nn), 1e-4, 1e3))
        else:
            scale = 0.1
        log_scales = np.full((G, 3), np.log(scale), np.float32)
        quats = np.zeros((G, 4), np.float32)
        quats[:, 0] = 1.0
        op = np.full(G, np.log(init_opacity / (1 - init_opacity)), np.float32)
        cols = np.full((G, 3), 0.0, np.float32)
        if colors is not None:
            c = np.asarray(colors, np.float32)
            if c.ndim == 1:
                c = np.stack([c] * 3, -1)
            c = np.clip(c, 1e-3, 1 - 1e-3)
            cols[:n] = np.log(c / (1 - c))
        alive = np.zeros(G, bool)
        alive[:n] = True
        return cls(*(torch.as_tensor(a, device=device) for a in (pts, log_scales, quats, op, cols, alive)))


def export_ply(gs: GSData, path: str) -> None:
    """Write the alive splats as a 3DGS-convention PLY (x y z, f_dc, opacity,
    scale, rot), readable by common splat viewers."""
    alive = gs.alive.detach().cpu().numpy().astype(bool)
    means, scales, quats, ops, cols = (
        getattr(gs, k).detach().cpu().numpy()[alive]
        for k in ("means", "log_scales", "quats", "opacity_logit", "colors"))
    props = (
        ["x", "y", "z"]
        + [f"f_dc_{i}" for i in range(3)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(means)}\n"
            + "".join(f"property float {p}\n" for p in props)
            + "end_header\n"
        )
        f.write(header.encode())
        # SH DC from the sigmoid color: c = 0.5 + C0 * f_dc
        rgb = 1.0 / (1.0 + np.exp(-cols))
        f_dc = (rgb - 0.5) / _SH_C0
        data = np.concatenate([means, f_dc, ops[:, None], scales, quats], axis=1).astype("<f4")
        f.write(data.tobytes())


def load_ply(path: str, device=None) -> GSData:
    """Read back a PLY written by export_ply (every splat alive)."""
    with open(path, "rb") as f:
        n = 0
        props = []
        while True:
            line = f.readline()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"property"):
                props.append(line.split()[-1].decode())
            elif line.startswith(b"end_header"):
                break
        data = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4").reshape(n, len(props))
    rgb = np.clip(0.5 + _SH_C0 * data[:, 3:6], 1e-3, 1 - 1e-3)
    fields = (data[:, 0:3], data[:, 7:10], data[:, 10:14], data[:, 6], np.log(rgb / (1 - rgb)), np.ones(n, bool))
    return GSData(*(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in fields))
