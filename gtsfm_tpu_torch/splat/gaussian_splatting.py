"""3D Gaussian splatting trainer (splatfacto-style).

Port of gtsfm_tpu/splat/gaussian_splatting.py: SfM-point initialization, an
L1 + SSIM loss, Adam over (means, log_scales, quats, opacity_logit, colors)
with one learning rate each, and densify/cull every ``densify_every`` steps
on the host by rewriting the padded gaussian slots (the ``alive`` mask), so
every shape stays fixed. Each step renders one camera through
``render_tiled``, whose compositing is the CUDA kernel on the card.

``torch.optim.Adam`` makes optax's update, m̂ / (√v̂ + ε) with optax's
defaults (β = 0.9, 0.999, ε = 1e-8); the moments and step counts are
re-created after each densify, as the reference's ``tx.init``. The camera
sequence and the densify jitter come from the same numpy generators as in
the reference. Convolutions run with TF32 off (``numerics.precise``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.splat.gs_data import GSData
from gtsfm_tpu_torch.splat.rendering import render, render_tiled
from gtsfm_tpu_torch.utils.numerics import precise, resolve_device

PARAMS = ("means", "log_scales", "quats", "opacity_logit", "colors")


class GSTrainOptions(NamedTuple):
    iterations: int = 1000
    lr_means: float = 1.6e-3
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 5e-2
    lr_colors: float = 2.5e-2
    ssim_lambda: float = 0.2
    densify_every: int = 300
    cull_opacity: float = 0.05
    densify_grad_threshold: float = 5e-4
    max_gaussians: int = 50_000
    chunk: int = 256
    # tile-binned rasterizer (the gsplat algorithm); the brute path is kept
    # for tiny scenes and exact references
    use_tiled: bool = True
    per_tile_cap: int = 512


def _ssim(a: torch.Tensor, b: torch.Tensor, window: int = 7) -> torch.Tensor:
    """Mean SSIM over (H, W, 3) images (uniform window, zero padding)."""
    k = torch.full((1, 1, window, window), 1.0 / (window * window), dtype=a.dtype, device=a.device)

    def box(img):  # (H, W, 3) -> (H, W, 3), channels filtered independently
        return F.conv2d(img.permute(2, 0, 1)[:, None], k, padding=window // 2)[:, 0].permute(1, 2, 0)

    mu_a = box(a)
    mu_b = box(b)
    var_a = box(a * a) - mu_a**2
    var_b = box(b * b) - mu_b**2
    cov = box(a * b) - mu_a * mu_b
    c1, c2 = 0.01**2, 0.03**2
    ssim = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return torch.mean(ssim)


class GaussianSplatting:
    """train(data, images) -> (GSData, metrics). images: (N, H, W, 3) or
    (N, H, W) float [0, 1] numpy, aligned with data's camera indexing."""

    def __init__(self, options: GSTrainOptions = GSTrainOptions(), device: str = "cuda"):
        """Raises when ``device`` is the default ``"cuda"`` and there is no
        CUDA device; pass ``device="cpu"`` for a CPU run."""
        self.options = options
        self.device = resolve_device(device)

    def _adam(self, params: dict) -> torch.optim.Adam:
        o = self.options
        lrs = {"means": o.lr_means, "log_scales": o.lr_scales, "quats": o.lr_quats,
               "opacity_logit": o.lr_opacity, "colors": o.lr_colors}
        return torch.optim.Adam([{"params": [params[k]], "lr": lrs[k]} for k in PARAMS],
                                betas=(0.9, 0.999), eps=1e-8)

    def train(self, data: SfmData, images: np.ndarray, seed: int = 0, gs_init: GSData | None = None):
        """gs_init: an optional GSData to start from instead of the
        sparse-point init."""
        opts = self.options
        dev = self.device
        imgs = np.asarray(images, np.float32)
        if imgs.ndim == 3:
            imgs = np.repeat(imgs[..., None], 3, axis=-1)
        _n, H, W, _ = imgs.shape
        cam_ids = np.nonzero(data.pose_mask.cpu().numpy())[0]

        if gs_init is not None:
            gs = gs_init.map(lambda a: a.to(dev))
        else:
            pts = data.points.cpu().numpy()[data.track_mask.cpu().numpy()]
            G = min(opts.max_gaussians, max(len(pts) * 4, 256))
            gs = GSData.from_points(pts, max_gaussians=G, device=dev)
        G = gs.max_gaussians

        Ks = data.cal.K().to(dev)
        poses = data.poses.map(lambda a: a.to(dev))
        targets = torch.as_tensor(imgs, device=dev)
        params = {k: getattr(gs, k).detach().clone().requires_grad_(True) for k in PARAMS}
        alive = gs.alive
        adam = self._adam(params)

        rng = np.random.default_rng(seed)
        losses = []
        grad_accum = torch.zeros(G, dtype=torch.float64, device=dev)
        with precise():
            for it in range(opts.iterations):
                ci = int(rng.choice(cam_ids))
                target = targets[ci]
                g = GSData(alive=alive, **params)
                if opts.use_tiled:
                    img, _ = render_tiled(g, poses[ci], Ks[ci], H, W, per_tile_cap=opts.per_tile_cap)
                else:
                    img, _ = render(g, poses[ci], Ks[ci], H, W, chunk=opts.chunk)
                l1 = torch.mean(torch.abs(img - target))
                loss = (1 - opts.ssim_lambda) * l1 + opts.ssim_lambda * (1 - _ssim(img, target))
                adam.zero_grad(set_to_none=True)
                loss.backward()
                grad_accum += torch.linalg.vector_norm(params["means"].grad, dim=-1)
                adam.step()
                losses.append(l1.detach())

                if (it + 1) % opts.densify_every == 0 and it + 1 < opts.iterations:
                    params, alive = self._densify_cull(params, alive,
                                                       (grad_accum / opts.densify_every).cpu().numpy())
                    grad_accum.zero_()
                    adam = self._adam(params)  # reset moments after the topology change

        losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
        gs_out = GSData(alive=alive, **{k: v.detach() for k, v in params.items()})
        metrics = {
            "final_l1": float(np.mean(losses[-20:])),
            "initial_l1": float(np.mean(losses[:20])),
            "num_gaussians": int(alive.sum()),
            "iterations": opts.iterations,
        }
        return gs_out, metrics

    def _densify_cull(self, params: dict, alive: torch.Tensor, grad_avg: np.ndarray):
        """Cull low-opacity slots; clone high-gradient gaussians into dead
        slots (both copies shrunk by 1.6, the clone jittered). Host numpy,
        the reference's arithmetic. Returns new leaf parameters and alive."""
        opts = self.options
        dev = self.device
        alive_np = alive.cpu().numpy().astype(bool)
        op = 1.0 / (1.0 + np.exp(-params["opacity_logit"].detach().cpu().numpy()))
        cull = alive_np & (op < opts.cull_opacity)
        alive_np[cull] = False

        dead_slots = np.nonzero(~alive_np)[0]
        cand = np.nonzero(alive_np & (grad_avg > opts.densify_grad_threshold))[0]
        cand = cand[np.argsort(-grad_avg[cand])][: len(dead_slots)]
        if len(cand):
            slots = dead_slots[: len(cand)]
            new_params = {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
            for k in new_params:
                new_params[k][slots] = new_params[k][cand]
            new_params["log_scales"][slots] -= np.log(1.6)
            new_params["log_scales"][cand] -= np.log(1.6)
            jit = np.exp(new_params["log_scales"][slots]) * np.random.default_rng(0).normal(0, 0.5, (len(slots), 3))
            new_params["means"][slots] += jit.astype(np.float32)
            alive_np[slots] = True
            params = {k: torch.as_tensor(v, device=dev).requires_grad_(True) for k, v in new_params.items()}
        return params, torch.as_tensor(alive_np, device=dev)
