"""AnySplat-class feed-forward gaussian predictor.

Port of gtsfm_tpu/frontend/anysplat.py, the reference's re-design of the
AnySplat contract (one forward pass over an image set -> cameras and a 3D
gaussian field) over the VGGT backbone (frontend/vggt.py): the aggregator,
camera head and depth head of VGGT, and a gaussian head of the DPT family
whose last conv gives 14 channels per pixel (3 tanh-bounded offsets in
units of depth, 3 log-scale residuals on the pixel footprint, 4 rotation
logits, 1 opacity logit, 3 color logits). Per-pixel gaussians: the mean the
unprojected depth plus the offset, the scale the footprint times the
residual, each frame's most confident pixels up to an even share of
``max_gaussians``.

``from_vggt`` shares the backbone's modules and adds a fresh gaussian head
(``gaussian_head.*``) drawn from a torch generator seeded with ``seed +
1``, as the reference draws its own from ``PRNGKey(seed + 1)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gtsfm_tpu_torch.frontend.vggt import DPTHead, VGGTModel, VGGTOptions, init_weights, pose_encoding_to_extri_intri
from gtsfm_tpu_torch.splat.gs_data import GSData
from gtsfm_tpu_torch.utils.numerics import precise

GAUSSIAN_CHANNELS = 14


class AnySplatOptions(NamedTuple):
    max_gaussians: int = 100_000
    conf_threshold: float = 0.3  # on the [0, 1]-shifted depth confidence
    offset_bound: float = 0.05  # xyz offset bound, in units of depth


def init_gaussian_head(o: VGGTOptions, seed: int) -> DPTHead:
    """The depth head's structure with a 14-channel last conv, at the
    reference's init scales."""
    head = DPTHead(o, o.dpt_features, o.dpt_out_channels, GAUSSIAN_CHANNELS)
    init_weights(head, o.init_values, seed)
    return head


def _gaussian_field(net, head: DPTHead, images: torch.Tensor) -> tuple:
    """images (S, 3, H, W) -> (extrinsic, intrinsic, depth (S, H', W'),
    confidence in [0, 1], per-pixel raw gaussian parameters (S, H', W',
    14)), one aggregator pass for every head."""
    S, _, H, W = images.shape
    outputs, ps = net.aggregator(images, keep=net.heads_layers())
    extri, intri = pose_encoding_to_extri_intri(net.camera_head(outputs[-1]), (H, W))
    depth, conf = net.depth_head(outputs, ps, (H, W), activation="exp")
    raw = head(outputs, ps, (H, W), activation="raw")
    return extri, intri, depth[..., 0], 1.0 - 1.0 / torch.clamp(conf, min=1.0), raw


class AnySplatModel:
    """run(images (S, H, W, 3) in [0, 1]) -> {extrinsic (S, 3, 4)
    world->cam, intrinsic (S, 3, 3), depth, depth_conf in [0, 1],
    gaussians: GSData}."""

    def __init__(self, vggt: VGGTModel, splat_options: AnySplatOptions = AnySplatOptions(), seed: int = 0,
                 gaussian_head: Optional[DPTHead] = None):
        self.vggt = vggt
        self.options = vggt.options
        self.splat_options = splat_options
        if gaussian_head is None:
            gaussian_head = init_gaussian_head(vggt.options, seed + 1)
        self.gaussian_head = gaussian_head.to(vggt.device).eval().requires_grad_(False)

    @classmethod
    def from_vggt(cls, vggt: VGGTModel, splat_options: AnySplatOptions = AnySplatOptions(),
                  seed: int = 0) -> "AnySplatModel":
        """Share the VGGT backbone; the gaussian head is initialized fresh."""
        return cls(vggt, splat_options, seed)

    def run(self, images) -> dict:
        x = torch.as_tensor(images, dtype=torch.float32, device=self.vggt.device).permute(0, 3, 1, 2)
        with torch.no_grad(), precise():
            extri, intri, depth, conf01, raw = _gaussian_field(self.vggt.net, self.gaussian_head, x)
        gs = self._assemble_gaussians(*(a.cpu().numpy() for a in (extri, intri, depth, conf01, raw)))
        return {"extrinsic": extri, "intrinsic": intri, "depth": depth, "depth_conf": conf01,
                "gaussians": gs.map(lambda a: a.to(self.vggt.device))}

    def _assemble_gaussians(self, extri, intri, depth, conf01, raw) -> GSData:
        """Host numpy, as the reference: per frame the backprojected pixels
        plus their bounded offsets, the most confident ``max_gaussians // S``
        kept (those below ``conf_threshold`` dropped unless the frame's best
        is below it too)."""
        so = self.splat_options
        S, H, W = depth.shape
        budget = max(1, so.max_gaussians // S)
        means, scales, quats, opac, cols = [], [], [], [], []
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        for s in range(S):
            K = intri[s]
            fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
            d = np.clip(depth[s], 1e-2, 1e3)  # an untrained head's exp reaches e^{+-30}
            xc = (xs - cx) / max(fx, 1e-6) * d
            yc = (ys - cy) / max(fy, 1e-6) * d
            off = np.tanh(raw[s, ..., 0:3]) * so.offset_bound * d[..., None]
            p_cam = np.stack([xc, yc, d], axis=-1) + off
            R, t = extri[s, :, :3], extri[s, :, 3]
            p_world = (p_cam - t) @ R  # R^T (p - t)
            score = conf01[s].reshape(-1)
            keep = np.argsort(-score)[:budget]
            keep = keep[score[keep] >= min(so.conf_threshold, float(score[keep[0]]))]
            if keep.size == 0:
                continue
            iy, ix = keep // W, keep % W
            footprint = d[iy, ix] / max(fx, 1e-6)  # 1 px at the depth
            means.append(p_world[iy, ix])
            log_fp = np.log(np.maximum(footprint[:, None], 1e-6))
            scales.append(np.clip(log_fp + np.clip(raw[s, iy, ix, 3:6], -4.0, 4.0), -12.0, 8.0))
            q = raw[s, iy, ix, 6:10] + np.array([1.0, 0, 0, 0])  # identity-centered logits
            quats.append(q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-6))
            opac.append(raw[s, iy, ix, 10])
            cols.append(raw[s, iy, ix, 11:14])
        if not means:
            return GSData.from_points(np.zeros((1, 3), np.float32))
        fields = [np.concatenate(a).astype(np.float32) for a in (means, scales, quats, opac, cols)]
        n = len(fields[0])
        return GSData(means=torch.as_tensor(fields[0]), log_scales=torch.as_tensor(fields[1]),
                      quats=torch.as_tensor(fields[2]), opacity_logit=torch.as_tensor(fields[3]),
                      colors=torch.as_tensor(fields[4]), alive=torch.ones(n, dtype=torch.float32))


def gaussian_means_as_tracks(data, gs: GSData, max_points: int = 20_000) -> tuple:
    """The most opaque gaussians' means as colored scene points for the
    export: (points (M, 3) float32, colors uint8 (M, 3))."""
    op = (torch.sigmoid(gs.opacity_logit) * gs.alive).cpu().numpy()
    idx = np.argsort(-op)[: min(max_points, op.size)]
    pts = gs.means.cpu().numpy()[idx]
    cols = torch.sigmoid(gs.colors).cpu().numpy()[idx]
    return pts.astype(np.float32), (np.clip(cols, 0, 1) * 255).astype(np.uint8)
