"""PatchmatchNet learned multi-view stereo (Wang et al., CVPR 2021).

Port of gtsfm_tpu/densify/patchmatchnet.py. ``PatchmatchNet`` is an
``nn.Module`` whose state_dict keys are those of the official
``model_000007.ckpt`` (feature, patchmatch_1..3, upsample_net; BatchNorm
in eval mode, a ``module.`` prefix stripped by ``load_torch_weights``):

- FeatureNet: a 10-conv FPN -> stage 1 (1/2, 16 channels), stage 2 (1/4,
  32) and stage 3 (1/8, 64);
- three PatchMatch stages, coarse to fine: inverse-depth random
  initialisation (stage 3) or local perturbation, learned adaptive
  propagation, learned adaptive evaluation (group-wise correlation of
  homography-warped source features, pixel-wise view weights, adaptive
  spatial aggregation), soft-argmin depth;
- the image-guided refinement to full resolution and the photometric
  confidence.

Everything runs in float32 under ``precise()``, one reference view per
forward. The reference's sampling rules are kept, not ``grid_sample``'s:
the warp zeroes a whole sample outside [0, W-1] x [0, H-1]
(``_bilinear_zeros``), the adaptive offsets sample at x W / (W - 1) - 0.5
with a border clamp (``_offset_sample``). Mirrored as the reference runs
them: BatchNorm folded into a scale and shift, the refinement's transposed
convolution on the checkpoint's kernel as ``lax.conv_transpose`` takes it
(unflipped, so torch's flip is undone), and one stage-3 random draw reused
for every reference view of a run.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.densify.mvs import DenseMVS, MVSOptions, _views_to_run, _world_to_cam
from gtsfm_tpu_torch.utils.numerics import precise, resolve_device

# stage configs: index 0 -> patchmatch_1 (finest), 2 -> patchmatch_3
INTERVAL_SCALE = (0.005, 0.0125, 0.025)
PROP_RANGE = (6, 4, 2)
PM_ITERATIONS = (1, 2, 2)
NUM_SAMPLE = (8, 8, 16)
PROP_NEIGHBORS = (0, 8, 16)
EVAL_NEIGHBORS = (9, 9, 9)
NUM_FEATURES = (8, 16, 32, 64)
GROUPS = (4, 8, 8)
RANDOM_INIT_SAMPLES = 48
BN_EPS = 1e-5


# ---------------------------------------------------------------------------
# layers: the official modules, evaluated as the reference evaluates them
# ---------------------------------------------------------------------------


def _bn_affine(bn: nn.Module) -> tuple:
    """Eval-mode BatchNorm as (scale, shift), folded as the reference's
    converter folds it."""
    scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return scale, bn.bias - bn.running_mean * scale


class ConvBnReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1, pad: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=pad, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (N, C, H, W)
        scale, shift = _bn_affine(self.bn)
        return torch.relu(self.conv(x) * scale[:, None, None] + shift[:, None, None])


class ConvBnReLU3D(nn.Module):
    """A 1x1x1 Conv3d and BatchNorm3d: applied as a dense layer over the
    last (channel) axis."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, 1, bias=False)
        self.bn = nn.BatchNorm3d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (..., C)
        scale, shift = _bn_affine(self.bn)
        return torch.relu((x @ self.conv.weight[:, :, 0, 0, 0].T) * scale + shift)


def _dense(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    return x @ conv.weight[:, :, 0, 0, 0].T + conv.bias


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(3, 8)
        self.conv1 = ConvBnReLU(8, 8)
        self.conv2 = ConvBnReLU(8, 16, 5, 2, 2)
        self.conv3 = ConvBnReLU(16, 16)
        self.conv4 = ConvBnReLU(16, 16)
        self.conv5 = ConvBnReLU(16, 32, 5, 2, 2)
        self.conv6 = ConvBnReLU(32, 32)
        self.conv7 = ConvBnReLU(32, 32)
        self.conv8 = ConvBnReLU(32, 64, 5, 2, 2)
        self.conv9 = ConvBnReLU(64, 64)
        self.conv10 = ConvBnReLU(64, 64)
        self.output1 = nn.Conv2d(64, 64, 1, bias=False)
        self.inner1 = nn.Conv2d(32, 64, 1, bias=True)
        self.inner2 = nn.Conv2d(16, 64, 1, bias=True)
        self.output2 = nn.Conv2d(64, 32, 1, bias=False)
        self.output3 = nn.Conv2d(64, 16, 1, bias=False)

    def forward(self, img: torch.Tensor) -> dict:
        """(V, 3, H, W) -> {1: (V, 16, H/2, W/2), 2: (V, 32, H/4, W/4),
        3: (V, 64, H/8, W/8)}."""
        c1 = self.conv1(self.conv0(img))
        c4 = self.conv4(self.conv3(self.conv2(c1)))
        c7 = self.conv7(self.conv6(self.conv5(c4)))
        c10 = self.conv10(self.conv9(self.conv8(c7)))
        f3 = self.output1(c10)
        intra = _upsample_linear2x(c10) + self.inner1(c7)
        f2 = self.output2(intra)
        intra = _upsample_linear2x(intra) + self.inner2(c4)
        f1 = self.output3(intra)
        return {1: f1, 2: f2, 3: f3}


class _MLPNet(nn.Module):
    """FeatureWeightNet / SimilarityNet / PixelwiseNet: two ConvBnReLU3D
    and a final 1x1x1 Conv3d to one channel, over (..., G)."""

    def __init__(self, G: int, final: str):
        super().__init__()
        self.conv0 = ConvBnReLU3D(G, 16)
        self.conv1 = ConvBnReLU3D(16, 8)
        self.final = final
        setattr(self, final, nn.Conv3d(8, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(getattr(self, self.final), self.conv1(self.conv0(x)))[..., 0]


class Evaluation(nn.Module):
    def __init__(self, G: int, stage: int):
        super().__init__()
        if stage == 3:
            self.pixel_wise_net = _MLPNet(G, "conv2")
        self.similarity_net = _MLPNet(G, "similarity")


class PatchMatch(nn.Module):
    def __init__(self, stage_idx: int):
        super().__init__()
        C = NUM_FEATURES[stage_idx + 1]
        dil = PROP_RANGE[stage_idx]
        self.stage_idx = stage_idx
        if _has_propagation(stage_idx):
            self.propa_conv = nn.Conv2d(C, 2 * PROP_NEIGHBORS[stage_idx], 3, padding=dil, dilation=dil)
        self.eval_conv = nn.Conv2d(C, 2 * EVAL_NEIGHBORS[stage_idx], 3, padding=dil, dilation=dil)
        self.feature_weight_net = _MLPNet(GROUPS[stage_idx], "similarity")
        self.evaluation = Evaluation(GROUPS[stage_idx], stage_idx + 1)


def _has_propagation(stage_idx: int) -> bool:
    """The last iteration of stage 1 has no propagation, so with one
    iteration there its conv does not exist."""
    return PROP_NEIGHBORS[stage_idx] > 0 and not (stage_idx == 0 and PM_ITERATIONS[stage_idx] == 1)


class Refinement(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(3, 8)
        self.conv1 = ConvBnReLU(1, 8)
        self.conv2 = ConvBnReLU(8, 8)
        self.deconv = nn.ConvTranspose2d(8, 8, 3, stride=2, padding=1, output_padding=1, bias=False)
        self.bn = nn.BatchNorm2d(8)
        self.conv3 = ConvBnReLU(16, 8)
        self.res = nn.Conv2d(8, 1, 3, padding=1, bias=False)

    def forward(self, img: torch.Tensor, depth: torch.Tensor, dmin, dmax) -> torch.Tensor:
        """img (3, H, W), depth (H/2, W/2) -> refined depth (H, W)."""
        dn = ((depth - dmin) / (dmax - dmin))[None, None]
        conv0 = self.conv0(img[None])
        c = self.conv2(self.conv1(dn))
        # lax.conv_transpose on the checkpoint's (I, O, kh, kw) kernel as
        # the reference feeds it: torch's transposed conv flips its kernel,
        # so the flip is undone here
        dec = F.conv_transpose2d(c, self.deconv.weight.flip(-1, -2), stride=2, padding=1, output_padding=1)
        scale, shift = _bn_affine(self.bn)
        dec = torch.relu(dec * scale[:, None, None] + shift[:, None, None])
        res = self.res(self.conv3(torch.cat([dec, conv0], dim=1)))
        out = _nearest2x(dn[0, 0]) + res[0, 0]
        return out * (dmax - dmin) + dmin


# ---------------------------------------------------------------------------
# sampling (channel-last images (H, W, C), pixel coordinates)
# ---------------------------------------------------------------------------


def _upsample_linear2x(x: torch.Tensor) -> torch.Tensor:
    """jax.image.resize(..., "linear") by 2 of (N, C, H, W): half-pixel
    centers, the edge taps renormalised, which is align_corners=False."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def _nearest2x(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., 2H, 2W), each value repeated."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _bilinear_border(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W, C) at pixel positions (...) clamped to the image;
    -> (..., C)."""
    H, W, C = img.shape
    xs = torch.clamp(xs, 0.0, W - 1.0)
    ys = torch.clamp(ys, 0.0, H - 1.0)
    x0f = torch.clamp(torch.floor(xs), 0, W - 2)
    y0f = torch.clamp(torch.floor(ys), 0, H - 2)
    fx = (xs - x0f)[..., None]
    fy = (ys - y0f)[..., None]
    i00 = y0f.long() * W + x0f.long()
    flat = img.reshape(H * W, C)
    v00, v01, v10, v11 = flat[i00], flat[i00 + 1], flat[i00 + W], flat[i00 + W + 1]
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


def _bilinear_zeros(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """The warp's sampling: a sample outside [0, W-1] x [0, H-1] is zero as
    a whole (not grid_sample's per-corner zero padding)."""
    H, W = img.shape[0], img.shape[1]
    inb = (xs >= 0) & (xs <= W - 1) & (ys >= 0) & (ys <= H - 1)
    return _bilinear_border(img, xs, ys) * inb[..., None]


def _offset_sample(img: torch.Tensor, grid_x: torch.Tensor, grid_y: torch.Tensor) -> torch.Tensor:
    """The official offset grids: normalised by (size - 1) but sampled with
    align_corners=False, so at x W / (W - 1) - 0.5, border clamped."""
    H, W = img.shape[0], img.shape[1]
    return _bilinear_border(img, grid_x * W / (W - 1) - 0.5, grid_y * H / (H - 1) - 0.5)


# ---------------------------------------------------------------------------
# the PatchMatch pieces (channel-last, one reference view)
# ---------------------------------------------------------------------------


def _grid(H: int, W: int, dev) -> tuple:
    return torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")


def _warp_src(src_feat, src_proj, ref_proj, depth_sample):
    """src_feat (H, W, C), depth_sample (D, H, W) -> the source features
    warped into the reference view at each hypothesis, (D, H, W, C)."""
    H, W = depth_sample.shape[1], depth_sample.shape[2]
    proj = src_proj @ torch.linalg.inv(ref_proj)
    rot, trans = proj[:3, :3], proj[:3, 3]
    y, x = _grid(H, W, depth_sample.device)
    xyz = torch.stack([x, y, torch.ones_like(x)])  # (3, H, W)
    rot_xyz = torch.einsum("ij,jhw->ihw", rot, xyz)
    p = rot_xyz[:, None] * depth_sample[None] + trans[:, None, None, None]
    neg = p[2] <= 1e-3
    px = torch.where(neg, float(W), p[0])
    py = torch.where(neg, float(H), p[1])
    pz = torch.where(neg, 1.0, p[2])
    return _bilinear_zeros(src_feat, px / pz, py / pz)


def _offset_grids(offset, base_offsets, H, W):
    """offset (H, W, 2 Nn), the static (dy, dx) base offsets -> absolute
    pixel grids x, y (Nn, H, W)."""
    y, x = _grid(H, W, offset.device)
    gx = torch.stack([x + ox + offset[:, :, 2 * i] for i, (_oy, ox) in enumerate(base_offsets)])
    gy = torch.stack([y + oy + offset[:, :, 2 * i + 1] for i, (oy, _ox) in enumerate(base_offsets)])
    return gx, gy


def _base_offsets_prop(neighbors: int, dilation: int) -> list:
    if neighbors == 4:
        return [[-dilation, 0], [0, -dilation], [0, dilation], [dilation, 0]]
    if neighbors in (8, 16):
        out = [[-dilation, -dilation], [-dilation, 0], [-dilation, dilation], [0, -dilation], [0, dilation],
               [dilation, -dilation], [dilation, 0], [dilation, dilation]]
        if neighbors == 16:
            out = out + [[2 * oy, 2 * ox] for oy, ox in out]
        return out
    raise NotImplementedError(neighbors)


def _base_offsets_eval(neighbors: int, dilation: int) -> list:
    d = dilation - 1
    out = [[-d, -d], [-d, 0], [-d, d], [0, -d], [0, 0], [0, d], [d, -d], [d, 0], [d, d]]
    if neighbors == 17:
        out = out + [[2 * oy, 2 * ox] for oy, ox in out if (oy, ox) != (0, 0)]
    return out


def _depth_init_random(u, dmin, dmax):
    """u (48, H, W) uniforms in [0, 1) -> one depth per inverse-depth
    interval."""
    inv_min, inv_max = 1.0 / dmin, 1.0 / dmax
    D = RANDOM_INIT_SAMPLES
    u = u + torch.arange(D, dtype=torch.float32, device=u.device)[:, None, None]
    return 1.0 / (inv_max + u / D * (inv_min - inv_max))


def _depth_perturb(depth, dmin, dmax, num_sample, interval_scale):
    """Local inverse-depth perturbation around depth (1, H, W)."""
    inv_min, inv_max = 1.0 / dmin, 1.0 / dmax
    off = torch.arange(-(num_sample // 2), num_sample // 2, dtype=torch.float32, device=depth.device)
    inv_int = (inv_min - inv_max) * interval_scale
    inv = 1.0 / depth + inv_int * off[:, None, None]
    inv = torch.minimum(torch.maximum(inv, inv_max), inv_min)  # jnp.clip
    return 1.0 / inv


def _sample_each(img, gx, gy):
    """_offset_sample at each of the Nn grids -> (Nn, H, W, C)."""
    return torch.stack([_offset_sample(img, ax, ay) for ax, ay in zip(gx, gy)])


def _propagate(depth_sample, gx, gy):
    """The middle hypothesis gathered at the learned neighbour positions,
    appended and sorted over the hypotheses."""
    D = depth_sample.shape[0]
    mid = depth_sample[D // 2][:, :, None]
    nb = _sample_each(mid, gx, gy)[..., 0]
    return torch.sort(torch.cat([depth_sample, nb], dim=0), dim=0).values


def _depth_weight(depth_sample, dmin, dmax, gx, gy, interval_scale):
    """The adaptive aggregation's depth-difference weights (D, Nn, H, W)."""
    inv_min, inv_max = 1.0 / dmin, 1.0 / dmax
    x = (1.0 / depth_sample - inv_max) / (inv_min - inv_max)  # (D, H, W)
    samp = _sample_each(x.permute(1, 2, 0), gx, gy).permute(3, 0, 1, 2)  # (D, Nn, H, W)
    d = torch.clamp(torch.abs(samp - x[:, None]) / interval_scale, 0.0, 4.0)
    return torch.sigmoid((-d + 2.0) * 2.0)


def _feature_weight(net: _MLPNet, ref_feat, gx, gy, G):
    """FeatureWeightNet: the group-wise similarity of each sampled
    neighbour's features with the centre's -> sigmoid weights (Nn, H, W)."""
    H, W, C = ref_feat.shape
    samp = _sample_each(ref_feat, gx, gy)
    s = samp.reshape(samp.shape[0], H, W, G, C // G)
    r = ref_feat.reshape(H, W, G, C // G)
    sim = torch.mean(s * r[None], dim=-1)  # (Nn, H, W, G)
    return torch.sigmoid(net(sim))


def _similarity_net(net: _MLPNet, sim, gx, gy, weight):
    """SimilarityNet over (D, H, W, G), then the adaptive spatial
    aggregation with weight (D, Nn, H, W) -> (D, H, W)."""
    c = net(sim)
    samp = _sample_each(c.permute(1, 2, 0), gx, gy).permute(3, 0, 1, 2)
    return torch.sum(samp * weight, dim=1)


def _evaluate(pm: PatchMatch, ref_feat, src_feats, ref_proj, src_projs, depth_sample, gx, gy, weight,
              view_weights):
    """Group-wise correlation of the warped features, the view-weighted
    mean, SimilarityNet and a softmax over the hypotheses."""
    G = GROUPS[pm.stage_idx]
    H, W, C = ref_feat.shape
    D = depth_sample.shape[0]
    r = ref_feat.reshape(H, W, G, C // G)
    sim_sum = torch.zeros((D, H, W, G), device=ref_feat.device)
    w_sum = torch.zeros((1, H, W, 1), device=ref_feat.device)
    new_view_weights = []
    for v in range(src_feats.shape[0]):
        warped = _warp_src(src_feats[v], src_projs[v], ref_proj, depth_sample)
        sim = torch.mean(warped.reshape(D, H, W, G, C // G) * r[None], dim=-1)
        if view_weights is None:
            vw = torch.sigmoid(pm.evaluation.pixel_wise_net(sim)).max(dim=0).values  # PixelwiseNet
            new_view_weights.append(vw)
        else:
            vw = view_weights[v]
        sim_sum = sim_sum + sim * vw[None, :, :, None]
        w_sum = w_sum + vw[None, :, :, None]
    score = _similarity_net(pm.evaluation.similarity_net, sim_sum / w_sum, gx, gy, weight)
    score = torch.softmax(score, dim=0)
    return score, (torch.stack(new_view_weights) if view_weights is None else view_weights)


def _regress_depth(depth_sample, score, stage_idx: int, last_iter: bool):
    D = depth_sample.shape[0]
    if stage_idx == 0 and last_iter:  # stage 1's last: inverse-depth index regression
        idx = torch.sum(torch.arange(D, dtype=torch.float32, device=score.device)[:, None, None] * score, dim=0)
        inv_min = 1.0 / depth_sample[-1]
        inv_max = 1.0 / depth_sample[0]
        return 1.0 / (inv_max + idx / (D - 1) * (inv_min - inv_max))
    return torch.sum(depth_sample * score, dim=0)


def _patchmatch_stage(pm: PatchMatch, ref_feat, src_feats, ref_proj, src_projs, dmin, dmax, depth, view_weights,
                      init_uniform):
    """One PatchMatch module on channel-last features (H, W, C)."""
    s = pm.stage_idx
    H, W = ref_feat.shape[0], ref_feat.shape[1]
    iters, dilation, interval = PM_ITERATIONS[s], PROP_RANGE[s], INTERVAL_SCALE[s]
    feat_nchw = ref_feat.permute(2, 0, 1)[None]
    pgx = pgy = None
    if _has_propagation(s):
        off = pm.propa_conv(feat_nchw)[0].permute(1, 2, 0)
        pgx, pgy = _offset_grids(off, _base_offsets_prop(PROP_NEIGHBORS[s], dilation), H, W)
    off = pm.eval_conv(feat_nchw)[0].permute(1, 2, 0)
    egx, egy = _offset_grids(off, _base_offsets_eval(EVAL_NEIGHBORS[s], dilation), H, W)
    feat_w = _feature_weight(pm.feature_weight_net, ref_feat, egx, egy, GROUPS[s])  # (Nn, H, W)

    score = None
    for it in range(1, iters + 1):
        if it == 1 and s == 2:
            depth_sample = _depth_init_random(init_uniform, dmin, dmax)
        else:
            depth_sample = _depth_perturb(depth, dmin, dmax, NUM_SAMPLE[s], interval)
            if pgx is not None and not (s == 0 and it == iters):
                depth_sample = _propagate(depth_sample, pgx, pgy)
        w = _depth_weight(depth_sample, dmin, dmax, egx, egy, interval) * feat_w[None]
        w = w / torch.sum(w, dim=1, keepdim=True)
        score, view_weights = _evaluate(pm, ref_feat, src_feats, ref_proj, src_projs, depth_sample, egx, egy, w,
                                        view_weights)
        depth = _regress_depth(depth_sample, score, s, it == iters)[None]
    return depth, score, view_weights


class PatchmatchNetOutputs(NamedTuple):
    depth: torch.Tensor  # (H, W) refined
    confidence: torch.Tensor  # (H, W) photometric confidence


class PatchmatchNet(nn.Module):
    """The official model's modules and keys; ``forward`` runs one
    reference view (view 0) against its sources."""

    def __init__(self):
        super().__init__()
        self.feature = FeatureNet()
        for s in (1, 2, 3):
            setattr(self, f"patchmatch_{s}", PatchMatch(s - 1))
        self.upsample_net = Refinement()

    def forward(self, imgs: torch.Tensor, projs_1: torch.Tensor, projs_2: torch.Tensor, projs_3: torch.Tensor,
                dmin, dmax, init_uniform: Optional[torch.Tensor] = None) -> PatchmatchNetOutputs:
        """imgs (V, 3, H, W) with H and W multiples of 8 (view 0 the
        reference); projs_k (V, 4, 4): K at stage k's resolution times
        world-to-camera; dmin, dmax: the depth range; init_uniform (48,
        H/8, W/8) uniforms for stage 3's random initialisation, drawn
        from torch's default generator on the images' device when None."""
        with torch.no_grad(), precise():
            V, _, H, W = imgs.shape
            dev = imgs.device
            dmin = torch.as_tensor(dmin, dtype=torch.float32, device=dev)
            dmax = torch.as_tensor(dmax, dtype=torch.float32, device=dev)
            if init_uniform is None:
                init_uniform = torch.rand((RANDOM_INIT_SAMPLES, H // 8, W // 8), device=dev)
            feats = {k: f.permute(0, 2, 3, 1) for k, f in self.feature(imgs).items()}  # channel-last
            depth = view_weights = score1 = None
            for stage_idx in (2, 1, 0):
                projs = (projs_1, projs_2, projs_3)[stage_idx]
                f = feats[stage_idx + 1]
                depth, score, view_weights = _patchmatch_stage(
                    getattr(self, f"patchmatch_{stage_idx + 1}"), f[0], f[1:], projs[0], projs[1:], dmin, dmax, depth,
                    view_weights, init_uniform)
                if stage_idx == 0:
                    score1 = score
                else:
                    depth = _nearest2x(depth)
                    view_weights = _nearest2x(view_weights)
            refined = self.upsample_net(imgs[0], depth[0], dmin, dmax)

            # photometric confidence: the sum of the 4 probabilities around
            # the expected index's integer part
            D = score1.shape[0]
            z = torch.zeros_like(score1[:1])
            padded = torch.cat([z, score1, z, z], dim=0)
            sum4 = padded[:-3] + padded[1:-2] + padded[2:-1] + padded[3:]
            ar = torch.arange(D, dtype=torch.float32, device=dev)[:, None, None]
            idx = torch.clamp(torch.sum(ar * score1, dim=0), 0, D - 1).to(torch.int64)
            conf = torch.gather(sum4, 0, idx[None])[0]
            return PatchmatchNetOutputs(depth=refined, confidence=_nearest2x(conf))


def _strip_prefix(sd: dict) -> dict:
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def load_torch_weights(path: str) -> dict:
    """The official model_000007.ckpt (``{"model": state_dict}``, or a raw
    state_dict, with or without ``module.`` prefixes) -> its state_dict in
    the ``PatchmatchNet`` keys."""
    from gtsfm_tpu_torch.utils.torch_io import load_torch_checkpoint

    ckpt = load_torch_checkpoint(path)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return _strip_prefix(sd)


def build_net(state_dict: dict, device="cuda") -> PatchmatchNet:
    """A ``PatchmatchNet`` in eval mode on ``device`` (the CUDA card unless
    given ``device="cpu"``) holding state_dict (tensors or numpy arrays;
    every key of the official layout must be present)."""
    device = resolve_device(device)
    net = PatchmatchNet()
    net.load_state_dict({k: torch.as_tensor(v) for k, v in _strip_prefix(state_dict).items()})
    return net.eval().to(device)


class PatchmatchNetMVS(DenseMVS):
    """Dense reconstruction with the learned PatchmatchNet depth.

    ``mvs.PlaneSweepMVS``'s contract, source selection and fusion; each
    view's depth comes from the network on ``device`` (the CUDA card by
    default). Needs weights: a state_dict in the official layout
    (``load_torch_weights(model_000007.ckpt)``). The stage-3 random draw
    is made once per run from a ``torch.Generator`` seeded with ``seed``
    and reused for every reference view, as the reference reuses its key.
    """

    def __init__(self, options: MVSOptions = None, state_dict: dict = None, seed: int = 0, device="cuda"):
        self.options = options or MVSOptions()
        self.seed = seed
        self.device = resolve_device(device)
        if state_dict is None:
            raise RuntimeError("PatchmatchNetMVS requires weights: pass state_dict=load_torch_weights(path) for "
                               "the official model_000007.ckpt (a learned MVS without trained weights gives garbage "
                               "depth)")
        self.net = build_net(state_dict, self.device)

    def compute_depths(self, data: SfmData, images: np.ndarray, sec: dict = None) -> tuple:
        """-> ({view: (H, W) depth}, {view: (H, W) confidence}), numpy, zero
        outside the top-left multiple-of-8 crop the net sees; ``sec``
        receives source_selection_sec and depth_sec."""
        sec = {} if sec is None else sec
        opts = self.options
        h, src_sel, dranges = self._select(data, sec)
        t0 = time.perf_counter()
        cTw_R, cTw_t = _world_to_cam(h)
        H0, W0 = images.shape[1], images.shape[2]
        H8, W8 = (H0 // 8) * 8, (W0 // 8) * 8
        gen = torch.Generator().manual_seed(self.seed)
        u = torch.rand((RANDOM_INIT_SAMPLES, H8 // 8, W8 // 8), generator=gen).to(self.device)

        def projs_for(view_ids, stage):
            scale = 1.0 / (2**stage)
            mats = []
            for v in view_ids:
                K = h["K"][v].copy()
                K[:2, :] *= scale
                E = np.eye(4, dtype=np.float32)
                E[:3, :3] = cTw_R[v]
                E[:3, 3] = cTw_t[v]
                P = E.copy()
                P[:3, :4] = K @ E[:3, :4]
                mats.append(P)
            return torch.as_tensor(np.stack(mats), dtype=torch.float32, device=self.device)

        depths, confs = {}, {}
        for i, srcs in _views_to_run(h["pose_mask"], src_sel, dranges, opts.num_source_views):
            ids = [i] + srcs
            gray = np.asarray(images[np.asarray(ids)][:, :H8, :W8], np.float32)
            rgb = torch.as_tensor(gray, device=self.device)[:, None].expand(-1, 3, -1, -1)
            out = self.net(rgb, projs_for(ids, 1), projs_for(ids, 2), projs_for(ids, 3), np.float32(dranges[i, 0]),
                           np.float32(dranges[i, 1]), init_uniform=u)
            d = np.zeros((H0, W0), np.float32)
            c = np.zeros((H0, W0), np.float32)
            d[:H8, :W8] = out.depth.cpu().numpy()
            c[:H8, :W8] = out.confidence.cpu().numpy()
            depths[i] = d
            confs[i] = c
        sec["depth_sec"] = time.perf_counter() - t0
        return depths, confs
