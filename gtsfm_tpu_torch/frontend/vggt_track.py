"""VGGT's track head (the public layout) in PyTorch.

Port of gtsfm_tpu/frontend/vggt_track.py, the CoTracker / VGGSfM-style
iterative tracker of the public VGGT-1B:

  feature_extractor  the DPT head in feature-only mode: the fused pyramid,
                     output_conv1, a bilinear resize to (H, W) / 2
  tracker            per-query features sampled from frame 0, a 7-level
                     correlation pyramid (2x2 average pools; dot-product
                     correlation maps sampled bilinearly on a 9x9 patch),
                     4 refinement iterations of an EfficientUpdateFormer
                     (time attention over frames, space attention through
                     64 learned virtual tracks) predicting coordinate and
                     feature updates; sigmoid visibility and confidence

State-dict keys are the public model's (``track_head.feature_extractor.*``,
``track_head.tracker.{fmap_norm, corr_mlp, updateformer, ffeat_norm,
ffeat_updater, vis_predictor, conf_predictor}.*``, the updateformer's
``virual_tracks`` with the public typo, ``nn.MultiheadAttention``'s
``in_proj_*`` and ``out_proj``). The sampling follows the reference's
formulas (grid_sample with aligned corners, per-tap zero or border
padding), not ``grid_sample`` itself. Float32, channels last as the
reference; the tracker's maps are (S, H, W, C).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.frontend.vggt import DPTHead, VGGTOptions
from gtsfm_tpu_torch.utils.numerics import attention


class TrackOptions(NamedTuple):
    latent_dim: int = 128  # track-feature channels
    stride: int = 2  # feature maps are at (H, W) / stride
    corr_levels: int = 7
    corr_radius: int = 4
    hidden_size: int = 384
    iters: int = 4
    depth: int = 6  # time blocks; space blocks interleave 1:1
    num_heads: int = 8
    num_virtual_tracks: int = 64
    max_scale: int = 518
    predict_conf: bool = True
    # the feature extractor's DPT width: the public head's 128 (the
    # reference's init uses the VGGT options' dpt_features)
    dpt_features: int = 128


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding: str) -> torch.Tensor:
    """img (H, W, C) at pixel coordinates x, y (one shape) -> (..., C):
    grid_sample with aligned corners, each tap zero ("zeros") or clamped
    ("border") outside the map."""
    H, W, C = img.shape
    flat = img.reshape(H * W, C)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]

    def tap(xi, yi):
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        v = flat[(yc * W + xc).reshape(-1)].reshape(xi.shape + (C,))
        if padding == "zeros":
            ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            v = v * ok[..., None].to(v.dtype)
        return v

    return (tap(x0, y0) * (1 - wx) * (1 - wy) + tap(x0 + 1, y0) * wx * (1 - wy)
            + tap(x0, y0 + 1) * (1 - wx) * wy + tap(x0 + 1, y0 + 1) * wx * wy)


def _sample_maps(maps: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One scalar map per row: maps (B, H, W), x and y (B, P) -> (B, P),
    the zero-padded ``_bilinear_sample`` of each row on its own map."""
    B, H, W = maps.shape
    flat = maps.reshape(B, H * W)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def tap(xi, yi):
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        return torch.gather(flat, 1, yc * W + xc) * ok.to(flat.dtype)

    return (tap(x0, y0) * (1 - wx) * (1 - wy) + tap(x0 + 1, y0) * wx * (1 - wy)
            + tap(x0, y0 + 1) * (1 - wx) * wy + tap(x0 + 1, y0 + 1) * wx * wy)


def sample_features4d(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(H, W, C) map, (N, 2) xy -> (N, C), border-padded bilinear."""
    return _bilinear_sample(fmap, coords[:, 0], coords[:, 1], "border")


def get_2d_embedding(xy: torch.Tensor, C: int) -> torch.Tensor:
    """CoTracker's 2D sin-cos embedding: for x and y each, C channels
    interleaving sin and cos of coord * k * (1000 / C), k = 0, 2, 4, ...
    -> (..., 2C)."""
    div = torch.arange(0, C, 2, dtype=torch.float32, device=xy.device) * (1000.0 / C)

    def emb(v):
        ang = v * div
        return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(ang.shape[:-1] + (C,))

    return torch.cat([emb(xy[..., 0:1]), emb(xy[..., 1:2])], dim=-1)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """(S, H, W, C) -> (S, H // 2, W // 2, C): 2x2 sums times 0.25 (odd
    sides drop their last row or column)."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    return (x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]) * 0.25


def build_fmap_pyramid(fmaps: torch.Tensor, num_levels: int) -> list:
    pyr = [fmaps]
    for _ in range(num_levels - 1):
        pyr.append(_avg_pool2(pyr[-1]))
    return pyr


def corr_sample(pyramid: list, track_feats: torch.Tensor, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Correlation features of every (frame, track) at every level:
    track_feats (S, N, C), coords (S, N, 2) in level-0 units -> (S, N,
    levels * (2r + 1)^2), per level the correlation map (feats . fmap /
    sqrt(C)) sampled on the (2r + 1)^2 patch around coords / 2^level, the
    first patch axis added to x (the public order)."""
    S, N, C = track_feats.shape
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    off_x = d.repeat_interleave(2 * radius + 1)
    off_y = d.repeat(2 * radius + 1)
    outs = []
    for i, fm in enumerate(pyramid):
        root_c = torch.sqrt(torch.tensor(float(C), device=fm.device))
        cm = torch.einsum("snc,shwc->snhw", track_feats, fm) / root_c
        cl = coords / (2.0**i)
        x = (cl[..., 0:1] + off_x).reshape(S * N, -1)
        y = (cl[..., 1:2] + off_y).reshape(S * N, -1)
        outs.append(_sample_maps(cm.reshape(S * N, *cm.shape[2:]), x, y).reshape(S, N, -1))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# EfficientUpdateFormer
# ---------------------------------------------------------------------------


class _MHA(nn.Module):
    """nn.MultiheadAttention's parameters and math (batch first)."""

    def __init__(self, E: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * E, E))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E))
        self.out_proj = nn.Linear(E, E)

    def forward(self, x_q, x_kv):
        E = x_q.shape[-1]
        w, b = self.in_proj_weight, self.in_proj_bias
        h = self.heads
        q = F.linear(x_q, w[:E], b[:E])
        k = F.linear(x_kv, w[E : 2 * E], b[E : 2 * E])
        v = F.linear(x_kv, w[2 * E :], b[2 * E :])
        q, k, v = (t.reshape(t.shape[:-1] + (h, E // h)) for t in (q, k, v))
        y = attention(q, k, v, q_scale=(E // h) ** -0.5)
        return self.out_proj(y.reshape(y.shape[:-2] + (E,)))


class _Mlp(nn.Module):
    """fc1, tanh GELU, fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class _AttnBlock(nn.Module):
    def __init__(self, E: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(E, eps=1e-6)
        self.attn = _MHA(E, heads)
        self.norm2 = nn.LayerNorm(E, eps=1e-6)
        self.mlp = _Mlp(E, 4 * E, E)

    def forward(self, x):
        y = self.norm1(x)
        x = x + self.attn(y, y)
        return x + self.mlp(self.norm2(x))


class _CrossAttnBlock(nn.Module):
    def __init__(self, E: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(E, eps=1e-6)
        self.norm_context = nn.LayerNorm(E, eps=1e-5)
        self.cross_attn = _MHA(E, heads)
        self.norm2 = nn.LayerNorm(E, eps=1e-6)
        self.mlp = _Mlp(E, 4 * E, E)

    def forward(self, x, context):
        x = x + self.cross_attn(self.norm1(x), self.norm_context(context))
        return x + self.mlp(self.norm2(x))


class UpdateFormer(nn.Module):
    def __init__(self, o: TrackOptions):
        super().__init__()
        C, E = o.latent_dim, o.hidden_size
        self.input_transform = nn.Linear(3 * C + 4, E)
        self.flow_head = nn.Linear(E, C + 2)
        self.virual_tracks = nn.Parameter(torch.zeros(1, o.num_virtual_tracks, 1, E))
        self.time_blocks = nn.ModuleList([_AttnBlock(E, o.num_heads) for _ in range(o.depth)])
        self.space_virtual_blocks = nn.ModuleList([_AttnBlock(E, o.num_heads) for _ in range(o.depth)])
        self.space_point2virtual_blocks = nn.ModuleList([_CrossAttnBlock(E, o.num_heads) for _ in range(o.depth)])
        self.space_virtual2point_blocks = nn.ModuleList([_CrossAttnBlock(E, o.num_heads) for _ in range(o.depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, S, 3C + 4) -> (N, S, C + 2): time attention per track,
        space attention per frame through the virtual tracks (virtual <-
        point, virtual self, point <- virtual), one space step after each
        time block."""
        tokens = self.input_transform(x)
        init_tokens = tokens
        N, S, E = tokens.shape
        virtual = self.virual_tracks[0, :, 0][:, None, :].expand(-1, S, -1)
        tokens = torch.cat([tokens, virtual], dim=0)  # (N + V, S, E)
        n_time, n_space = len(self.time_blocks), len(self.space_virtual_blocks)
        j = 0
        for i in range(n_time):
            tokens = self.time_blocks[i](tokens)
            if n_space and j < n_space and i % (n_time // n_space) == 0:
                sp = tokens.transpose(0, 1)  # (S, N + V, E)
                point, virt = sp[:, :N], sp[:, N:]
                virt = self.space_virtual2point_blocks[j](virt, point)
                virt = self.space_virtual_blocks[j](virt)
                point = self.space_point2virtual_blocks[j](point, virt)
                tokens = torch.cat([point, virt], dim=1).transpose(0, 1)
                j += 1
        return self.flow_head(tokens[:N] + init_tokens)


# ---------------------------------------------------------------------------
# tracker and head
# ---------------------------------------------------------------------------


class Tracker(nn.Module):
    def __init__(self, o: TrackOptions):
        super().__init__()
        C = o.latent_dim
        self.fmap_norm = nn.LayerNorm(C, eps=1e-5)
        self.corr_mlp = _Mlp(o.corr_levels * (2 * o.corr_radius + 1) ** 2, o.hidden_size, C)
        self.updateformer = UpdateFormer(o)
        self.ffeat_norm = nn.GroupNorm(1, C)
        self.ffeat_updater = nn.Sequential(nn.Linear(C, C), nn.GELU())
        self.vis_predictor = nn.Sequential(nn.Linear(C, 1))
        self.conf_predictor = nn.Sequential(nn.Linear(C, 1))

    def _group_norm1(self, x):
        """GroupNorm(1, C) on (..., C): over the channels of each row."""
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.ffeat_norm.eps) * self.ffeat_norm.weight + self.ffeat_norm.bias

    def forward(self, fmaps: torch.Tensor, query_points: torch.Tensor, o: TrackOptions, iters=None):
        """fmaps (S, Hf, Wf, C); query_points (N, 2) pixel xy of frame 0 ->
        (coordinate predictions, one (S, N, 2) in pixels per iteration,
        vis (S, N), conf (S, N))."""
        S, N = fmaps.shape[0], query_points.shape[0]
        fmaps = self.fmap_norm(fmaps)
        qp = query_points / float(o.stride)
        query_feat = sample_features4d(fmaps[0], qp)
        coords = qp[None].expand(S, N, 2)
        track_feats = query_feat[None].expand(S, N, o.latent_dim)
        pyramid = build_fmap_pyramid(fmaps, o.corr_levels)
        coord_preds = []
        for _ in range(o.iters if iters is None else iters):
            fcorrs = self.corr_mlp(corr_sample(pyramid, track_feats, coords, o.corr_radius).transpose(0, 1))
            flows = (coords - coords[0:1]).transpose(0, 1)  # (N, S, 2)
            flows_emb = torch.cat([get_2d_embedding(flows, o.latent_dim // 2), flows / o.max_scale,
                                   flows / o.max_scale], dim=-1)
            feats_t = track_feats.transpose(0, 1)
            delta = self.updateformer(torch.cat([flows_emb, fcorrs, feats_t], dim=-1))
            upd = F.gelu(self.ffeat_updater[0](self._group_norm1(delta[..., 2:])))
            track_feats = (feats_t + upd).transpose(0, 1)
            coords = coords + delta[..., :2].transpose(0, 1)
            coord_preds.append(coords * o.stride)
        vis = torch.sigmoid(self.vis_predictor(track_feats)[..., 0])
        conf = torch.sigmoid(self.conf_predictor(track_feats)[..., 0]) if o.predict_conf else torch.ones_like(vis)
        return coord_preds, vis, conf


class TrackHead(nn.Module):
    def __init__(self, vggt_opts: VGGTOptions, o: TrackOptions):
        super().__init__()
        self.feature_extractor = DPTHead(vggt_opts, o.dpt_features, vggt_opts.dpt_out_channels, None,
                                         conv1_out=o.latent_dim)
        self.tracker = Tracker(o)

    def forward(self, outputs: list, patch_start: int, hw, query_points: torch.Tensor, o: TrackOptions,
                iters=None):
        """DPT features at (H, W) / stride, then the tracker; query_points
        (N, 2) pixel xy of frame 0."""
        fmaps = self.feature_extractor(outputs, patch_start, hw, activation="features", down_ratio=o.stride)
        return self.tracker(fmaps, query_points, o, iters)


def track_options_from_state_dict(sd: dict) -> TrackOptions:
    """TrackOptions of a state_dict's ``track_head.*`` entries, the dims read
    off the shapes as the reference reads them (the radius the largest of
    4..1 whose patch divides the correlation width; 8 heads when the hidden
    width is a multiple of 8, else 6); the other fields their defaults."""
    tk = "track_head.tracker"
    C = int(sd[f"{tk}.fmap_norm.weight"].shape[0])
    E = int(sd[f"{tk}.updateformer.input_transform.weight"].shape[0])
    corr_dim = int(sd[f"{tk}.corr_mlp.fc1.weight"].shape[1])
    for radius in (4, 3, 2, 1):
        if corr_dim % (2 * radius + 1) ** 2 == 0:
            break
    prefix = f"{tk}.updateformer.time_blocks."
    return TrackOptions(
        latent_dim=C, hidden_size=E, corr_levels=corr_dim // (2 * radius + 1) ** 2, corr_radius=radius,
        depth=max(int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)) + 1,
        num_heads=8 if E % 8 == 0 else 6,
        num_virtual_tracks=int(sd[f"{tk}.updateformer.virual_tracks"].shape[1]),
        dpt_features=int(sd["track_head.feature_extractor.scratch.layer1_rn.weight"].shape[0]),
    )
