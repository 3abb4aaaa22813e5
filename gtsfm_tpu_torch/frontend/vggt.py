"""VGGT (the public facebook/VGGT-1B architecture) in PyTorch.

Port of gtsfm_tpu/frontend/vggt.py ("VGGT: Visual Geometry Grounded
Transformer", Wang et al., CVPR 2025), ``nn.Module``s whose state_dict
keys are the public ``model.state_dict()``'s, so a checkpoint loads with
``load_state_dict``:

  aggregator    DINOv2 ViT-L/14 with 4 register tokens (megaloc.py's
                ``DinoViT``, registers added) for the patch tokens, then
                ``depth`` alternating frame blocks (attention within each
                frame) and global blocks (attention across all frames):
                qk LayerNorm, 2D RoPE (frequency 100) on the patch (y, x)
                + 1, the special tokens at (0, 0); a camera token and 4
                register tokens per frame, frame 0's its own; every layer's
                frame and global outputs concatenated to 2C
  camera_head   4 iterations of an AdaLN-modulated trunk over the camera
                tokens predicting absT_quaR_FoV encodings
  depth_head    DPT over 4 intermediate layers (projects, resize pyramid,
                refinenets, output convs), exp depth, 1 + exp confidence
  point_head    the same DPT family (loaded with a checkpoint, not run)
  track_head    frontend/vggt_track.py

The numbers are the reference's: LayerNorm epsilon 1e-5 in VGGT's own
blocks and 1e-6 in DINO's, the exact GELU, AdaLN's 1e-5, bilinear resizes
with aligned corners by the reference's formula. Attention is plain
PyTorch (``numerics.attention``, in chunks of query rows: the global
block's scores over 32 frames of 480x640 would take 154 GB at once), the
DINO pass and the DPT heads go a few frames at a time, and the aggregator
keeps only the layers the heads read. Float32 under ``precise()``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.frontend.global_descriptors.megaloc import DinoViT, MegaLocOptions, interpolate_pos_embed
from gtsfm_tpu_torch.frontend.mast3r import apply_rope2d
from gtsfm_tpu_torch.utils.numerics import attention, precise, resolve_device

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)
# frames per chunk of the per-frame stages (DINO, the DPT heads)
FRAME_CHUNK = 4


class VGGTOptions(NamedTuple):
    embed_dim: int = 1024
    depth: int = 24  # alternating frame/global layer pairs
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    num_register_tokens: int = 4
    rope_freq: float = 100.0
    init_values: float = 0.01  # LayerScale init
    # DINO patch embed (ViT-L/14 reg4)
    dino_depth: int = 24
    dino_heads: int = 16
    dino_pretrain_grid: int = 37  # 518 / 14
    # camera head
    camera_trunk_depth: int = 4
    camera_iterations: int = 4
    pose_dim: int = 9  # absT(3) + quaR(4) + FoV(2)
    # DPT heads
    dpt_features: int = 256
    dpt_out_channels: tuple = (256, 512, 1024, 1024)
    intermediate_layer_idx: tuple = (4, 11, 17, 23)
    # the camera trunk's qk LayerNorm: the reference's init has one, the
    # public checkpoint's trunk does not
    camera_qk_norm: bool = True


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, qk_norm: bool, eps: float):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // heads, eps=eps)
            self.k_norm = nn.LayerNorm(dim // heads, eps=eps)

    def forward(self, x, pos=None, rope_freq: float = 0.0):
        """x (B, N, D); pos (N, 2) integer (y, x) for RoPE."""
        B, N, D = x.shape
        h = self.heads
        dh = D // h
        q, k, v = self.qkv(x).reshape(B, N, 3, h, dh).unbind(2)  # (B, N, h, dh)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        if pos is not None and rope_freq > 0:
            q = apply_rope2d(q.transpose(1, 2), pos, rope_freq).transpose(1, 2)
            k = apply_rope2d(k.transpose(1, 2), pos, rope_freq).transpose(1, 2)
        return self.proj(attention(q, k, v, q_scale=dh**-0.5).reshape(B, N, D))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, qk_norm: bool, eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = _Attention(dim, heads, qk_norm, eps)
        self.ls1 = _LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = _Mlp(dim, mlp_ratio * dim)
        self.ls2 = _LayerScale(dim)

    def forward(self, x, pos=None, rope_freq: float = 0.0):
        x = x + self.ls1.gamma * self.attn(self.norm1(x), pos, rope_freq)
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


# ---------------------------------------------------------------------------
# aggregator
# ---------------------------------------------------------------------------


class DinoViTReg(DinoViT):
    """DINOv2 with register tokens, inserted after the class token (the
    position embedding on the class token and the patches only)."""

    def __init__(self, opts: MegaLocOptions, num_register_tokens: int):
        super().__init__(opts)
        self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, opts.embed_dim))

    def forward(self, images: torch.Tensor):
        """images (B, 3, H, W) normalized -> normalized patch tokens (B,
        h*w, D)."""
        B, _, H, W = images.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = self.patch_embed.proj(images).flatten(2).transpose(1, 2)
        cls_pe, patch_pe = interpolate_pos_embed(self.pos_embed, gh, gw)
        R = self.register_tokens.shape[1]
        x = torch.cat([(self.cls_token + cls_pe).expand(B, -1, -1), self.register_tokens.expand(B, -1, -1),
                       x + patch_pe], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1 + R :]


def _slice_expand(token: torch.Tensor, S: int) -> torch.Tensor:
    """(1, 2, X, C): row 0 for frame 0, row 1 for the others -> (S, X, C)."""
    return torch.cat([token[0, :1], token[0, 1:2].expand(S - 1, -1, -1)], dim=0)


class Aggregator(nn.Module):
    def __init__(self, o: VGGTOptions):
        super().__init__()
        self.opts = o
        C = o.embed_dim
        self.patch_embed = DinoViTReg(MegaLocOptions(embed_dim=C, depth=o.dino_depth, num_heads=o.dino_heads,
                                                     mlp_ratio=o.mlp_ratio, patch_size=o.patch_size,
                                                     pretrain_grid=o.dino_pretrain_grid), o.num_register_tokens)
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, C))
        self.register_token = nn.Parameter(torch.zeros(1, 2, o.num_register_tokens, C))
        self.frame_blocks = nn.ModuleList([_Block(C, o.num_heads, o.mlp_ratio, True) for _ in range(o.depth)])
        self.global_blocks = nn.ModuleList([_Block(C, o.num_heads, o.mlp_ratio, True) for _ in range(o.depth)])

    def forward(self, images: torch.Tensor, keep=None) -> tuple:
        """images (S, 3, H, W) in [0, 1] -> (outputs, patch_start): outputs
        has one (S, L, 2C) tensor per layer, None for a layer not in
        ``keep`` (every layer when None)."""
        o = self.opts
        S, _, H, W = images.shape
        gh, gw = H // o.patch_size, W // o.patch_size
        mean = torch.tensor(RESNET_MEAN, device=images.device)[:, None, None]
        std = torch.tensor(RESNET_STD, device=images.device)[:, None, None]
        patch_tokens = torch.cat([self.patch_embed((images[s : s + FRAME_CHUNK] - mean) / std)
                                  for s in range(0, S, FRAME_CHUNK)])
        C = patch_tokens.shape[-1]
        regs = _slice_expand(self.register_token, S)
        tokens = torch.cat([_slice_expand(self.camera_token, S), regs, patch_tokens], dim=1)
        patch_start = 1 + regs.shape[1]
        L = tokens.shape[1]
        yy, xx = torch.meshgrid(torch.arange(gh, device=images.device), torch.arange(gw, device=images.device),
                                indexing="ij")
        pos = torch.cat([torch.zeros(patch_start, 2, dtype=torch.int64, device=images.device),
                         torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1) + 1])
        pos_global = pos.repeat(S, 1)
        outputs = []
        for i, (fblk, gblk) in enumerate(zip(self.frame_blocks, self.global_blocks)):
            tokens = fblk(tokens, pos, o.rope_freq)
            frame_out = tokens
            tokens = gblk(tokens.reshape(1, S * L, C), pos_global, o.rope_freq).reshape(S, L, C)
            outputs.append(torch.cat([frame_out, tokens], dim=-1) if keep is None or i in keep else None)
        return outputs, patch_start


# ---------------------------------------------------------------------------
# camera head
# ---------------------------------------------------------------------------


class CameraHead(nn.Module):
    def __init__(self, o: VGGTOptions):
        super().__init__()
        self.opts = o
        C2 = 2 * o.embed_dim
        self.token_norm = nn.LayerNorm(C2, eps=1e-5)
        self.trunk = nn.ModuleList([_Block(C2, o.num_heads, o.mlp_ratio, o.camera_qk_norm)
                                    for _ in range(o.camera_trunk_depth)])
        self.trunk_norm = nn.LayerNorm(C2, eps=1e-5)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, o.pose_dim))
        self.embed_pose = nn.Linear(o.pose_dim, C2)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(C2, 3 * C2))
        self.pose_branch = _Mlp(C2, C2 // 2, o.pose_dim)

    def forward(self, last: torch.Tensor) -> torch.Tensor:
        """The last aggregator layer (S, L, 2C) -> pose encodings (S, 9)
        after the last refinement iteration."""
        tokens = self.token_norm(last[:, 0])[None]  # (1, S, 2C): attention across the frames
        S = tokens.shape[1]
        pred = None
        for _ in range(self.opts.camera_iterations):
            inp = self.empty_pose_tokens[0].expand(S, -1) if pred is None else pred
            mod = self.poseLN_modulation[1](F.silu(self.embed_pose(inp)))
            shift, scale, gate = mod.chunk(3, dim=-1)
            mu = tokens.mean(dim=-1, keepdim=True)
            var = tokens.var(dim=-1, unbiased=False, keepdim=True)
            t = gate * ((tokens - mu) * torch.rsqrt(var + 1e-5) * (1 + scale) + shift) + tokens
            for blk in self.trunk:
                t = blk(t)
            delta = self.pose_branch(self.trunk_norm(t))[0]
            pred = delta if pred is None else pred + delta
        return pred


def pose_encoding_to_extri_intri(pose_enc: torch.Tensor, hw) -> tuple:
    """absT_quaR_FoV encodings (S, 9) -> (extrinsic (S, 3, 4) world->cam,
    intrinsic (S, 3, 3))."""
    H, W = hw
    R = _quat_to_mat(pose_enc[:, 3:7])
    extri = torch.cat([R, pose_enc[:, :3, None]], dim=-1)
    fy = (H / 2.0) / torch.tan(pose_enc[:, 7] / 2.0)
    fx = (W / 2.0) / torch.tan(pose_enc[:, 8] / 2.0)
    K = torch.zeros(pose_enc.shape[0], 3, 3, dtype=pose_enc.dtype, device=pose_enc.device)
    K[:, 0, 0], K[:, 1, 1] = fx, fy
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2.0, H / 2.0, 1.0
    return extri, K


def _quat_to_mat(quat: torch.Tensor) -> torch.Tensor:
    """(S, 4) quaternions, real part last, not normalized -> (S, 3, 3)."""
    q = quat / torch.clamp(torch.linalg.vector_norm(quat, dim=-1, keepdim=True), min=1e-9)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# DPT head
# ---------------------------------------------------------------------------


def interp_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) with aligned corners, by the
    reference's formula (a0 + (a1 - a0) f along each axis, rows first)."""

    def axis(a, dim, out):
        m = a.shape[dim]
        if m == out:
            return a
        if m == 1:
            return a.expand(*[out if d == dim else -1 for d in range(a.dim())]).contiguous()
        pos = torch.arange(out, dtype=torch.float32, device=a.device) * (m - 1) / (out - 1)
        i0 = torch.floor(pos).to(torch.int64)
        i1 = torch.clamp(i0 + 1, max=m - 1)
        f = (pos - i0).reshape([out if d == dim else 1 for d in range(a.dim())])
        a0, a1 = a.index_select(dim, i0), a.index_select(dim, i1)
        return a0 + (a1 - a0) * f

    return axis(axis(x, 2, out_h), 3, out_w)


class _ResidualConvUnit(nn.Module):
    def __init__(self, F_: int):
        super().__init__()
        self.conv1 = nn.Conv2d(F_, F_, 3, padding=1)
        self.conv2 = nn.Conv2d(F_, F_, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _FusionBlock(nn.Module):
    def __init__(self, F_: int, has_residual: bool = True):
        super().__init__()
        if has_residual:
            self.resConfUnit1 = _ResidualConvUnit(F_)
        self.resConfUnit2 = _ResidualConvUnit(F_)
        self.out_conv = nn.Conv2d(F_, F_, 1)

    def forward(self, x, skip=None, size=None):
        out = x if skip is None else x + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        size = size or (2 * out.shape[2], 2 * out.shape[3])
        return self.out_conv(interp_bilinear_ac(out, *size))


class _Scratch(nn.Module):
    def __init__(self, out_channels: tuple, F_: int, conv1_out: int, output_dim: Optional[int]):
        super().__init__()
        for i, c in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, F_, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", _FusionBlock(F_, has_residual=i != 4))
        self.output_conv1 = nn.Conv2d(F_, conv1_out, 3, padding=1)
        if output_dim is not None:
            self.output_conv2 = nn.Sequential(nn.Conv2d(conv1_out, 32, 3, padding=1), nn.ReLU(),
                                              nn.Conv2d(32, output_dim, 1))


class DPTHead(nn.Module):
    """The DPT head over 4 intermediate aggregator layers. ``output_dim``
    channels out (value channels then one confidence), or with
    ``output_dim=None`` the feature-only mode (the track head's feature
    extractor): ``conv1_out`` channels after output_conv1."""

    def __init__(self, o: VGGTOptions, features: int, out_channels: tuple, output_dim: Optional[int],
                 conv1_out: Optional[int] = None):
        super().__init__()
        self.opts = o
        C2 = 2 * o.embed_dim
        oc = out_channels
        self.norm = nn.LayerNorm(C2, eps=1e-5)
        self.projects = nn.ModuleList([nn.Conv2d(C2, c, 1) for c in oc])
        self.resize_layers = nn.ModuleList([nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
                                            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2), nn.Identity(),
                                            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(oc, features, conv1_out or features // 2, output_dim)

    def forward(self, outputs: list, patch_start: int, hw, activation: str = "exp", down_ratio: int = 1):
        """-> for "exp" / "inv_log": (value (S, H, W, c), confidence (S, H,
        W)); "raw": (S, H, W, output_dim); "features": (S, H/down, W/down,
        conv1_out). Frames go FRAME_CHUNK at a time."""
        S = next(t for t in outputs if t is not None).shape[0]
        outs = [self._frames(outputs, patch_start, hw, s, activation, down_ratio)
                for s in range(0, S, FRAME_CHUNK)]
        out = torch.cat(outs).permute(0, 2, 3, 1)
        if activation in ("raw", "features"):
            return out
        val, conf_raw = out[..., :-1], out[..., -1]
        if activation == "exp":
            val = torch.exp(val)
        elif activation == "inv_log":
            val = torch.sign(val) * torch.expm1(torch.abs(val))
        return val, 1.0 + torch.exp(conf_raw)

    def _frames(self, outputs, patch_start, hw, s, activation, down_ratio):
        o = self.opts
        H, W = hw
        gh, gw = H // o.patch_size, W // o.patch_size
        sc = self.scratch
        feats = []
        for k, li in enumerate(o.intermediate_layer_idx):
            t = self.norm(outputs[li][s : s + FRAME_CHUNK, patch_start:])
            x = self.projects[k](t.reshape(t.shape[0], gh, gw, -1).permute(0, 3, 1, 2))
            x = self.resize_layers[k](x)
            feats.append(getattr(sc, f"layer{k + 1}_rn")(x))
        l1, l2, l3, l4 = feats
        path = sc.refinenet4(l4, size=l3.shape[2:])
        path = sc.refinenet3(path, l3, size=l2.shape[2:])
        path = sc.refinenet2(path, l2, size=l1.shape[2:])
        path = sc.refinenet1(path, l1)
        out = interp_bilinear_ac(sc.output_conv1(path), gh * o.patch_size // down_ratio,
                                 gw * o.patch_size // down_ratio)
        if activation == "features":
            return out
        return sc.output_conv2(out)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class VGGTNet(nn.Module):
    def __init__(self, o: VGGTOptions, track_options=None, point_head: bool = False):
        super().__init__()
        self.opts = o
        self.aggregator = Aggregator(o)
        self.camera_head = CameraHead(o)
        self.depth_head = DPTHead(o, o.dpt_features, o.dpt_out_channels, 2)
        if point_head:
            self.point_head = DPTHead(o, o.dpt_features, o.dpt_out_channels, 4)
        if track_options is not None:
            from gtsfm_tpu_torch.frontend.vggt_track import TrackHead

            self.track_head = TrackHead(o, track_options)

    def heads_layers(self) -> set:
        """The aggregator layers the heads read."""
        return set(self.opts.intermediate_layer_idx) | {self.opts.depth - 1}

    def forward(self, images: torch.Tensor) -> tuple:
        """images (S, 3, H, W) in [0, 1] -> (extrinsic, intrinsic, depth (S,
        H', W'), depth_conf), H' and W' the patch grid's."""
        S, _, H, W = images.shape
        outputs, ps = self.aggregator(images, keep=self.heads_layers())
        extri, intri = pose_encoding_to_extri_intri(self.camera_head(outputs[-1]), (H, W))
        depth, conf = self.depth_head(outputs, ps, (H, W), activation="exp")
        return extri, intri, depth[..., 0], conf


class VGGTModel:
    """run(images (S, H, W, 3) in [0, 1]) -> {extrinsic (S, 3, 4)
    world->cam, intrinsic (S, 3, 3), depth (S, H', W'), depth_conf}: the
    run_VGGT contract. ``track`` runs the track head. ``state_dict`` (the
    public layout; its shapes set the dims) or the seeded init of
    ``init_net`` at ``options`` (with a track head at ``track_options``),
    on ``device``: the CUDA card unless given ``device="cpu"``."""

    def __init__(self, options: VGGTOptions = VGGTOptions(), state_dict: Optional[dict] = None, seed: int = 0,
                 track_options=None, device="cuda"):
        self.device = resolve_device(device)
        if state_dict is not None:
            options, track_options = options_from_state_dict(state_dict, options)
            with torch.device("meta"):
                net = VGGTNet(options, track_options, point_head="point_head.norm.weight" in state_dict)
            net.load_state_dict({k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
                                 for k, v in state_dict.items()}, assign=True)
        else:
            net = init_net(options, track_options, seed)
        self.options = options
        self.track_options = track_options
        self.net = net.to(self.device).eval().requires_grad_(False)

    @property
    def has_track_head(self) -> bool:
        return self.track_options is not None

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, dtype=torch.float32, device=self.device).permute(0, 3, 1, 2)

    def run(self, images) -> dict:
        with torch.no_grad(), precise():
            extri, intri, depth, conf = self.net(self._images(images))
        return {"extrinsic": extri, "intrinsic": intri, "depth": depth, "depth_conf": conf}

    def track(self, images, query_points) -> dict:
        """Track query_points (N, 2), pixel xy of frame 0, across every
        frame: the aggregator runs again, then the track head. Returns
        tracks (S, N, 2), vis (S, N), conf (S, N)."""
        from gtsfm_tpu_torch.frontend.vggt_track import track_options_from_state_dict

        x = self._images(images)
        qp = torch.as_tensor(query_points, dtype=torch.float32, device=self.device)
        topts = track_options_from_state_dict(self.net.state_dict())
        with torch.no_grad(), precise():
            outputs, ps = self.net.aggregator(x, keep=self.net.heads_layers())
            coord_preds, vis, conf = self.net.track_head(outputs, ps, x.shape[2:], qp, topts)
        return {"tracks": coord_preds[-1], "vis": vis, "conf": conf}


# ---------------------------------------------------------------------------
# init and weights
# ---------------------------------------------------------------------------


def init_weights(net: nn.Module, init_values: float, seed: int) -> None:
    """The reference's ``init_params`` scales, drawn from a torch generator
    seeded with ``seed`` (torch cannot repeat the reference's
    ``jax.random`` draws): weights, tokens and embeddings N(0, 0.02^2),
    biases 0, norms 1, LayerScales ``init_values``, the empty pose token
    0, the virtual tracks N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("bias"):
                p.zero_()
            elif leaf == "gamma":
                p.fill_(init_values)
            elif leaf == "weight" and "norm" in name.rsplit(".", 2)[-2]:
                p.fill_(1.0)
            elif leaf == "empty_pose_tokens":
                p.zero_()
            elif leaf == "virual_tracks":
                p.copy_(torch.randn(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)


def init_net(o: VGGTOptions, track_options=None, seed: int = 0) -> VGGTNet:
    net = VGGTNet(o, track_options)
    init_weights(net, o.init_values, seed)
    return net


def options_from_state_dict(sd: dict, opts: Optional[VGGTOptions] = None) -> tuple:
    """(VGGTOptions, TrackOptions or None) of a public-layout state_dict,
    the dims read off the tensors' shapes as the reference's converter
    reads them; ``opts`` (when given) keeps its other fields."""
    from gtsfm_tpu_torch.frontend.vggt_track import track_options_from_state_dict

    def n_blocks(prefix):
        return max(int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)) + 1

    C = int(sd["aggregator.camera_token"].shape[-1])
    qn = "aggregator.frame_blocks.0.attn.q_norm.weight"
    heads = C // int(sd[qn].shape[0]) if qn in sd else 16
    dims = dict(
        embed_dim=C, depth=n_blocks("aggregator.frame_blocks."), num_heads=heads,
        mlp_ratio=int(sd["aggregator.frame_blocks.0.mlp.fc1.weight"].shape[0]) // C,
        num_register_tokens=int(sd["aggregator.register_token"].shape[-2]),
        dino_depth=n_blocks("aggregator.patch_embed.blocks."), dino_heads=heads,
        dino_pretrain_grid=int(math.isqrt(int(sd["aggregator.patch_embed.pos_embed"].shape[1]) - 1)),
        camera_trunk_depth=n_blocks("camera_head.trunk."),
        dpt_features=int(sd["depth_head.scratch.layer1_rn.weight"].shape[0]),
        dpt_out_channels=tuple(int(sd[f"depth_head.projects.{i}.weight"].shape[0]) for i in range(4)),
        camera_qk_norm="camera_head.trunk.0.attn.q_norm.weight" in sd,
    )
    opts = VGGTOptions(**dims) if opts is None else opts._replace(**dims)
    track = track_options_from_state_dict(sd) if "track_head.tracker.fmap_norm.weight" in sd else None
    return opts, track


def load_torch_weights(path: str) -> dict:
    """A facebook/VGGT-1B checkpoint (or a state_dict of its layout) ->
    its state_dict, with a ``model.`` prefix stripped."""
    from gtsfm_tpu_torch.utils.torch_io import load_torch_checkpoint

    ckpt = load_torch_checkpoint(path)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
