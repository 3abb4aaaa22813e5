"""A plain float32 VGGT: the forward of facebook/VGGT-1B ("VGGT: Visual
Geometry Grounded Transformer", Wang et al., CVPR 2025, arXiv:2503.11651,
github.com/facebookresearch/vggt) written from the published description
and the public state-dict keys, for the feed-forward pipeline's check
(perfbench/pipelines/feedforward.py). It imports nothing of the program.

- aggregator: a DINOv2 ViT-L/14 with 4 register tokens (``patch_embed``)
  gives each frame's normalized patch tokens; a camera token and 4 register
  tokens are put before them (``camera_token``, ``register_token``: row 0
  for frame 0, row 1 for the others); then ``depth`` frame blocks
  (attention within one frame) alternate with ``depth`` global blocks
  (attention over every token of every frame). The blocks are pre-norm
  transformer blocks with qk LayerNorm, LayerScale and a 2D rotary
  embedding (frequency 100) of the patch's (row, column) + 1, the special
  tokens at (0, 0); every layer's frame and global outputs are
  concatenated to 2C.
- camera head: the camera tokens of the last layer through 4 iterations of
  an AdaLN-modulated trunk, each adding a correction to the 9-value pose
  encoding (translation, quaternion with its real part last, the vertical
  and horizontal fields of view).
- depth head: DPT over layers 4, 11, 17 and 23 (LayerNorm, 1x1 projections,
  a resize pyramid, refinement units, output convolutions); depth exp(x),
  confidence 1 + exp(x).
- track head: the DPT head in feature-only mode at half resolution, then
  the tracker: the queries' features sampled from frame 0, a correlation
  pyramid (2x2 average pools, a 9x9 patch of each level's correlation map),
  and iterations of a time / space transformer that routes space
  attention through learned virtual tracks; sigmoid visibility and
  confidence.
- point head: loaded with the checkpoint and not run.

Plain ``torch`` in float32: ``precision()`` turns TF32 off for matrix
products and convolutions (``tf32=True`` turns it on, for the control).
Attention is computed one head at a time with every query row's whole
softmax: a head's scores over the 16,656 tokens of 16 frames take 1.1 GB.
Every frame goes through each stage at once; all layers are kept.

Where the port (gtsfm_tpu_torch/frontend/vggt.py, vggt_track.py) departs
from the published model on purpose, this reference takes the port's
choice:

- the camera head's AdaLN normalizes with epsilon 1e-5 (published: 1e-6);
- no activation on the predicted fields of view (published: a ReLU);
- the bilinear resizes with aligned corners use the formula a0 + (a1 - a0)
  f along rows, then columns, with source positions i (m - 1) / (n - 1);
- the track head runs the aggregator again on the same frames instead of
  reusing the products' pass;
- DINOv2's position embedding is resampled as DINOv2's own default does
  (bicubic, the scale (grid + 0.1) / 37, no antialiasing; VGGT builds its
  DINO with offset 0 and antialiasing);
- the DPT heads add no sinusoidal position embedding of the patch grid.

Read as the port reads the published tracker (not checked against the
public code here): every MLP of the tracker uses the tanh GELU and the
update former's LayerNorms carry weights.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class TrackDims(NamedTuple):
    latent_dim: int = 128
    stride: int = 2
    corr_levels: int = 7
    corr_radius: int = 4
    hidden_size: int = 384
    iters: int = 4
    depth: int = 6
    num_heads: int = 8
    num_virtual_tracks: int = 64
    max_scale: int = 518
    dpt_features: int = 128


class Dims(NamedTuple):
    """VGGT-1B's published sizes."""

    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    num_register_tokens: int = 4
    rope_freq: float = 100.0
    dino_depth: int = 24
    dino_heads: int = 16
    dino_pretrain_grid: int = 37
    camera_trunk_depth: int = 4
    camera_iterations: int = 4
    pose_dim: int = 9
    dpt_features: int = 256
    dpt_out_channels: tuple = (256, 512, 1024, 1024)
    intermediate_layer_idx: tuple = (4, 11, 17, 23)
    track: TrackDims = TrackDims()


def dims_from(model: dict) -> Dims:
    """Dims from a configuration's ``model`` entry (lists as tuples)."""
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in model.items() if k in Dims._fields}
    fields["track"] = TrackDims(**{k: v for k, v in model.get("track", {}).items() if k in TrackDims._fields})
    return Dims(**fields)


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Matrix products and convolutions in float32 (``tf32=False``) or
    TF32; the previous flags come back on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for q (B, N, h, d), k and v (B, M, h, d),
    one head at a time."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.empty_like(q)
    for i in range(q.shape[2]):
        scores = torch.matmul(q[:, :, i], k[:, :, i].transpose(1, 2)) * scale
        out[:, :, i] = torch.matmul(torch.softmax(scores, dim=-1), v[:, :, i])
    return out


def rope2d(x: torch.Tensor, pos: torch.Tensor, freq: float) -> torch.Tensor:
    """The 2D rotary embedding: x (B, N, h, d), its first d/2 channels
    rotated by the row and the rest by the column of pos (N, 2); each half
    rotates its two quarters as (a, b) -> (a cos - b sin, b cos + a sin)."""
    half = x.shape[-1] // 2
    inv = 1.0 / freq ** (torch.arange(0, half, 2, dtype=torch.float32, device=x.device) / half)
    parts = []
    for axis in range(2):
        t = x[..., axis * half:(axis + 1) * half]
        ang = pos[:, axis].to(torch.float32)[:, None] * inv[None]
        ang = torch.cat([ang, ang], dim=-1)[None, :, None, :]
        a, b = t[..., : half // 2], t[..., half // 2:]
        parts.append(t * torch.cos(ang) + torch.cat([-b, a], dim=-1) * torch.sin(ang))
    return torch.cat(parts, dim=-1)


def resize_aligned(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) with aligned corners, rows first, by
    a0 + (a1 - a0) f (the port's formula)."""

    def along(a, dim, n):
        m = a.shape[dim]
        if m == n:
            return a
        if m == 1:
            return a.expand(*[n if d == dim else -1 for d in range(a.dim())]).contiguous()
        src = torch.arange(n, dtype=torch.float32, device=a.device) * (m - 1) / (n - 1)
        lo = src.floor().long()
        hi = (lo + 1).clamp(max=m - 1)
        frac = (src - lo).reshape([n if d == dim else 1 for d in range(a.dim())])
        a0, a1 = a.index_select(dim, lo), a.index_select(dim, hi)
        return a0 + (a1 - a0) * frac

    return along(along(x, 2, out_h), 3, out_w)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, tanh: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)
        self.approximate = "tanh" if tanh else "none"

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, qk_norm: bool):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // heads, eps=1e-5)
            self.k_norm = nn.LayerNorm(dim // heads, eps=1e-5)

    def forward(self, x, pos=None, freq=0.0):
        B, N, D = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, D // self.heads).unbind(2)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        if pos is not None:
            q, k = rope2d(q, pos, freq), rope2d(k, pos, freq)
        return self.proj(attend(q, k, v).reshape(B, N, D))


class Block(nn.Module):
    """x + ls1 attn(norm1 x), then x + ls2 mlp(norm2 x)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, qk_norm: bool, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = SelfAttention(dim, heads, qk_norm)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, mlp_ratio * dim, dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x, pos=None, freq=0.0):
        x = x + self.ls1.gamma * self.attn(self.norm1(x), pos, freq)
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


# ---------------------------------------------------------------------------
# aggregator
# ---------------------------------------------------------------------------


class PatchProj(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class Dino(nn.Module):
    """DINOv2 ViT with register tokens (the hub module's keys)."""

    def __init__(self, d: Dims):
        super().__init__()
        D, M = d.embed_dim, d.dino_pretrain_grid
        self.patch = d.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + M * M, D))
        self.register_tokens = nn.Parameter(torch.zeros(1, d.num_register_tokens, D))
        self.patch_embed = PatchProj(d.patch_size, D)
        self.blocks = nn.ModuleList([Block(D, d.dino_heads, d.mlp_ratio, False, 1e-6) for _ in range(d.dino_depth)])
        self.norm = nn.LayerNorm(D, eps=1e-6)

    def forward(self, x):
        """x (S, 3, H, W) normalized -> the patch tokens (S, gh * gw, D)
        after the final norm (trailing rows and columns past the last
        whole patch are not seen)."""
        S = x.shape[0]
        gh, gw = x.shape[2] // self.patch, x.shape[3] // self.patch
        t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        M = int(round(math.sqrt(self.pos_embed.shape[1] - 1)))
        pe = self.pos_embed[:, 1:]
        if (gh, gw) != (M, M):
            grid = pe.reshape(1, M, M, -1).permute(0, 3, 1, 2)
            grid = F.interpolate(grid, scale_factor=((gh + 0.1) / M, (gw + 0.1) / M), mode="bicubic",
                                 align_corners=False)
            pe = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        R = self.register_tokens.shape[1]
        t = torch.cat([(self.cls_token + self.pos_embed[:, :1]).expand(S, -1, -1),
                       self.register_tokens.expand(S, -1, -1), t + pe], dim=1)
        for blk in self.blocks:
            t = blk(t)
        return self.norm(t)[:, 1 + R:]


class Aggregator(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        self.d = d
        C = d.embed_dim
        self.patch_embed = Dino(d)
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, C))
        self.register_token = nn.Parameter(torch.zeros(1, 2, d.num_register_tokens, C))
        self.frame_blocks = nn.ModuleList([Block(C, d.num_heads, d.mlp_ratio, True, 1e-5) for _ in range(d.depth)])
        self.global_blocks = nn.ModuleList([Block(C, d.num_heads, d.mlp_ratio, True, 1e-5) for _ in range(d.depth)])

    def forward(self, images):
        """images (S, 3, H, W) in [0, 1] -> (every layer's (S, L, 2C)
        output, the index of the first patch token)."""
        d = self.d
        S, _, H, W = images.shape
        mean = torch.tensor(MEAN, device=images.device).reshape(1, 3, 1, 1)
        std = torch.tensor(STD, device=images.device).reshape(1, 3, 1, 1)
        patches = self.patch_embed((images - mean) / std)

        def per_frame(tok):  # (1, 2, X, C) -> (S, X, C): row 0 for frame 0
            return torch.cat([tok[0, :1], tok[0, 1:].expand(S - 1, -1, -1)], dim=0)

        tokens = torch.cat([per_frame(self.camera_token), per_frame(self.register_token), patches], dim=1)
        start = 1 + d.num_register_tokens
        gh, gw = H // d.patch_size, W // d.patch_size
        rows = torch.arange(gh, device=images.device).repeat_interleave(gw)
        cols = torch.arange(gw, device=images.device).repeat(gh)
        pos = torch.cat([torch.zeros(start, 2, dtype=torch.long, device=images.device),
                         torch.stack([rows, cols], dim=1) + 1])
        L, C = tokens.shape[1], tokens.shape[2]
        outs = []
        for fblk, gblk in zip(self.frame_blocks, self.global_blocks):
            tokens = fblk(tokens, pos, d.rope_freq)
            frame_out = tokens
            tokens = gblk(tokens.reshape(1, S * L, C), pos.repeat(S, 1), d.rope_freq).reshape(S, L, C)
            outs.append(torch.cat([frame_out, tokens], dim=-1))
        return outs, start


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


class CameraHead(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        self.d = d
        C2 = 2 * d.embed_dim
        self.token_norm = nn.LayerNorm(C2, eps=1e-5)
        self.trunk = nn.ModuleList([Block(C2, d.num_heads, d.mlp_ratio, False, 1e-5)
                                    for _ in range(d.camera_trunk_depth)])
        self.trunk_norm = nn.LayerNorm(C2, eps=1e-5)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, d.pose_dim))
        self.embed_pose = nn.Linear(d.pose_dim, C2)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(C2, 3 * C2))
        self.pose_branch = Mlp(C2, C2 // 2, d.pose_dim)

    def forward(self, last):
        """The last layer (S, L, 2C) -> the pose encodings (S, 9) of the
        last iteration; the trunk attends across the frames' camera
        tokens."""
        tokens = self.token_norm(last[:, 0])[None]
        pred = None
        for _ in range(self.d.camera_iterations):
            cond = self.empty_pose_tokens.expand(1, tokens.shape[1], -1) if pred is None else pred
            shift, scale, gate = self.poseLN_modulation(self.embed_pose(cond)).chunk(3, dim=-1)
            normed = F.layer_norm(tokens, (tokens.shape[-1],), eps=1e-5)
            x = gate * (normed * (1 + scale) + shift) + tokens
            for blk in self.trunk:
                x = blk(x)
            delta = self.pose_branch(self.trunk_norm(x))
            pred = delta if pred is None else pred + delta
        return pred[0]


def pose_to_cameras(enc: torch.Tensor, hw) -> tuple:
    """Pose encodings (S, 9) -> (extrinsic (S, 3, 4) world to camera,
    intrinsic (S, 3, 3)) for images of size hw."""
    H, W = hw
    i, j, k, r = enc[:, 3:7].unbind(-1)
    two_s = 2.0 / (enc[:, 3:7] * enc[:, 3:7]).sum(-1)
    R = torch.stack([1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
                     two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
                     two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j)],
                    dim=-1).reshape(-1, 3, 3)
    extri = torch.cat([R, enc[:, :3, None]], dim=-1)
    K = torch.zeros(enc.shape[0], 3, 3, dtype=enc.dtype, device=enc.device)
    K[:, 0, 0] = (W / 2.0) / torch.tan(enc[:, 8] / 2.0)
    K[:, 1, 1] = (H / 2.0) / torch.tan(enc[:, 7] / 2.0)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2.0, H / 2.0, 1.0
    return extri, K


class ResidualConvUnit(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    def __init__(self, c: int, skip: bool):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(c)
        self.resConfUnit2 = ResidualConvUnit(c)
        self.out_conv = nn.Conv2d(c, c, 1)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        size = size or (2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(resize_aligned(x, *size))


class Scratch(nn.Module):
    def __init__(self, out_channels, features: int, conv1_out: int, output_dim):
        super().__init__()
        for i, c in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FusionBlock(features, skip=i != 4))
        self.output_conv1 = nn.Conv2d(features, conv1_out, 3, padding=1)
        if output_dim is not None:
            self.output_conv2 = nn.Sequential(nn.Conv2d(conv1_out, 32, 3, padding=1), nn.ReLU(),
                                              nn.Conv2d(32, output_dim, 1))


class DPTHead(nn.Module):
    """DPT over four aggregator layers: ``output_dim`` channels out, or the
    ``conv1_out`` features with ``output_dim`` None."""

    def __init__(self, d: Dims, features: int, output_dim, conv1_out=None):
        super().__init__()
        self.d = d
        oc = d.dpt_out_channels
        C2 = 2 * d.embed_dim
        self.norm = nn.LayerNorm(C2, eps=1e-5)
        self.projects = nn.ModuleList([nn.Conv2d(C2, c, 1) for c in oc])
        self.resize_layers = nn.ModuleList([nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
                                            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2), nn.Identity(),
                                            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = Scratch(oc, features, conv1_out or features // 2, output_dim)

    def forward(self, outs, start: int, hw, down: int = 1):
        """-> (S, C', H / down, W / down): the output convolutions' raw
        channels (or the features), at the patch grid's pixel size."""
        d = self.d
        gh, gw = hw[0] // d.patch_size, hw[1] // d.patch_size
        sc = self.scratch
        feats = []
        for k, li in enumerate(d.intermediate_layer_idx):
            x = self.norm(outs[li][:, start:])
            x = x.transpose(1, 2).reshape(x.shape[0], -1, gh, gw)
            x = self.resize_layers[k](self.projects[k](x))
            feats.append(getattr(sc, f"layer{k + 1}_rn")(x))
        x = sc.refinenet4(feats[3], size=feats[2].shape[2:])
        x = sc.refinenet3(x, feats[2], size=feats[1].shape[2:])
        x = sc.refinenet2(x, feats[1], size=feats[0].shape[2:])
        x = sc.refinenet1(x, feats[0])
        x = resize_aligned(sc.output_conv1(x), gh * d.patch_size // down, gw * d.patch_size // down)
        return x if not hasattr(sc, "output_conv2") else sc.output_conv2(x)


# ---------------------------------------------------------------------------
# track head
# ---------------------------------------------------------------------------


def grid_sample_px(img: torch.Tensor, xy: torch.Tensor, padding: str) -> torch.Tensor:
    """img (B, C, H, W) sampled bilinearly at pixel coordinates xy (B, P,
    Q, 2), corners aligned -> (B, C, P, Q)."""
    H, W = img.shape[2:]
    scale = torch.tensor([2.0 / max(W - 1, 1), 2.0 / max(H - 1, 1)], device=xy.device)
    return F.grid_sample(img, xy * scale - 1, mode="bilinear", padding_mode=padding, align_corners=True)


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (batch first)."""

    def __init__(self, E: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * E, E))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E))
        self.out_proj = nn.Linear(E, E)

    def forward(self, xq, xkv):
        E = xq.shape[-1]
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, E // self.heads)

        y = attend(split(F.linear(xq, wq, bq)), split(F.linear(xkv, wk, bk)), split(F.linear(xkv, wv, bv)))
        return self.out_proj(y.reshape(xq.shape))


class AttnBlock(nn.Module):
    def __init__(self, E: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(E, eps=1e-6)
        self.attn = MultiheadAttention(E, heads)
        self.norm2 = nn.LayerNorm(E, eps=1e-6)
        self.mlp = Mlp(E, 4 * E, E, tanh=True)

    def forward(self, x):
        y = self.norm1(x)
        x = x + self.attn(y, y)
        return x + self.mlp(self.norm2(x))


class CrossAttnBlock(nn.Module):
    def __init__(self, E: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(E, eps=1e-6)
        self.norm_context = nn.LayerNorm(E, eps=1e-5)
        self.cross_attn = MultiheadAttention(E, heads)
        self.norm2 = nn.LayerNorm(E, eps=1e-6)
        self.mlp = Mlp(E, 4 * E, E, tanh=True)

    def forward(self, x, context):
        x = x + self.cross_attn(self.norm1(x), self.norm_context(context))
        return x + self.mlp(self.norm2(x))


class UpdateFormer(nn.Module):
    def __init__(self, t: TrackDims):
        super().__init__()
        C, E = t.latent_dim, t.hidden_size
        self.input_transform = nn.Linear(3 * C + 4, E)
        self.flow_head = nn.Linear(E, C + 2)
        self.virual_tracks = nn.Parameter(torch.zeros(1, t.num_virtual_tracks, 1, E))
        self.time_blocks = nn.ModuleList([AttnBlock(E, t.num_heads) for _ in range(t.depth)])
        self.space_virtual_blocks = nn.ModuleList([AttnBlock(E, t.num_heads) for _ in range(t.depth)])
        self.space_point2virtual_blocks = nn.ModuleList([CrossAttnBlock(E, t.num_heads) for _ in range(t.depth)])
        self.space_virtual2point_blocks = nn.ModuleList([CrossAttnBlock(E, t.num_heads) for _ in range(t.depth)])

    def forward(self, x):
        """x (N, S, 3C + 4) -> (N, S, C + 2). Each time block attends along
        the frames of each track (virtual ones included); after it, per
        frame, the virtual tracks attend to the points, then to each other,
        and the points attend to the virtual tracks."""
        first = self.input_transform(x)
        N, S, _ = first.shape
        virtual = self.virual_tracks[0, :, 0][:, None].expand(-1, S, -1)
        tokens = torch.cat([first, virtual], dim=0)
        for i in range(len(self.time_blocks)):
            tokens = self.time_blocks[i](tokens)
            space = tokens.transpose(0, 1)
            points, virt = space[:, :N], space[:, N:]
            virt = self.space_virtual2point_blocks[i](virt, points)
            virt = self.space_virtual_blocks[i](virt)
            points = self.space_point2virtual_blocks[i](points, virt)
            tokens = torch.cat([points, virt], dim=1).transpose(0, 1)
        return self.flow_head(tokens[:N] + first)


def sincos_2d(xy: torch.Tensor, C: int) -> torch.Tensor:
    """For x, then y: C channels, sin at even and cos at odd positions of
    coordinate * k * 1000 / C, k = 0, 2, 4, ..."""
    div = torch.arange(0, C, 2, dtype=torch.float32, device=xy.device) * (1000.0 / C)
    out = []
    for axis in range(2):
        ang = xy[..., axis:axis + 1] * div
        pe = torch.zeros(ang.shape[:-1] + (C,), device=xy.device)
        pe[..., 0::2], pe[..., 1::2] = torch.sin(ang), torch.cos(ang)
        out.append(pe)
    return torch.cat(out, dim=-1)


class Tracker(nn.Module):
    def __init__(self, t: TrackDims):
        super().__init__()
        C = t.latent_dim
        self.t = t
        self.fmap_norm = nn.LayerNorm(C, eps=1e-5)
        self.corr_mlp = Mlp(t.corr_levels * (2 * t.corr_radius + 1) ** 2, t.hidden_size, C, tanh=True)
        self.updateformer = UpdateFormer(t)
        self.ffeat_norm = nn.GroupNorm(1, C)
        self.ffeat_updater = nn.Sequential(nn.Linear(C, C), nn.GELU())
        self.vis_predictor = nn.Sequential(nn.Linear(C, 1))
        self.conf_predictor = nn.Sequential(nn.Linear(C, 1))

    def forward(self, fmaps, queries):
        """fmaps (S, C, Hf, Wf); queries (N, 2) pixel xy of frame 0 ->
        (tracks (S, N, 2) in pixels after the last iteration, vis (S, N),
        conf (S, N))."""
        t = self.t
        S, C = fmaps.shape[:2]
        N = queries.shape[0]
        fmaps = self.fmap_norm(fmaps.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        q = queries / float(t.stride)
        feat = grid_sample_px(fmaps[:1], q[None, None], "border")[0, :, 0].T  # (N, C)
        coords = q[None].expand(S, N, 2)
        feats = feat[None].expand(S, N, C)
        pyramid = [fmaps]
        for _ in range(t.corr_levels - 1):
            pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
        r = t.corr_radius
        lin = torch.linspace(-r, r, 2 * r + 1, device=fmaps.device)
        dy, dx = torch.meshgrid(lin, lin, indexing="ij")
        delta = torch.stack([dy, dx], dim=-1).reshape(1, -1, 2)  # added to (x, y) as published
        for _ in range(t.iters):
            corrs = []
            for lvl, fm in enumerate(pyramid):
                h, w = fm.shape[2:]
                cmap = torch.matmul(feats, fm.reshape(S, C, h * w)) / math.sqrt(C)  # (S, N, h*w)
                at = (coords / 2**lvl).reshape(S * N, 1, 2) + delta
                sampled = grid_sample_px(cmap.reshape(S * N, 1, h, w), at[:, None], "zeros")
                corrs.append(sampled.reshape(S, N, -1))
            corr = self.corr_mlp(torch.cat(corrs, dim=-1).transpose(0, 1))  # (N, S, C)
            flows = (coords - coords[:1]).transpose(0, 1)
            emb = torch.cat([sincos_2d(flows, C // 2), flows / t.max_scale, flows / t.max_scale], dim=-1)
            track = feats.transpose(0, 1)
            delta_out = self.updateformer(torch.cat([emb, corr, track], dim=-1))
            upd = self.ffeat_updater(self.ffeat_norm(delta_out[..., 2:].reshape(N * S, C))).reshape(N, S, C)
            feats = (track + upd).transpose(0, 1)
            coords = coords + delta_out[..., :2].transpose(0, 1)
        vis = torch.sigmoid(self.vis_predictor(feats)[..., 0])
        conf = torch.sigmoid(self.conf_predictor(feats)[..., 0])
        return coords * t.stride, vis, conf


class TrackHead(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        self.feature_extractor = DPTHead(d, d.track.dpt_features, None, conv1_out=d.track.latent_dim)
        self.tracker = Tracker(d.track)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class VGGT(nn.Module):
    """The public layout: ``aggregator``, ``camera_head``, ``depth_head``,
    ``point_head``, ``track_head``."""

    def __init__(self, d: Dims = Dims()):
        super().__init__()
        self.d = d
        self.aggregator = Aggregator(d)
        self.camera_head = CameraHead(d)
        self.depth_head = DPTHead(d, d.dpt_features, 2)
        self.point_head = DPTHead(d, d.dpt_features, 4)
        self.track_head = TrackHead(d)

    def products(self, images: torch.Tensor) -> dict:
        """images (S, 3, H, W) in [0, 1] -> pose encodings (S, 9),
        extrinsic, intrinsic, depth (S, H', W') and its confidence, H' and
        W' the patch grid's pixels."""
        hw = images.shape[2:]
        outs, start = self.aggregator(images)
        enc = self.camera_head(outs[-1])
        extri, intri = pose_to_cameras(enc, hw)
        raw = self.depth_head(outs, start, hw)
        return {"pose_enc": enc, "extrinsic": extri, "intrinsic": intri, "depth": torch.exp(raw[:, 0]),
                "depth_conf": 1 + torch.exp(raw[:, 1])}

    def tracks(self, images: torch.Tensor, queries: torch.Tensor) -> dict:
        """Track queries (N, 2), pixel xy of frame 0, through every frame:
        tracks (S, N, 2), vis (S, N), conf (S, N)."""
        outs, start = self.aggregator(images)
        fmaps = self.track_head.feature_extractor(outs, start, images.shape[2:], down=self.d.track.stride)
        tracks, vis, conf = self.track_head.tracker(fmaps, queries)
        return {"tracks": tracks, "vis": vis, "conf": conf}


def load(path: str, d: Dims, device) -> VGGT:
    """The reference with the checkpoint at ``path`` (a public-layout
    state_dict), every key present, on ``device``."""
    with torch.device("meta"):
        net = VGGT(d)
    sd = torch.load(path, map_location=device, weights_only=True)
    net.load_state_dict(sd, assign=True, strict=True)
    return net.eval().requires_grad_(False)


def run(net: VGGT, images, queries, tf32: bool = False) -> dict:
    """The products and the tracks of images (S, H, W, 3) in [0, 1] with
    the query points (N, 2), as numpy; ``tf32`` for the control."""
    dev = next(net.parameters()).device
    x = torch.as_tensor(images, dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
    qp = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    with torch.no_grad(), precision(tf32):
        out = net.products(x)
        out.update(net.tracks(x, qp))
    return {k: v.cpu().numpy() for k, v in out.items()}
