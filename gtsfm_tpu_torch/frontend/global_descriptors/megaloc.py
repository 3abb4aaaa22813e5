"""MegaLoc global descriptor: DINOv2 ViT-B/14 and SALAD aggregation.

Port of gtsfm_tpu/frontend/global_descriptors/megaloc.py ("MegaLoc: One
Retrieval to Place Them All", arXiv:2502.17237), an ``nn.Module`` whose
state_dict keys are the public megaloc.torch's (``backbone.model.*``,
``aggregator.agg.*``, ``aggregator.linear.*``), so the checkpoint loads
with ``load_state_dict``:

  backbone    DINOv2 ViT-B/14 (768-d, 12 heads, 12 blocks, LayerScale,
              pretrain grid 37x37, bicubic position-embedding
              interpolation with offset 0.1)
  aggregator  SALAD: per-patch cluster features and cluster scores (1x1
              conv MLPs), a global-token MLP, a log-domain Sinkhorn with a
              learned dustbin (3 iterations), mass-weighted pooling,
              per-cluster L2; the token prepended
  head        Linear 16640 -> 8448 and a final L2 norm

Preprocessing as the reference wrapper's: the image resized to 322x322 by
``jax.image.resize``'s bilinear rule, which antialiases when it
downsamples (``F.interpolate(..., antialias=True)``), then ImageNet
normalization. GELU is exact, LayerNorm's epsilon 1e-6. The net runs in
float32 under ``precise()``; without weights it keeps a random init drawn
from seed 0 (the reference's ``init_params`` scales).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.utils.numerics import precise


class MegaLocOptions(NamedTuple):
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    patch_size: int = 14
    pretrain_grid: int = 37  # 518 / 14
    num_clusters: int = 64
    cluster_dim: int = 256
    token_dim: int = 256
    mlp_dim: int = 512
    feat_dim: int = 8448
    image_size: int = 322  # resized input (a multiple of 14)


LN_EPS = 1e-6
POS_OFFSET = 0.1  # DINOv2's interpolate_offset
SINKHORN_ITERS = 3
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_h: int, grid_w: int, offset: float = POS_OFFSET):
    """DINOv2's interpolate_pos_encoding: pos_embed (1, 1 + M*M, D) -> (the
    class token's (1, 1, D), the patches' (1, grid_h*grid_w, D)) resampled
    bicubically (a = -0.75, half-pixel) at scale (g + offset) / M."""
    D = pos_embed.shape[-1]
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    M = int(round(math.sqrt(patch_pe.shape[1])))
    if (grid_h, grid_w) == (M, M):
        return cls_pe, patch_pe
    grid = patch_pe.reshape(1, M, M, D).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((grid_h + offset) / M, (grid_w + offset) / M), mode="bicubic",
                         align_corners=False)
    if grid.shape[-2:] != (grid_h, grid_w):
        raise ValueError(f"position embedding resampled to {tuple(grid.shape[-2:])}, not {(grid_h, grid_w)}")
    return cls_pe, grid.permute(0, 2, 3, 1).reshape(1, grid_h * grid_w, D)


class _Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, h, D // h).unbind(2)  # (B, N, h, d)
        att = torch.einsum("bnhd,bmhd->bhnm", q * (D // h) ** -0.5, k)
        y = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(att, dim=-1), v).reshape(B, N, D)
        return self.proj(y)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class _Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim, num_heads)
        self.ls1 = _LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, mlp_ratio * dim)
        self.ls2 = _LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1.gamma * self.attn(self.norm1(x))
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoViT(nn.Module):
    """DINOv2 ViT with the hub module's key names."""

    def __init__(self, opts: MegaLocOptions):
        super().__init__()
        D, M = opts.embed_dim, opts.pretrain_grid
        self.patch_size = opts.patch_size
        self.cls_token = nn.Parameter(torch.randn(1, 1, D) * 0.02)
        self.pos_embed = nn.Parameter(torch.randn(1, 1 + M * M, D) * 0.02)
        self.patch_embed = _PatchEmbed(opts.patch_size, D)
        self.blocks = nn.ModuleList([_Block(D, opts.num_heads, opts.mlp_ratio) for _ in range(opts.depth)])
        self.norm = nn.LayerNorm(D, eps=LN_EPS)

    def forward(self, images: torch.Tensor):
        """images (B, 3, H, W), ImageNet-normalized, H and W multiples of
        the patch -> (normalized patch tokens (B, h*w, D), row-major;
        normalized class token (B, D))."""
        B, _, H, W = images.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = self.patch_embed.proj(images).flatten(2).transpose(1, 2)
        cls_pe, patch_pe = interpolate_pos_embed(self.pos_embed, gh, gw)
        x = torch.cat([(self.cls_token + cls_pe).expand(B, -1, -1), x + patch_pe], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 1:], x[:, 0]


class _Backbone(nn.Module):
    def __init__(self, opts: MegaLocOptions):
        super().__init__()
        self.model = DinoViT(opts)


def _conv_mlp(cin: int, mid: int, cout: int) -> nn.Sequential:
    # the checkpoint's (conv, dropout, relu, conv): keys .0 and .3
    return nn.Sequential(nn.Conv2d(cin, mid, 1), nn.Identity(), nn.ReLU(), nn.Conv2d(mid, cout, 1))


def _log_otp_solver(log_a, log_b, M, num_iters: int = SINKHORN_ITERS):
    """Sinkhorn in log space (reg 1); M: (B, m+1, n)."""
    u, v = torch.zeros_like(log_a), torch.zeros_like(log_b)
    for _ in range(num_iters):
        u = log_a - torch.logsumexp(M + v[:, None, :], dim=2)
        v = log_b - torch.logsumexp(M + u[:, :, None], dim=1)
    return M + u[:, :, None] + v[:, None, :]


def get_matching_probs(S: torch.Tensor, dustbin: torch.Tensor, num_iters: int = SINKHORN_ITERS):
    """S: (B, m, n) cluster scores -> log assignment (B, m+1, n), the last
    row the dustbin's."""
    B, m, n = S.shape
    S_aug = torch.cat([S, dustbin.reshape(1, 1, 1).expand(B, 1, n)], dim=1)
    norm = -math.log(n + m)
    log_a = torch.full((m + 1,), norm, device=S.device)
    log_a[-1] = log_a[-1] + math.log(n - m)
    log_b = torch.full((n,), norm, device=S.device)
    log_P = _log_otp_solver(log_a.expand(B, -1), log_b.expand(B, -1), S_aug, num_iters=num_iters)
    return log_P - norm


def _pointwise(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A (1x1 conv, -, relu, 1x1 conv) MLP applied to tokens (B, n, C)."""
    a, b = seq[0], seq[3]
    return F.linear(F.relu(F.linear(x, a.weight[:, :, 0, 0], a.bias)), b.weight[:, :, 0, 0], b.bias)


class SALAD(nn.Module):
    def __init__(self, opts: MegaLocOptions):
        super().__init__()
        D = opts.embed_dim
        self.token_features = nn.Sequential(nn.Linear(D, opts.mlp_dim), nn.ReLU(),
                                            nn.Linear(opts.mlp_dim, opts.token_dim))
        self.cluster_features = _conv_mlp(D, opts.mlp_dim, opts.cluster_dim)
        self.score = _conv_mlp(D, opts.mlp_dim, opts.num_clusters)
        self.dust_bin = nn.Parameter(torch.tensor(1.0))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x: patch tokens (B, n, C), t: class token (B, C) -> (B, g + l*m)."""
        B = x.shape[0]
        f = _pointwise(self.cluster_features, x)  # (B, n, l)
        p = torch.exp(get_matching_probs(_pointwise(self.score, x).transpose(1, 2), self.dust_bin))[:, :-1]
        agg = F.normalize(torch.einsum("bnl,bmn->blm", f, p), dim=1, eps=1e-12).reshape(B, -1)  # (l, m) order
        out = torch.cat([F.normalize(self.token_features(t), dim=-1, eps=1e-12), agg], dim=-1)
        return F.normalize(out, dim=-1, eps=1e-12)


class _Aggregator(nn.Module):
    def __init__(self, opts: MegaLocOptions):
        super().__init__()
        self.agg = SALAD(opts)
        self.linear = nn.Linear(opts.num_clusters * opts.cluster_dim + opts.token_dim, opts.feat_dim)


class MegaLocNet(nn.Module):
    def __init__(self, opts: MegaLocOptions = MegaLocOptions()):
        super().__init__()
        self.backbone = _Backbone(opts)
        self.aggregator = _Aggregator(opts)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, 3, H, W) ImageNet-normalized -> (B, feat_dim) unit rows."""
        patch, cls = self.backbone.model(images)
        y = self.aggregator.linear(self.aggregator.agg(patch, cls))
        return F.normalize(y, dim=-1, eps=1e-12)


def init_net(opts: MegaLocOptions) -> MegaLocNet:
    """The net with the reference's ``init_params`` scales (linear and 1x1
    weights N(0, 1/fan_in), biases 0, norms and layer scales 1, patch
    kernel, class token and position embedding N(0, 0.02^2), dustbin 1),
    drawn from torch's generator seeded with 0."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = MegaLocNet(opts)
        with torch.no_grad():
            for name, p in net.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif "norm" in name or name.endswith("gamma"):
                    p.fill_(1.0)
                elif name.endswith("patch_embed.proj.weight"):
                    p.normal_(0.0, 0.02)
                elif p.dim() >= 2 and not name.endswith(("cls_token", "pos_embed")):
                    p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()))
    return net


def load_torch_weights(path: str, opts: Optional[MegaLocOptions] = None):
    """The public megaloc.torch (or a reduced-dim state_dict of the same
    layout) -> (state_dict of float32 tensors, options with the dims read
    off the tensors' shapes)."""
    from gtsfm_tpu_torch.utils.torch_io import load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32) for k, v in sd.items()}
    return sd, options_from_state_dict(sd, opts or MegaLocOptions())


def options_from_state_dict(sd: dict, opts: MegaLocOptions = MegaLocOptions()) -> MegaLocOptions:
    """``opts`` with the dims a megaloc.torch-layout state_dict's shapes
    give (the heads as the reference infers them)."""
    pre, agg = "backbone.model.", "aggregator.agg."
    D = int(sd[pre + "cls_token"].shape[-1])
    head_dim = 64 if D % 64 == 0 else 16
    return opts._replace(
        embed_dim=D,
        depth=len({k.split(".")[3] for k in sd if k.startswith(pre + "blocks.")}),
        num_heads=opts.num_heads if D == opts.embed_dim else max(1, D // head_dim),
        patch_size=int(sd[pre + "patch_embed.proj.weight"].shape[-1]),
        pretrain_grid=int(round(math.sqrt(sd[pre + "pos_embed"].shape[1] - 1))),
        num_clusters=int(sd[agg + "score.3.bias"].shape[0]),
        cluster_dim=int(sd[agg + "cluster_features.3.bias"].shape[0]),
        token_dim=int(sd[agg + "token_features.2.bias"].shape[0]),
        mlp_dim=int(sd[agg + "token_features.0.bias"].shape[0]),
        feat_dim=int(sd["aggregator.linear.bias"].shape[0]),
    )


class MegaLocDescriptor:
    """describe_batch over MegaLoc. Images: (B, H, W) grayscale or (B, H,
    W, 3) RGB in [0, 1] (numpy, or a tensor on the device to run on),
    resized to image_size and ImageNet-normalized as the reference
    wrapper's preprocessing does.

    ``state_dict`` (megaloc.torch layout; its shapes set the dims), else
    ``weights_path``'s checkpoint, else the random init of seed 0 at
    ``options``' dims."""

    def __init__(self, options: MegaLocOptions = MegaLocOptions(), weights_path: Optional[str] = None,
                 state_dict: Optional[dict] = None):
        if state_dict is None and weights_path is not None:
            state_dict, options = load_torch_weights(weights_path, options)
        elif state_dict is not None:
            state_dict = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32) for k, v in state_dict.items()}
            options = options_from_state_dict(state_dict, options)
        self.options = options
        self.net = init_net(options)
        if state_dict is not None:
            self.net.load_state_dict(state_dict)
        self.net.eval().requires_grad_(False)

    def describe_batch(self, images) -> np.ndarray:
        x = torch.as_tensor(images, dtype=torch.float32)
        x = x[:, None].expand(-1, 3, -1, -1) if x.dim() == 3 else x.permute(0, 3, 1, 2)
        s = self.options.image_size
        if tuple(x.shape[-2:]) != (s, s):
            x = F.interpolate(x, size=(s, s), mode="bilinear", align_corners=False, antialias=True)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
        self.net.to(x.device)
        with torch.no_grad(), precise():
            return self.net((x - mean) / std).cpu().numpy()
