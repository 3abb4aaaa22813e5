"""LoFTR, the detector-free matcher, in the public checkpoints' layout.

Port of gtsfm_tpu/frontend/matchers/loftr.py (the released "ds"
dual-softmax models, kornia's LoFTR; Sun et al., CVPR 2021), with the
module names of the official ``outdoor_ds.ckpt`` / ``indoor_ds_new.ckpt``
state_dicts:

- backbone: ResNetFPN_8_2 (a 7x7 stride-2 conv, three stages of two
  BasicBlocks, 1/8 coarse 256-d features and an FPN top-down path to 1/2
  fine 128-d ones), BatchNorm applied folded to a scale and a shift, as
  the reference folds it;
- the sine positional encoding on the coarse features, with the
  historical divisor the released models were trained with
  (``temp_bug_fix=False``);
- loftr_coarse: 8 alternating self and cross layers of linear attention
  (elu + 1 feature maps, values normalized by their length, eps 1e-6),
  bias-free projections, LayerNorm and a concat MLP;
- coarse matching: the 1/sqrt(c)-scaled dual-softmax correlation at
  temperature 0.1, mutual maximum, threshold and border removal, the best
  ``max_matches`` rows kept (equal scores lowest index first);
- fine: 5x5 windows of the fine features at each coarse match (zero
  outside the map), the coarse features' concat path (down_proj,
  merge_feat), the fine transformer over each window's 25 tokens, and the
  spatial expectation of the centre's correlation softmax, which refines
  image 2's coordinates.

One pair at a time, float32 with TF32 off (``precise``). ``load_torch_weights``
reads an official checkpoint (the ``matcher.`` prefix of the training
checkpoints stripped); ``utils/convert.loftr_state_dict`` carries the
reference's params across.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.frontend.detectors.dog_sift import stable_topk
from gtsfm_tpu_torch.utils.numerics import precise
from gtsfm_tpu_torch.utils.torch_io import load_public_state_dict, load_torch_checkpoint


class LoFTROptions(NamedTuple):
    d_coarse: int = 256
    d_fine: int = 128
    nhead: int = 8
    initial_dim: int = 128
    block_dims: tuple = (128, 196, 256)
    coarse_layer_names: tuple = ("self", "cross") * 4
    fine_layer_names: tuple = ("self", "cross")
    fine_window_size: int = 5
    fine_concat_coarse_feat: bool = True
    match_threshold: float = 0.2
    dual_softmax_temperature: float = 0.1
    border_rm: int = 2
    # the released checkpoints were trained with the historical positional-
    # encoding divisor; True selects the corrected formula
    temp_bug_fix: bool = False
    max_matches: int = 1024


class FoldedBatchNorm2d(nn.BatchNorm2d):
    """Eval-mode BatchNorm as the reference applies it: x * scale + shift
    with scale = weight / sqrt(var + eps), shift = bias - mean * scale."""

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


def _conv1x1(i, o, stride=1):
    return nn.Conv2d(i, o, 1, stride=stride, bias=False)


def _conv3x3(i, o, stride=1):
    return nn.Conv2d(i, o, 3, stride=stride, padding=1, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv3x3(in_planes, planes, stride)
        self.conv2 = _conv3x3(planes, planes)
        self.bn1 = FoldedBatchNorm2d(planes)
        self.bn2 = FoldedBatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(_conv1x1(in_planes, planes, stride), FoldedBatchNorm2d(planes))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNetFPN_8_2(nn.Module):
    """(B, 1, H, W) -> ((B, 256, H/8, W/8), (B, 128, H/2, W/2))."""

    def __init__(self, initial_dim: int = 128, block_dims: tuple = (128, 196, 256)):
        super().__init__()
        d1, d2, d3 = block_dims
        self.conv1 = nn.Conv2d(1, initial_dim, 7, stride=2, padding=3, bias=False)
        self.bn1 = FoldedBatchNorm2d(initial_dim)
        self.layer1 = nn.Sequential(BasicBlock(initial_dim, d1, 1), BasicBlock(d1, d1, 1))
        self.layer2 = nn.Sequential(BasicBlock(d1, d2, 2), BasicBlock(d2, d2, 1))
        self.layer3 = nn.Sequential(BasicBlock(d2, d3, 2), BasicBlock(d3, d3, 1))
        self.layer3_outconv = _conv1x1(d3, d3)
        self.layer2_outconv = _conv1x1(d2, d3)
        self.layer2_outconv2 = nn.Sequential(_conv3x3(d3, d3), FoldedBatchNorm2d(d3), nn.LeakyReLU(),
                                             _conv3x3(d3, d2))
        self.layer1_outconv = _conv1x1(d1, d2)
        self.layer1_outconv2 = nn.Sequential(_conv3x3(d2, d2), FoldedBatchNorm2d(d2), nn.LeakyReLU(),
                                             _conv3x3(d2, d1))

    def forward(self, x):
        x0 = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x3_out = self.layer3_outconv(x3)
        x3_2x = F.interpolate(x3_out, scale_factor=2.0, mode="bilinear", align_corners=True)
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2) + x3_2x)
        x2_2x = F.interpolate(x2_out, scale_factor=2.0, mode="bilinear", align_corners=True)
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1) + x2_2x)
        return x3_out, x1_out


def position_encoding_sine(h: int, w: int, d_model: int, temp_bug_fix: bool) -> np.ndarray:
    """The sine positional encoding, (h, w, d_model), 1-indexed positions."""
    pe = np.zeros((d_model, h, w), np.float32)
    y_pos = np.cumsum(np.ones((h, w), np.float32), axis=0)[None]
    x_pos = np.cumsum(np.ones((h, w), np.float32), axis=1)[None]
    ar = np.arange(0, d_model // 2, 2, dtype=np.float32)
    if temp_bug_fix:
        div = np.exp(ar * (-math.log(10000.0) / (d_model // 2)))
    else:  # the historical divisor the released models were trained with
        div = np.exp(ar * (-math.log(10000.0) / d_model // 2))
    div = div[:, None, None]
    pe[0::4] = np.sin(x_pos * div)
    pe[1::4] = np.cos(x_pos * div)
    pe[2::4] = np.sin(y_pos * div)
    pe[3::4] = np.cos(y_pos * div)
    return pe.transpose(1, 2, 0)


def linear_attention(q, k, v, eps: float = 1e-6):
    """LoFTR's linear attention on (B, L, h, d) tokens."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    L_v = v.shape[1]
    KV = torch.einsum("bshd,bshv->bhdv", K, v / L_v)
    Z = 1.0 / (torch.einsum("blhd,bhd->blh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("blhd,bhdv->blhv", Q, KV) * Z[..., None] * L_v


class LoFTREncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * d_model, 2 * d_model, bias=False), nn.ReLU(),
                                 nn.Linear(2 * d_model, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x, source):
        B, L, d = x.shape
        h = self.nhead
        q = self.q_proj(x).view(B, L, h, d // h)
        k = self.k_proj(source).view(B, source.shape[1], h, d // h)
        v = self.v_proj(source).view(B, source.shape[1], h, d // h)
        m = self.norm1(self.merge(linear_attention(q, k, v).reshape(B, L, d)))
        return x + self.norm2(self.mlp(torch.cat([x, m], dim=-1)))


class LocalFeatureTransformer(nn.Module):
    def __init__(self, d_model: int, nhead: int, layer_names: tuple):
        super().__init__()
        self.names = tuple(layer_names)
        self.layers = nn.ModuleList([LoFTREncoderLayer(d_model, nhead) for _ in layer_names])

    def forward(self, feat0, feat1):
        for layer, name in zip(self.layers, self.names):
            if name == "self":
                feat0, feat1 = layer(feat0, feat0), layer(feat1, feat1)
            else:
                feat0, feat1 = layer(feat0, feat1), layer(feat1, feat0)
        return feat0, feat1


class LoFTRNet(nn.Module):
    def __init__(self, opts: LoFTROptions = LoFTROptions()):
        super().__init__()
        self.opts = opts
        self.backbone = ResNetFPN_8_2(opts.initial_dim, opts.block_dims)
        self.loftr_coarse = LocalFeatureTransformer(opts.d_coarse, opts.nhead, opts.coarse_layer_names)
        if opts.fine_concat_coarse_feat:
            self.fine_preprocess = nn.Module()
            self.fine_preprocess.down_proj = nn.Linear(opts.d_coarse, opts.d_fine)
            self.fine_preprocess.merge_feat = nn.Linear(2 * opts.d_fine, opts.d_fine)
        self.loftr_fine = LocalFeatureTransformer(opts.d_fine, opts.nhead, opts.fine_layer_names)

    def coarse_forward(self, img0, img1):
        """img (H, W) -> (fc0, ff0, fc1, ff1 as (h, w, c), t0, t1 (L, c)
        coarse tokens after the transformer, conf (L, L))."""
        o = self.opts
        fc0, ff0 = (a[0].permute(1, 2, 0) for a in self.backbone(img0[None, None]))
        fc1, ff1 = (a[0].permute(1, 2, 0) for a in self.backbone(img1[None, None]))
        hc, wc, dc = fc0.shape
        pe = torch.as_tensor(position_encoding_sine(hc, wc, dc, o.temp_bug_fix), device=fc0.device)
        t0, t1 = self.loftr_coarse((fc0 + pe).reshape(1, hc * wc, dc), (fc1 + pe).reshape(1, hc * wc, dc))
        t0, t1 = t0[0], t1[0]
        sim = (t0 / dc**0.5) @ (t1 / dc**0.5).T / o.dual_softmax_temperature
        conf = torch.softmax(sim, dim=0) * torch.softmax(sim, dim=1)
        return fc0, ff0, fc1, ff1, t0, t1, conf

    def fine_forward(self, ff0, ff1, t0, t1, i_ids, j_ids, wc: int):
        """The 5x5 fine-window refinement at the coarse matches (i_ids,
        j_ids) -> expectation offsets in [-1, 1], (M, 2)."""
        o = self.opts
        W = o.fine_window_size
        rad = W // 2
        M = i_ids.shape[0]
        off = torch.arange(-rad, rad + 1, device=ff0.device)
        oy, ox = torch.meshgrid(off, off, indexing="ij")

        def windows(feat, ids):
            hf, wf, _ = feat.shape
            padded = F.pad(feat, (0, 0, rad, rad, rad, rad))
            yy = (ids // wc * 4)[:, None] + oy.reshape(-1)[None, :] + rad
            xx = (ids % wc * 4)[:, None] + ox.reshape(-1)[None, :] + rad
            return padded[yy.clamp(0, hf + 2 * rad - 1), xx.clamp(0, wf + 2 * rad - 1)]

        w0, w1 = windows(ff0, i_ids), windows(ff1, j_ids)
        if o.fine_concat_coarse_feat:
            c_win = self.fine_preprocess.down_proj(torch.cat([t0[i_ids], t1[j_ids]], dim=0))
            f_cat = torch.cat([w0, w1], dim=0)
            f_cat = self.fine_preprocess.merge_feat(torch.cat([f_cat, c_win[:, None, :].expand_as(f_cat)], dim=-1))
            w0, w1 = f_cat[:M], f_cat[M:]
        w0, w1 = self.loftr_fine(w0, w1)
        df = w0.shape[-1]
        center = w0[:, W * W // 2, :]
        heat = torch.softmax(torch.einsum("mc,mrc->mr", center, w1) / df**0.5, dim=1)
        grid = torch.linspace(-1.0, 1.0, W, device=ff0.device)
        gy, gx = torch.meshgrid(grid, grid, indexing="ij")
        return torch.stack([(heat * gx.reshape(-1)).sum(dim=1), (heat * gy.reshape(-1)).sum(dim=1)], dim=-1)

    def forward(self, img0, img1):
        """img (H, W) gray in [0, 1], H and W multiples of 8 -> (uv0 (M, 2),
        uv1 (M, 2) refined, conf (M,), mask (M,))."""
        o = self.opts
        fc0, ff0, fc1, ff1, t0, t1, conf = self.coarse_forward(img0, img1)
        hc, wc, _ = fc0.shape
        b = o.border_rm
        r = torch.arange(hc * wc, device=conf.device)
        row, col = r // wc, r % wc
        inner = (row >= b) & (row < hc - b) & (col >= b) & (col < wc - b)
        conf = torch.where(inner[:, None] & inner[None, :], conf, 0.0)
        mutual = (conf == torch.amax(conf, dim=1, keepdim=True)) & (conf == torch.amax(conf, dim=0, keepdim=True))
        score = torch.where(mutual & (conf > o.match_threshold), conf, 0.0)
        row_best = torch.amax(score, dim=1)
        row_idx = torch.argmax(score, dim=1)
        msel, i_ids = stable_topk(row_best, min(o.max_matches, hc * wc))
        j_ids = row_idx[i_ids]
        uv0 = torch.stack([i_ids % wc, i_ids // wc], dim=-1).to(torch.float32) * 8.0
        uv1c = torch.stack([j_ids % wc, j_ids // wc], dim=-1).to(torch.float32) * 8.0
        off = self.fine_forward(ff0, ff1, t0, t1, i_ids, j_ids, wc)
        return uv0, uv1c + off * (o.fine_window_size // 2) * 2.0, msel, msel > 0


class LoFTRMatcher:
    """The dense-matcher contract: match_images(img1, img2) -> (uv1 (M, 2),
    uv2 (M, 2), scores (M,), mask (M,)) in pixels, on the images' device.
    ``state_dict`` is an official-layout state_dict; without one the net
    keeps a random init of seed 0."""

    def __init__(self, options: LoFTROptions = LoFTROptions(), state_dict=None):
        self.options = options
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.net = LoFTRNet(options)
        if state_dict is not None:
            load_public_state_dict(self.net, state_dict)
        self.net.eval().requires_grad_(False)

    def match_images(self, img1: torch.Tensor, img2: torch.Tensor):
        """Both images cropped to img1's multiple of 8; 0-255 input (a
        maximum above 2) scaled to [0, 1]."""
        h = (img1.shape[0] // 8) * 8
        w = (img1.shape[1] // 8) * 8
        scale = 1.0 / 255.0 if float(img1.max()) > 2.0 else 1.0
        self.net.to(img1.device)
        with torch.no_grad(), precise():
            return self.net(img1[:h, :w] * scale, img2[:h, :w] * scale)


def load_torch_weights(path: str) -> dict:
    """An official LoFTR checkpoint (outdoor_ds.ckpt, indoor_ds_new.ckpt) ->
    its state_dict, the training checkpoints' ``matcher.`` prefix removed."""
    ckpt = load_torch_checkpoint(path)
    sd = ckpt.get("state_dict", ckpt)
    if any(k.startswith("matcher.") for k in sd):
        sd = {k[len("matcher."):]: v for k, v in sd.items() if k.startswith("matcher.")}
    return sd
