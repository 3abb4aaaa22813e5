"""Compact detector-free dense matcher (LoFTR-class).

Port of gtsfm_tpu/frontend/matchers/dense_matcher.py: a shared conv encoder
gives 1/8-resolution features for both images, ``num_blocks`` rounds of
self and cross linear attention (elu + 1 feature maps) contextualize them,
and coarse matches come from a dual-softmax correlation at temperature 0.1
with mutual-max selection and a threshold, at the cell centres. The
``loftr_compact`` correspondence generator. The state_dict's keys follow
the reference's flax module names (``encoder.c1``, ``self1_0.q``, ...);
``utils/convert.dense_matcher_state_dict`` carries the reference's params
across. Without a state_dict the net keeps a random init of seed 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.frontend.detectors.dog_sift import stable_topk
from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import _same_pad
from gtsfm_tpu_torch.utils.numerics import precise


class DenseMatcherOptions(NamedTuple):
    dim: int = 128
    num_blocks: int = 2
    stride: int = 8
    match_threshold: float = 0.2
    max_matches: int = 1024


class _ConvEncoder(nn.Module):
    """(B, 1, H, W) -> (B, dim, H/8, W/8): three stride-2 3x3 convs with
    ReLU and a 3x3 conv, each zero-padded as XLA's "SAME"."""

    def __init__(self, dim: int):
        super().__init__()
        self.c1 = nn.Conv2d(1, dim // 4, 3, stride=2)
        self.c2 = nn.Conv2d(dim // 4, dim // 2, 3, stride=2)
        self.c3 = nn.Conv2d(dim // 2, dim, 3, stride=2)
        self.c4 = nn.Conv2d(dim, dim, 3)

    def forward(self, x):
        for conv in (self.c1, self.c2, self.c3):
            x = F.relu(conv(_same_pad(x, 3, 2)))
        return self.c4(_same_pad(x, 3, 1))


class _LinearAttnBlock(nn.Module):
    """q_in + proj(linear attention of q_in over kv_in), tokens (N, d)."""

    def __init__(self, dim: int):
        super().__init__()
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in):
        qf = F.elu(self.q(q_in)) + 1.0
        kf = F.elu(self.k(kv_in)) + 1.0
        kv = kf.T @ self.v(kv_in)
        z = qf @ kf.sum(dim=0) + 1e-6
        return q_in + self.proj((qf @ kv) / z[:, None])


class DenseMatcherNet(nn.Module):
    def __init__(self, opts: DenseMatcherOptions):
        super().__init__()
        self.opts = opts
        d = opts.dim
        self.encoder = _ConvEncoder(d)
        for i in range(opts.num_blocks):
            for name in ("self1", "self2", "cross1", "cross2"):
                self.add_module(f"{name}_{i}", _LinearAttnBlock(d))

    def forward(self, img1, img2):
        """img (H, W) each -> (the (h*w, h*w) correlation over the
        temperature, (h, w))."""
        f1 = self.encoder(img1[None, None])[0]
        f2 = self.encoder(img2[None, None])[0]
        d, h, w = f1.shape
        t1 = f1.reshape(d, h * w).T
        t2 = f2.reshape(d, h * w).T
        for i in range(self.opts.num_blocks):
            blk = {name: getattr(self, f"{name}_{i}") for name in ("self1", "self2", "cross1", "cross2")}
            t1 = blk["self1"](t1, t1)
            t2 = blk["self2"](t2, t2)
            t1n = blk["cross1"](t1, t2)
            t2 = blk["cross2"](t2, t1)
            t1 = t1n
        t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-9)
        t2 = t2 / torch.clamp(torch.linalg.vector_norm(t2, dim=-1, keepdim=True), min=1e-9)
        return (t1 @ t2.T) / 0.1, (h, w)


class DenseImageMatcher:
    """match_images(img1, img2) -> (uv1 (M, 2), uv2 (M, 2), scores (M,),
    mask (M,)): per-pair correspondences in pixels, padded to
    ``max_matches``, on the device of the images."""

    def __init__(self, options: DenseMatcherOptions = DenseMatcherOptions(), state_dict=None):
        self.options = options
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.net = DenseMatcherNet(options)
        if state_dict is not None:
            self.net.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        self.net.eval().requires_grad_(False)

    def match_images(self, img1: torch.Tensor, img2: torch.Tensor):
        o = self.options
        self.net.to(img1.device)
        with torch.no_grad(), precise():
            corr, (h, w) = self.net(img1, img2)
            conf = torch.softmax(corr, dim=1) * torch.softmax(corr, dim=0)
            nn12 = torch.argmax(conf, dim=1)
            nn21 = torch.argmax(conf, dim=0)
            mutual = torch.arange(h * w, device=conf.device) == nn21[nn12]
            score = torch.amax(conf, dim=1)
            ok = mutual & (score > o.match_threshold)
            sel_score, sel = stable_topk(torch.where(ok, score, -1.0), min(o.max_matches, h * w))
            tgt = nn12[sel]
            s = float(o.stride)
            uv1 = torch.stack([sel % w, sel // w], -1).to(torch.float32) * s + s / 2
            uv2 = torch.stack([tgt % w, tgt // w], -1).to(torch.float32) * s + s / 2
        return uv1, uv2, sel_score, sel_score > 0
