"""Global image descriptors for retrieval.

Port of gtsfm_tpu/frontend/global_descriptors/descriptors.py:

- ``TinyImageDescriptor``, weight-free: the image resized to res x res,
  mean-subtracted, L2-normalized;
- ``NetVLADDescriptor``: a small strided conv encoder and NetVLAD pooling
  (soft assignment to learned centres, intra-normalized residual sums, a
  projection). Flax pads its stride-2 "SAME" convolutions (0, 1) on an
  even input and (1, 1) on an odd one; ``_same_pad`` pads so, where
  torch's ``padding=1`` would pad (1, 1) always;
- ``HlocNetVLADDescriptor`` over ``NetVLADVGG16``: hloc's VGG16-NetVLAD
  (VGG16 cut at conv5_3, NetVLAD pooling, 4096-d whitening) in the public
  Pitts30K checkpoint's own layout (``backbone.N``, ``netvlad.score_proj``,
  ``netvlad.centers``, ``whiten``), so the checkpoint loads with
  ``load_state_dict``.

They feed the similarity and joint retrievers. The nets run in float32
under ``precise()`` (no TF32 in cuDNN's convolutions) on the device of the
images they are given; without weights each keeps a random init drawn from
seed 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.frontend.detectors.dog_sift import resize_linear
from gtsfm_tpu_torch.utils.numerics import precise


class TinyImageDescriptor:
    """Weight-free global descriptor: the image resized to res x res (the
    reference's antialiased linear resize), its mean subtracted, L2
    normalized."""

    def __init__(self, res: int = 32):
        self.res = res

    def describe_batch(self, images) -> np.ndarray:
        """(B, H, W) numpy, or a tensor on the device to run on -> (B,
        res * res) numpy."""
        images = torch.as_tensor(images, dtype=torch.float32)
        v = resize_linear(images, (self.res, self.res)).reshape(images.shape[0], -1)
        v = v - torch.mean(v, dim=-1, keepdim=True)
        return (v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)).cpu().numpy()


def _seeded(build):
    """``build()`` under torch's CPU generator seeded with 0, leaving the
    caller's generator as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return build()


def _run(net: nn.Module, x: torch.Tensor) -> np.ndarray:
    net.to(x.device)
    with torch.no_grad(), precise():
        return net(x).cpu().numpy()


# ---- the small NetVLAD ------------------------------------------------------


class NetVLADOptions(NamedTuple):
    num_clusters: int = 32
    encoder_dim: int = 128
    output_dim: int = 1024


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Zero-pad (B, C, H, W) as XLA's "SAME" does for a k x k window at
    stride s: the output is ceil(n / s) and the odd pixel goes high."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class NetVLADNet(nn.Module):
    """Three stride-2 3x3 convs (32, 64, 128), a 3x3 conv to encoder_dim,
    NetVLAD pooling over num_clusters centres, a projection to output_dim."""

    def __init__(self, opts: NetVLADOptions = NetVLADOptions()):
        super().__init__()
        self.opts = opts
        self.conv1 = nn.Conv2d(1, 32, 3, stride=2)
        self.conv2 = nn.Conv2d(32, 64, 3, stride=2)
        self.conv3 = nn.Conv2d(64, 128, 3, stride=2)
        self.conv4 = nn.Conv2d(128, opts.encoder_dim, 3)
        self.centers = nn.Parameter(torch.randn(opts.num_clusters, opts.encoder_dim) * 0.1)
        self.assign = nn.Linear(opts.encoder_dim, opts.num_clusters)
        self.proj = nn.Linear(opts.num_clusters * opts.encoder_dim, opts.output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 1, H, W) grayscale -> (B, output_dim) unit rows."""
        y = x
        for conv in (self.conv1, self.conv2, self.conv3):
            y = F.relu(conv(_same_pad(y, 3, 2)))
        y = self.conv4(_same_pad(y, 3, 1))
        B = y.shape[0]
        feats = F.normalize(y.flatten(2).transpose(1, 2), dim=-1, eps=1e-12)  # (B, h*w, D), row-major
        a = torch.softmax(self.assign(feats), dim=-1)  # (B, N, K)
        vlad = torch.einsum("bik,bid->bkd", a, feats) - torch.einsum("bik,kd->bkd", a, self.centers)
        vlad = F.normalize(vlad, dim=-1, eps=1e-12).reshape(B, -1)
        return F.normalize(self.proj(vlad), dim=-1, eps=1e-12)


class NetVLADDescriptor:
    """describe_batch over ``NetVLADNet``. ``state_dict``: the net's own
    layout (tensors or numpy); else the random init of seed 0."""

    def __init__(self, options: NetVLADOptions = NetVLADOptions(), state_dict: Optional[dict] = None):
        self.options = options
        self.net = _seeded(lambda: NetVLADNet(options))
        if state_dict is not None:
            self.net.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32) for k, v in state_dict.items()})
        self.net.eval().requires_grad_(False)

    def describe_batch(self, images) -> np.ndarray:
        """(B, H, W) grayscale in [0, 1] (numpy, or a tensor on the device
        to run on) -> (B, output_dim) unit rows, numpy."""
        return _run(self.net, torch.as_tensor(images, dtype=torch.float32)[:, None])


# ---- hloc's VGG16-NetVLAD (the public Pitts30K checkpoint's layout) ---------

# Sequential indices of VGG16's 13 convs (cut at conv5_3) and the convs a
# 2x2 max pool follows
VGG16_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
VGG16_POOL_AFTER = (2, 7, 14, 21)
VGG_MEAN_RGB = (123.68, 116.779, 103.939)


class _NetVLADLayer(nn.Module):
    def __init__(self, dim: int, num_clusters: int):
        super().__init__()
        self.score_proj = nn.Conv1d(dim, num_clusters, 1, bias=False)
        self.centers = nn.Parameter(nn.init.xavier_uniform_(torch.empty(dim, num_clusters)))


class NetVLADVGG16(nn.Module):
    """hloc's NetVLAD: RGB in [0, 1] (B, 3, H, W) -> (B, whiten_dim) unit
    rows. VGG16 to conv5_3 (its last ReLU removed), L2-normalized features,
    soft assignment to the centres, residual sums intra-normalized over the
    feature axis, flattened (D, K) row-major, L2, whitened, L2."""

    def __init__(self, num_clusters: int = 64, whiten_dim: int = 4096, mean_rgb: tuple = VGG_MEAN_RGB):
        super().__init__()
        layers, cin = [], 3
        for i, cout in zip(VGG16_CONV_IDS, VGG16_CHANNELS):
            layers += [nn.Identity()] * (i - len(layers))  # the ReLUs and pools hold these indices
            layers.append(nn.Conv2d(cin, cout, 3, padding=1))
            cin = cout
        self.backbone = nn.Sequential(*layers)
        self.netvlad = _NetVLADLayer(cin, num_clusters)
        self.whiten = nn.Linear(cin * num_clusters, whiten_dim)
        self.register_buffer("mean_rgb", torch.tensor(mean_rgb, dtype=torch.float32), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.clamp(x * 255.0, 0.0, 255.0) - self.mean_rgb[:, None, None]
        last = VGG16_CONV_IDS[-1]
        for i in VGG16_CONV_IDS:
            x = self.backbone[i](x)
            if i != last:
                x = F.relu(x)
            if i in VGG16_POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        B, D = x.shape[:2]
        feats = F.normalize(x.flatten(2).transpose(1, 2), dim=-1, eps=1e-12)  # (B, N, D)
        assign = torch.softmax(feats @ self.netvlad.score_proj.weight[:, :, 0].T, dim=-1)  # (B, N, K)
        centers = self.netvlad.centers  # (D, K)
        vlad = torch.einsum("bnk,bnd->bdk", assign, feats) - assign.sum(dim=1)[:, None, :] * centers[None]
        vlad = F.normalize(vlad, dim=1, eps=1e-12).reshape(B, -1)
        vlad = F.normalize(vlad, dim=-1, eps=1e-12)
        return F.normalize(self.whiten(vlad), dim=-1, eps=1e-12)


def convert_hloc_netvlad_state_dict(sd) -> dict:
    """hloc's NetVLAD state_dict (``backbone.N.weight`` / ``.bias``,
    ``netvlad.score_proj.weight`` (K, D, 1), ``netvlad.centers`` (D, K),
    ``whiten.weight`` / ``.bias``; tensors or numpy) -> the float32 tensors
    ``NetVLADVGG16`` loads. The VLAD flattens (D, K) row-major in both, so
    the whitening maps over without a permutation."""
    keys = [f"backbone.{i}.{p}" for i in VGG16_CONV_IDS for p in ("weight", "bias")]
    keys += ["netvlad.score_proj.weight", "netvlad.centers", "whiten.weight", "whiten.bias"]
    return {k: torch.as_tensor(np.asarray(sd[k]), dtype=torch.float32) for k in keys}


class HlocNetVLADDescriptor:
    """describe_batch over ``NetVLADVGG16``. Images: (B, H, W) grayscale or
    (B, H, W, 3) RGB in [0, 1]. Weights: ``state_dict`` (the hloc layout),
    else ``weights_path``'s checkpoint, else the random init of seed 0."""

    def __init__(self, state_dict: Optional[dict] = None, weights_path: Optional[str] = None):
        self.net = _seeded(NetVLADVGG16)
        if state_dict is None and weights_path is not None:
            from gtsfm_tpu_torch.utils.torch_io import load_torch_checkpoint

            state_dict = load_torch_checkpoint(weights_path)
        if state_dict is not None:
            self.net.load_state_dict(convert_hloc_netvlad_state_dict(state_dict))
        self.net.eval().requires_grad_(False)

    def describe_batch(self, images) -> np.ndarray:
        x = torch.as_tensor(images, dtype=torch.float32)
        x = x[:, None].expand(-1, 3, -1, -1) if x.dim() == 3 else x.permute(0, 3, 1, 2)
        return _run(self.net, x)
