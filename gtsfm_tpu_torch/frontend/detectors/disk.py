"""DISK detector and descriptor (a thin U-Net).

Port of gtsfm_tpu/frontend/detectors/disk.py, the "thin setup" U-Net of
cvlab-epfl/disk as an ``nn.Module`` in the state_dict layout the reference
documents and converts:

  unet.path_down.0.1.0.{weight,bias}     first conv, 3 -> 16, 5x5
  unet.path_down.k.1.1.weight            PReLU slope (k = 1..4)
  unet.path_down.k.1.2.{weight,bias}     5x5 conv
  unet.path_up.j.conv.1.weight           PReLU slope (j = 0..3)
  unet.path_up.j.conv.2.{weight,bias}    5x5 conv

Down block k > 0: 2x2 average pool, instance norm (no affine, eps 1e-5),
PReLU, conv. Up block j: bilinear x2 of the path below (half-pixel centres,
as ``jax.image.resize`` upsamples), concatenated with the skip, instance
norm, PReLU, conv. Output: 128-d dense descriptors and a heatmap. Then a
5x5 non-maximum suppression (-inf padding), a stable top-K by heatmap
score, and the descriptors read at the keypoint pixels and L2-normalized.
The net runs in float32 under ``precise()``; without a checkpoint it keeps
a random He init drawn from seed 0 (slopes 0.25, as the reference's).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.common.keypoints import Keypoints
from gtsfm_tpu_torch.frontend.detectors.dog_sift import stable_topk
from gtsfm_tpu_torch.utils.numerics import precise

DOWN = (16, 32, 64, 64, 64)
UP = (64, 64, 64, 129)
DESC_DIM = 128
KSIZE = 5
IN_EPS = 1e-5
STRIDE = 16  # H and W must be multiples of 2^4


class DISKOptions(NamedTuple):
    max_keypoints: int = 2048
    nms_window: int = 5
    score_threshold: float = 0.0


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, KSIZE, padding=KSIZE // 2)


def _norm_act_conv(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.InstanceNorm2d(cin, eps=IN_EPS), nn.PReLU(cin), _conv(cin, cout))


class _UpBlock(nn.Module):
    def __init__(self, bottom: int, horizontal: int, cout: int):
        super().__init__()
        self.conv = _norm_act_conv(bottom + horizontal, cout)

    def forward(self, bot, hor):
        up = F.interpolate(bot, scale_factor=2, mode="bilinear", align_corners=False)
        return self.conv(torch.cat([up, hor], dim=1))


class Unet(nn.Module):
    def __init__(self):
        super().__init__()
        dims = (3,) + DOWN
        blocks = [nn.Sequential(nn.Identity(), nn.Sequential(_conv(dims[0], dims[1])))]
        blocks += [nn.Sequential(nn.AvgPool2d(2), _norm_act_conv(cin, cout)) for cin, cout in zip(dims[1:-1], dims[2:])]
        self.path_down = nn.ModuleList(blocks)
        bottom = (DOWN[-1],) + UP[:-1]
        horizontal = dims[-2::-1]  # (64, 64, 32, 16)
        self.path_up = nn.ModuleList([_UpBlock(b, h, c) for b, h, c in zip(bottom, horizontal, UP)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W), H and W multiples of 16 -> (B, 129, H, W)."""
        feats = []
        for blk in self.path_down:
            x = blk(x)
            feats.append(x)
        y = feats[-1]
        for blk, skip in zip(self.path_up, feats[-2::-1]):
            y = blk(y, skip)
        return y


class DISKNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.unet = Unet()


def init_net() -> DISKNet:
    """He-normal convs (std sqrt(2 / (25 cin))), zero biases, PReLU slopes
    0.25, from torch's generator seeded with 0."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = DISKNet()
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, math.sqrt(2.0 / (KSIZE * KSIZE * m.in_channels)))
                    m.bias.zero_()
    return net


def detect(out: torch.Tensor, opts: DISKOptions):
    """The U-Net's output (B, 129, H, W) -> (Keypoints (B, K), unit
    descriptors (B, K, 128))."""
    desc_dense, heat = out[:, :DESC_DIM], out[:, DESC_DIM]
    B, H, W = heat.shape
    pooled = F.max_pool2d(heat[:, None], opts.nms_window, stride=1, padding=opts.nms_window // 2)[:, 0]
    nms = torch.where(heat == pooled, heat, -torch.inf)
    top, idx = stable_topk(nms.reshape(B, -1), opts.max_keypoints)
    ys, xs = torch.div(idx, W, rounding_mode="floor"), idx % W
    d = torch.gather(desc_dense.flatten(2), 2, idx[:, None].expand(-1, DESC_DIM, -1)).transpose(1, 2)
    kps = Keypoints(coordinates=torch.stack([xs, ys], dim=-1).to(torch.float32),
                    scales=torch.ones(top.shape, device=top.device), responses=top,
                    mask=top > opts.score_threshold)
    return kps, F.normalize(d, dim=-1, eps=1e-12)


def convert_torch_state_dict(sd) -> dict:
    """A DISK state_dict (the layout above; keys may carry a prefix such as
    ``extractor.`` or ``model.``, and InstanceNorm running stats are
    ignored; tensors or numpy) -> the float32 tensors ``DISKNet`` loads."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    def find(*suffixes):
        for k, v in sd.items():
            if k.endswith(suffixes):
                return torch.as_tensor(v, dtype=torch.float32)
        raise KeyError(f"none of {suffixes} in checkpoint (keys: {sorted(sd)[:8]}...)")

    out = {"unet.path_down.0.1.0.weight": find("unet.path_down.0.1.0.weight", "unet.path_down.0.1.weight"),
           "unet.path_down.0.1.0.bias": find("unet.path_down.0.1.0.bias", "unet.path_down.0.1.bias")}
    for k in range(1, len(DOWN)):
        for key in (f"unet.path_down.{k}.1.1.weight", f"unet.path_down.{k}.1.2.weight", f"unet.path_down.{k}.1.2.bias"):
            out[key] = find(key)
    for j in range(len(UP)):
        for key in (f"unet.path_up.{j}.conv.1.weight", f"unet.path_up.{j}.conv.2.weight",
                    f"unet.path_up.{j}.conv.2.bias"):
            out[key] = find(key)
    return out


def load_torch_weights(path: str) -> dict:
    from gtsfm_tpu_torch.utils.torch_io import load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    if isinstance(sd, dict) and "extractor" in sd:
        sd = sd["extractor"]
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_torch_state_dict(sd)


class DISK:
    """Detector-descriptor component: ``images`` (B, H, W) grayscale in
    [0, 1], H and W multiples of 16 (the registry's adapter pads), on the
    device to run on -> (Keypoints (B, K), descriptors (B, K, 128)).
    Weights: ``state_dict``, else ``weights_path``'s checkpoint, else the
    random init of seed 0."""

    def __init__(self, options: DISKOptions = DISKOptions(), weights_path: Optional[str] = None,
                 state_dict: Optional[dict] = None):
        self.options = options
        self.net = init_net()
        if state_dict is None and weights_path is not None:
            state_dict = load_torch_weights(weights_path)
        if state_dict is not None:
            self.net.load_state_dict(convert_torch_state_dict(state_dict))
        self.net.eval().requires_grad_(False)

    def __call__(self, images: torch.Tensor):
        images = torch.as_tensor(images, dtype=torch.float32)
        self.net.to(images.device)
        with torch.no_grad(), precise():
            out = self.net.unet(images[:, None].expand(-1, 3, -1, -1))
        return detect(out, self.options)
