"""SuperPoint detector and descriptor.

Port of gtsfm_tpu/frontend/detectors/superpoint.py: the MagicLeap
architecture layer for layer (an ``nn.Module`` in NCHW whose state_dict
keys are those of the public superpoint_v1.pth, so the checkpoint loads
with ``load_state_dict``), then non-maximum suppression, the border mask,
a top-K of the heatmap and descriptors sampled at the keypoints.

Where a straight transcription would differ from the reference:

- ``jax.lax.top_k`` returns equal values lowest index first. After the
  border mask most of the heatmap is exactly 0, so ties are everywhere:
  the top-K is a stable descending sort and a slice (``stable_topk``);
- the descriptors are sampled with the reference's own bilinear formula
  (corners clipped to the coarse grid), not ``grid_sample``;
- cuDNN runs float32 convolutions in TF32 by default on the card: the net
  runs under ``precise()`` (float32 throughout, as the reference).

Without a checkpoint the net keeps a random init drawn from seed 0, for
pipeline-shape runs: correct shapes, not production matching quality.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.common.keypoints import Keypoints
from gtsfm_tpu_torch.frontend.detectors.dog_sift import stable_topk
from gtsfm_tpu_torch.utils.numerics import precise

LAYERS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b",
          "convPa", "convPb", "convDa", "convDb")


class SuperPointOptions(NamedTuple):
    max_keypoints: int = 2048
    detection_threshold: float = 0.005
    nms_radius: int = 4
    remove_borders: int = 4


class SuperPointNet(nn.Module):
    """VGG-style encoder, detector head (65-channel cell softmax) and
    descriptor head (256-d), the MagicLeap layers and key names."""

    def __init__(self):
        super().__init__()
        conv = lambda cin, cout, k: nn.Conv2d(cin, cout, k, padding=k // 2)  # noqa: E731
        self.conv1a, self.conv1b = conv(1, 64, 3), conv(64, 64, 3)
        self.conv2a, self.conv2b = conv(64, 64, 3), conv(64, 64, 3)
        self.conv3a, self.conv3b = conv(64, 128, 3), conv(128, 128, 3)
        self.conv4a, self.conv4b = conv(128, 128, 3), conv(128, 128, 3)
        self.convPa, self.convPb = conv(128, 256, 3), conv(256, 65, 1)
        self.convDa, self.convDb = conv(128, 256, 3), conv(256, 256, 1)

    def forward(self, x: torch.Tensor):
        """x: (B, 1, H, W), H and W divisible by 8 -> (scores (B, 65, H/8,
        W/8), unit descriptors (B, 256, H/8, W/8))."""
        y = x
        for i, (a, b) in enumerate(((self.conv1a, self.conv1b), (self.conv2a, self.conv2b),
                                    (self.conv3a, self.conv3b), (self.conv4a, self.conv4b))):
            if i:
                y = F.max_pool2d(y, 2, 2)
            y = F.relu(b(F.relu(a(y))))
        scores = self.convPb(F.relu(self.convPa(y)))
        desc = self.convDb(F.relu(self.convDa(y)))
        return scores, F.normalize(desc, dim=1, eps=1e-12)


def _simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep the maxima of their (2r+1)^2 windows (the pool pads with -inf).
    scores: (B, H, W)."""
    pooled = F.max_pool2d(scores[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]
    return torch.where(scores == pooled, scores, 0.0)


def _sample_descriptors(desc: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """The reference's bilinear read of the coarse descriptors (B, D, Hc,
    Wc) at pixel keypoints (B, K): cell centres at 8 c + 3.5, corners
    clipped to the grid -> unit (B, K, D)."""
    B, D, Hc, Wc = desc.shape
    gx, gy = xs / 8.0 - 0.5, ys / 8.0 - 0.5
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, Wc - 2)
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, Hc - 2)
    fx = torch.clamp(gx - x0, 0, 1)[..., None]
    fy = torch.clamp(gy - y0, 0, 1)[..., None]
    flat = desc.flatten(2).transpose(1, 2)  # (B, Hc*Wc, D)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * Wc + xx)[..., None].expand(B, -1, D))

    d = (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
         + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)
    return F.normalize(d, dim=-1, eps=1e-12)


def _postprocess(scores65: torch.Tensor, desc_coarse: torch.Tensor, opts: SuperPointOptions):
    """scores65 (B, 65, Hc, Wc), desc_coarse (B, 256, Hc, Wc) -> (Keypoints
    (B, K), descriptors (B, K, 256)), K = max_keypoints."""
    B, _, Hc, Wc = scores65.shape
    probs = torch.softmax(scores65, dim=1)[:, :64]  # drop the dustbin
    heat = F.pixel_shuffle(probs, 8)[:, 0]  # channel 8 a + b -> pixel (8 y + a, 8 x + b)
    heat = _simple_nms(heat, opts.nms_radius)
    H, W = Hc * 8, Wc * 8
    b_ = opts.remove_borders
    yy = torch.arange(H, device=heat.device)[:, None]
    xx = torch.arange(W, device=heat.device)[None, :]
    border = (yy >= b_) & (yy < H - b_) & (xx >= b_) & (xx < W - b_)
    heat = torch.where(border[None], heat, 0.0)

    top, idx = stable_topk(heat.reshape(B, -1), opts.max_keypoints)
    ys = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    xs = (idx % W).to(torch.float32)
    kps = Keypoints(coordinates=torch.stack([xs, ys], dim=-1), scales=torch.ones_like(xs), responses=top,
                    mask=top > opts.detection_threshold)
    return kps, _sample_descriptors(desc_coarse, xs, ys)


def load_torch_weights(path: str) -> dict:
    """The MagicLeap superpoint_v1.pth (a state_dict, or a module holding
    one) -> its twelve layers' weights and biases."""
    from gtsfm_tpu_torch.utils.torch_io import load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {f"{n}.{p}": torch.as_tensor(sd[f"{n}.{p}"], dtype=torch.float32)
            for n in LAYERS for p in ("weight", "bias")}


class SuperPoint:
    """Detector-descriptor component: ``images`` (B, H, W) grayscale in
    [0, 1], H and W divisible by 8 (the registry's adapter pads), on the
    device to run on -> (Keypoints (B, K), descriptors (B, K, 256)).

    ``state_dict``: MagicLeap-layout weights (tensors or numpy); else
    ``weights_path``'s checkpoint; else the random init of seed 0."""

    def __init__(self, options: SuperPointOptions = SuperPointOptions(), weights_path: Optional[str] = None,
                 state_dict: Optional[dict] = None):
        self.options = options
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.net = SuperPointNet()
        if state_dict is None and weights_path is not None:
            state_dict = load_torch_weights(weights_path)
        if state_dict is not None:
            self.net.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32) for k, v in state_dict.items()})
        self.net.eval().requires_grad_(False)

    def __call__(self, images: torch.Tensor):
        images = torch.as_tensor(images, dtype=torch.float32)
        self.net.to(images.device)
        with torch.no_grad(), precise():
            scores, desc = self.net(images[:, None])
            return _postprocess(scores, desc, self.options)
