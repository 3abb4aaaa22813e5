"""D2-Net detector and descriptor.

Port of gtsfm_tpu/frontend/detectors/d2net.py: the dense-feature trunk (a
VGG16 cut at conv4_3, its pool after conv3_3 replaced by a stride-1 2x2
average pool and its conv4 block dilated by 2: stride 4) as an
``nn.Module`` with the public checkpoints' keys
(``dense_feature_extraction.model.{0,2,...,21}``), the hard detection
(channel-wise maximum, 3x3 local maximum, a Harris-style edge filter on the
fixed Hessian stencils) and the handcrafted sub-pixel localization (one
Newton step). Tensors are NCHW; ``hard_detection`` and
``handcrafted_localization`` take the features (B, C, h, w) where the
reference takes (B, h, w, C).

A keypoint at feature cell (i, j) maps to input pixel ((j + dj + 0.5) * 4,
(i + di + 0.5) * 4): the stride-1 average pool shifts the grid by half a
cell. The top-K is a stable sort (``jax.lax.top_k``'s order for the many
zero responses). The trunk runs in float32 under ``precise()``; without a
checkpoint it keeps a random init drawn from seed 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.common.keypoints import Keypoints
from gtsfm_tpu_torch.frontend.detectors.dog_sift import stable_topk
from gtsfm_tpu_torch.utils.numerics import precise

# Sequential indices of the trunk's ten convs
CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)
_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512)
_DILATED = (17, 19, 21)
STRIDE = 4


class D2NetOptions(NamedTuple):
    max_keypoints: int = 2048
    edge_threshold: float = 5.0
    use_relu: bool = True  # the final ReLU on the dense features (the d2 checkpoints)


class D2NetTrunk(nn.Module):
    """(B, 3, H, W), H and W multiples of 4 -> (B, 512, H/4 - 1, W/4 - 1)."""

    def __init__(self, use_relu: bool = True):
        super().__init__()
        self.use_relu = use_relu
        layers, cin = [], 3
        for i, cout in zip(CONV_IDS, _CHANNELS):
            layers += [nn.Identity()] * (i - len(layers))  # the ReLUs and pools hold these indices
            d = 2 if i in _DILATED else 1
            layers.append(nn.Conv2d(cin, cout, 3, padding=d, dilation=d))
            cin = cout
        self.dense_feature_extraction = nn.Module()
        self.dense_feature_extraction.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.dense_feature_extraction.model
        for i in CONV_IDS:
            x = m[i](x)
            if i != CONV_IDS[-1] or self.use_relu:
                x = F.relu(x)
            if i in (2, 7):
                x = F.max_pool2d(x, 2, 2)
            elif i == 14:
                x = F.avg_pool2d(x, 2, stride=1)  # valid: (h - 1, w - 1)
        return x


def _shift(x: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """(B, C, H, W) read at (i + di, j + dj), zero outside."""
    H, W = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    return p[..., 1 + di : 1 + di + H, 1 + dj : 1 + dj + W]


def _hessian_stencils(f: torch.Tensor):
    dii = _shift(f, -1, 0) - 2.0 * f + _shift(f, 1, 0)
    djj = _shift(f, 0, -1) - 2.0 * f + _shift(f, 0, 1)
    dij = 0.25 * (_shift(f, -1, -1) - _shift(f, -1, 1) - _shift(f, 1, -1) + _shift(f, 1, 1))
    return dii, dij, djj


def hard_detection(f: torch.Tensor, edge_threshold: float = 5.0) -> torch.Tensor:
    """Detection mask (B, C, h, w): the channel-wise maximum, a 3x3 local
    maximum (the pool pads with -inf) and not on an edge."""
    is_depth_max = f == torch.amax(f, dim=1, keepdim=True)
    is_local_max = f == F.max_pool2d(f, 3, stride=1, padding=1)
    dii, dij, djj = _hessian_stencils(f)
    det = dii * djj - dij * dij
    tr = dii + djj
    thr = (edge_threshold + 1.0) ** 2 / edge_threshold
    return is_depth_max & is_local_max & (tr * tr <= thr * det) & (det > 0)


def handcrafted_localization(f: torch.Tensor) -> torch.Tensor:
    """The sub-pixel Newton step (B, C, h, w, 2) in (i, j) order."""
    dii, dij, djj = _hessian_stencils(f)
    det = dii * djj - dij * dij
    det_safe = torch.where(det.abs() < 1e-12, 1e-12, det)
    di = 0.5 * (_shift(f, 1, 0) - _shift(f, -1, 0))
    dj = 0.5 * (_shift(f, 0, 1) - _shift(f, 0, -1))
    step_i = -(djj * di - dij * dj) / det_safe
    step_j = -(-dij * di + dii * dj) / det_safe
    return torch.stack([step_i, step_j], dim=-1)


def convert_torch_state_dict(sd) -> dict:
    """A d2net checkpoint's state_dict (tensors or numpy) -> the ten convs'
    float32 weights and biases, the keys ``D2NetTrunk`` loads."""
    import numpy as np

    keys = [f"dense_feature_extraction.model.{i}.{p}" for i in CONV_IDS for p in ("weight", "bias")]
    return {k: torch.as_tensor(np.asarray(sd[k]), dtype=torch.float32) for k in keys}


def load_torch_weights(path: str) -> dict:
    """A public d2net checkpoint (the state_dict, or a dict holding it under
    ``model``) -> ``convert_torch_state_dict``'s dict."""
    from gtsfm_tpu_torch.utils.torch_io import load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    if isinstance(sd, dict) and "model" in sd and not any(k.startswith("dense_feature_extraction") for k in sd):
        sd = sd["model"]
    return convert_torch_state_dict(sd)


class D2Net:
    """Detector-descriptor component: ``images`` (B, H, W) grayscale in
    [0, 1], H and W multiples of 4, on the device to run on (replicated to
    the trunk's three channels) -> (Keypoints (B, K), unit descriptors (B,
    K, 512)). Weights: ``state_dict``, else ``weights_path``'s checkpoint,
    else the random init of seed 0."""

    STRIDE = STRIDE

    def __init__(self, options: D2NetOptions = D2NetOptions(), weights_path: Optional[str] = None,
                 state_dict: Optional[dict] = None):
        self.options = options
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.net = D2NetTrunk(options.use_relu)
        if state_dict is None and weights_path is not None:
            state_dict = load_torch_weights(weights_path)
        if state_dict is not None:
            self.net.load_state_dict(convert_torch_state_dict(state_dict))
        self.net.eval().requires_grad_(False)

    def __call__(self, images: torch.Tensor):
        images = torch.as_tensor(images, dtype=torch.float32)
        self.net.to(images.device)
        with torch.no_grad(), precise():
            f = self.net(images[:, None].expand(-1, 3, -1, -1))
        B, C, h, w = f.shape
        detected = hard_detection(f, self.options.edge_threshold)
        resp = torch.amax(torch.where(detected, f, 0.0), dim=1)  # (B, h, w)
        best_c = torch.argmax(torch.where(detected, f, -torch.inf), dim=1)
        top, idx = stable_topk(resp.reshape(B, -1), min(self.options.max_keypoints, h * w))
        ys, xs = torch.div(idx, w, rounding_mode="floor"), idx % w
        ch = torch.gather(best_c.reshape(B, -1), 1, idx)
        # the Newton step only at the picked cells and channels
        disp = handcrafted_localization(f).flatten(1, 3)  # (B, C*h*w, 2)
        off = torch.gather(disp, 1, (ch * (h * w) + idx)[..., None].expand(-1, -1, 2))
        d = torch.gather(f.flatten(2), 2, idx[:, None].expand(-1, C, -1)).transpose(1, 2)  # (B, K, C)
        u = (xs + torch.clamp(off[..., 1], -0.5, 0.5) + 0.5) * self.STRIDE
        v = (ys + torch.clamp(off[..., 0], -0.5, 0.5) + 0.5) * self.STRIDE
        kps = Keypoints(coordinates=torch.stack([u, v], dim=-1), scales=torch.full_like(u, float(self.STRIDE)),
                        responses=top, mask=top > 0)
        return kps, F.normalize(d, dim=-1, eps=1e-12)
