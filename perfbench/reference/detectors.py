"""Plain references of the two detectors the cells run: SuperPoint (the
MagicLeap architecture, loaded from the same checkpoint file the program
reads) and DoG-SIFT, each followed by the scene optimizer's 4-pixel border
rule. Frozen copies of the plain PyTorch code of the port's
``frontend/detectors/{superpoint,dog_sift}.py`` and of its detector
adapter (images zero-padded at the bottom and right to the net's stride),
in float32 with TF32 off, or TF32 on for the control.

``detect(kind, images, sizes, options, weights, tf32)`` -> (kp_xy (B, K, 2),
kp_mask (B, K), descs (B, K, D)) as float32 / bool tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.numerics import precision

SUPERPOINT_LAYERS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b",
                     "convPa", "convPb", "convDa", "convDb")
BORDER_PX = 4  # the scene optimizer's border-validity rule


def stable_topk(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------- SuperPoint
class SuperPointNet(nn.Module):
    def __init__(self):
        super().__init__()
        conv = lambda cin, cout, k: nn.Conv2d(cin, cout, k, padding=k // 2)  # noqa: E731
        self.conv1a, self.conv1b = conv(1, 64, 3), conv(64, 64, 3)
        self.conv2a, self.conv2b = conv(64, 64, 3), conv(64, 64, 3)
        self.conv3a, self.conv3b = conv(64, 128, 3), conv(128, 128, 3)
        self.conv4a, self.conv4b = conv(128, 128, 3), conv(128, 128, 3)
        self.convPa, self.convPb = conv(128, 256, 3), conv(256, 65, 1)
        self.convDa, self.convDb = conv(128, 256, 3), conv(256, 256, 1)

    def forward(self, x):
        y = x
        for i, (a, b) in enumerate(((self.conv1a, self.conv1b), (self.conv2a, self.conv2b),
                                    (self.conv3a, self.conv3b), (self.conv4a, self.conv4b))):
            if i:
                y = F.max_pool2d(y, 2, 2)
            y = F.relu(b(F.relu(a(y))))
        scores = self.convPb(F.relu(self.convPa(y)))
        desc = self.convDb(F.relu(self.convDa(y)))
        return scores, F.normalize(desc, dim=1, eps=1e-12)


def load_superpoint(path: str, device) -> SuperPointNet:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    net = SuperPointNet()
    net.load_state_dict({f"{n}.{p}": sd[f"{n}.{p}"].float() for n in SUPERPOINT_LAYERS for p in ("weight", "bias")})
    return net.to(device).eval().requires_grad_(False)


def _sample_descriptors(desc, xs, ys):
    B, D, Hc, Wc = desc.shape
    gx, gy = xs / 8.0 - 0.5, ys / 8.0 - 0.5
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, Wc - 2)
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, Hc - 2)
    fx = torch.clamp(gx - x0, 0, 1)[..., None]
    fy = torch.clamp(gy - y0, 0, 1)[..., None]
    flat = desc.flatten(2).transpose(1, 2)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * Wc + xx)[..., None].expand(B, -1, D))

    d = (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
         + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)
    return F.normalize(d, dim=-1, eps=1e-12)


def superpoint(net: SuperPointNet, images, opts: dict):
    """(B, H, W) -> (coords (B, K, 2), mask (B, K), descs (B, K, 256))."""
    H0, W0 = images.shape[-2:]
    images = F.pad(images, (0, -W0 % 8, 0, -H0 % 8))
    with torch.no_grad():
        scores65, desc_coarse = net(images[:, None])
    B, _, Hc, Wc = scores65.shape
    probs = torch.softmax(scores65, dim=1)[:, :64]
    heat = F.pixel_shuffle(probs, 8)[:, 0]
    r = opts["nms_radius"]
    pooled = F.max_pool2d(heat[:, None], 2 * r + 1, stride=1, padding=r)[:, 0]
    heat = torch.where(heat == pooled, heat, 0.0)
    H, W = Hc * 8, Wc * 8
    b_ = opts["remove_borders"]
    yy = torch.arange(H, device=heat.device)[:, None]
    xx = torch.arange(W, device=heat.device)[None, :]
    heat = torch.where(((yy >= b_) & (yy < H - b_) & (xx >= b_) & (xx < W - b_))[None], heat, 0.0)
    top, idx = stable_topk(heat.reshape(B, -1), opts["max_keypoints"])
    ys = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    xs = (idx % W).to(torch.float32)
    return torch.stack([xs, ys], dim=-1), top > opts["detection_threshold"], _sample_descriptors(desc_coarse, xs, ys)


# ---------------------------------------------------------------- DoG-SIFT
def _blur(img, sigma):
    radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / torch.sum(k)
    y = F.conv2d(F.pad(img[:, None], (radius, radius, 0, 0), mode="replicate"), k.view(1, 1, 1, -1))
    return F.conv2d(F.pad(y, (0, 0, radius, radius), mode="replicate"), k.view(1, 1, -1, 1))[:, 0]


def _extrema(gauss, opts):
    dog = gauss[:, 1:] - gauss[:, :-1]
    S = opts["scales_per_octave"]
    center = dog[:, 1 : S + 1]
    roll = lambda a, dy, dx: torch.roll(a, (dy, dx), dims=(-2, -1))  # noqa: E731
    is_max = torch.ones_like(center, dtype=torch.bool)
    is_min = torch.ones_like(center, dtype=torch.bool)
    for ds in (-1, 0, 1):
        nb_stack = dog[:, 1 + ds : S + 1 + ds]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                nb = roll(nb_stack, dy, dx)
                is_max &= center > nb
                is_min &= center < nb
    dxx = roll(center, 0, 1) + roll(center, 0, -1) - 2 * center
    dyy = roll(center, 1, 0) + roll(center, -1, 0) - 2 * center
    dxy = 0.25 * (roll(center, 1, 1) + roll(center, -1, -1) - roll(center, 1, -1) - roll(center, -1, 1))
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    r = opts["edge_ratio"]
    edge_ok = (det > 0) & (tr**2 * r < (r + 1) ** 2 * det)
    H, W = center.shape[-2:]
    yy = torch.arange(H, device=gauss.device)
    xx = torch.arange(W, device=gauss.device)
    inb = (yy[:, None] >= 8) & (yy[:, None] < H - 8) & (xx[None, :] >= 8) & (xx[None, :] < W - 8)
    keep = (is_max | is_min) & (torch.abs(center) > opts["contrast_threshold"]) & edge_ok & inb
    return torch.where(keep, torch.abs(center), torch.zeros((), device=gauss.device))


def _tri(x, n):
    c = torch.arange(n, dtype=x.dtype, device=x.device)
    return torch.clamp(1.0 - torch.abs(x[..., None] - c), min=0.0)


def _tri_circular(x, n):
    c = torch.arange(n, dtype=x.dtype, device=x.device)
    d = torch.abs(x[..., None] - c)
    return torch.clamp(1.0 - torch.minimum(d, n - d), min=0.0)


def _sift_descriptors(gauss_img, kp_xy, sigma, opts, tf32):
    B, H, W = gauss_img.shape
    dev = gauss_img.device
    gy, gx = torch.gradient(gauss_img, dim=(-2, -1))
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    G, nb, nw = opts["patch_grid"], opts["descriptor_bins"], opts["descriptor_width"]
    lin = (torch.arange(G, dtype=torch.float32, device=dev) - (G - 1) / 2.0) / (G / 2.0)
    off_y, off_x = torch.meshgrid(lin, lin, indexing="ij")
    off_y, off_x = off_y.reshape(-1), off_x.reshape(-1)
    spatial_w = torch.exp(-(off_y**2 + off_x**2) / (2 * 0.5**2))
    radius = torch.tensor(sigma, dtype=torch.float32, device=dev) * 6.0
    ys = kp_xy[..., 1:2] + off_y * radius
    xs = kp_xy[..., 0:1] + off_x * radius
    base = (torch.arange(B, device=dev) * (H * W)).view(B, 1, 1)

    def bilinear(img, y, x):
        y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
        x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
        wy = torch.clamp(y - y0, 0.0, 1.0)
        wx = torch.clamp(x - x0, 0.0, 1.0)
        flat = img.reshape(-1)
        i00 = base + y0 * W + x0
        v00, v01, v10, v11 = flat[i00], flat[i00 + 1], flat[i00 + W], flat[i00 + W + 1]
        return v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx

    m, a = bilinear(mag, ys, xs), bilinear(ang, ys, xs)
    w = spatial_w * m
    bins_o = (a + math.pi) / (2 * math.pi) * 36
    hist = torch.sum(w[..., None] * _tri_circular(bins_o, 36), dim=-2)
    hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0
    theta = (torch.argmax(hist, dim=-1).to(torch.float32) + 0.5) / 36 * 2 * math.pi - math.pi
    a_rel = torch.remainder(a - theta[..., None] + math.pi, 2 * math.pi)
    cos_t, sin_t = torch.cos(-theta)[..., None], torch.sin(-theta)[..., None]
    ry = off_y * cos_t + off_x * sin_t
    rx = -off_y * sin_t + off_x * cos_t
    wy_b = _tri((ry + 1.0) * 0.5 * nw - 0.5, nw)
    wx_b = _tri((rx + 1.0) * 0.5 * nw - 0.5, nw)
    wo_b = _tri_circular(a_rel / (2 * math.pi) * nb, nb)
    with precision(tf32):
        desc = torch.einsum("bkp,bkpi,bkpj,bkpl->bkijl", w, wy_b, wx_b, wo_b)
    v = desc.reshape(B, kp_xy.shape[1], -1)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    v = torch.clamp(v, max=0.2)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def dog_sift(images, opts: dict, tf32: bool = False):
    """(B, H, W) -> (coords (B, K, 2), mask (B, K), descs (B, K, 128))."""
    B = images.shape[0]
    dev = images.device
    S = opts["scales_per_octave"]
    k_per_level = max(1, opts["max_keypoints"] // (opts["num_octaves"] * S))
    sigmas = [opts["sigma0"] * (2.0 ** (s / S)) for s in range(S + 3)]
    img = images.to(torch.float32)
    coords, scores, valids, descs = [], [], [], []
    for o in range(opts["num_octaves"]):
        H, W = img.shape[-2:]
        with precision(tf32):
            gauss = torch.stack([_blur(img, s) for s in sigmas], dim=1)
        score = _extrema(gauss, opts)
        for s in range(S):
            top_scores, top_idx = stable_topk(score[:, s].reshape(B, -1), k_per_level)
            kp_xy = torch.stack([(top_idx % W).to(torch.float32), (top_idx // W).to(torch.float32)], dim=-1)
            descs.append(_sift_descriptors(gauss[:, s + 1], kp_xy, sigmas[s + 1], opts, tf32))
            coords.append(kp_xy * 2.0**o)
            scores.append(top_scores)
            valids.append(top_scores > 0)
        lead = gauss[:, S].shape[:-2]
        img = F.interpolate(gauss[:, S].reshape(-1, 1, H, W), size=(H // 2, W // 2), mode="bilinear",
                            align_corners=False, antialias=True).reshape(*lead, H // 2, W // 2)
    coords, scores, valids, descs = (torch.cat(x, dim=1) for x in (coords, scores, valids, descs))
    K = opts["max_keypoints"]
    pad = K - scores.shape[1]
    if pad > 0:
        coords = torch.cat([coords, torch.zeros((B, pad, 2), device=dev)], dim=1)
        scores = torch.cat([scores, torch.full((B, pad), -1.0, device=dev)], dim=1)
        valids = torch.cat([valids, torch.zeros((B, pad), dtype=torch.bool, device=dev)], dim=1)
        descs = torch.cat([descs, torch.zeros((B, pad, descs.shape[-1]), device=dev)], dim=1)
    sel_scores, sel = stable_topk(torch.where(valids, scores, torch.full((), -1.0, device=dev)), K)

    def take(x):
        return torch.gather(x, 1, sel.view(B, K, *([1] * (x.dim() - 2))).expand(B, K, *x.shape[2:]))

    return take(coords), sel_scores > 0, take(descs)


def detect(kind: str, images, sizes, opts: dict, net=None, tf32: bool = False):
    """One detector batch as the scene optimizer runs it, with its border
    rule on each image's own (h, w)."""
    with precision(tf32):
        if kind == "superpoint":
            coords, mask, descs = superpoint(net, images, opts)
        else:
            coords, mask, descs = dog_sift(images, opts, tf32)
    h = torch.tensor([s[0] for s in sizes], device=images.device)[:, None]
    w = torch.tensor([s[1] for s in sizes], device=images.device)[:, None]
    inb = ((coords[..., 0] < w - BORDER_PX) & (coords[..., 1] < h - BORDER_PX)
           & (coords[..., 0] >= BORDER_PX) & (coords[..., 1] >= BORDER_PX))
    return coords, mask & inb, descs
