"""DoG keypoint detector and SIFT-style descriptor, batched over images.

Port of gtsfm_tpu/frontend/detectors/dog_sift.py, where it is XLA code (no
Pallas kernel): here plain PyTorch on the device of the input batch, with
the batch as the leading dimension in place of the reference's
``jax.vmap`` over images (frontend/registry.py's adapter). Static shapes
throughout: fixed octave and scale counts, a per-level budget of
K // levels keypoints, and a final top-K padded to exactly K.

Where a straight transcription would differ from the reference:

- ``jax.image.resize(..., "linear")`` antialiases when it downsamples:
  ``F.interpolate(..., antialias=True)`` is its counterpart;
- ``jax.lax.top_k`` returns equal values lowest index first. The score
  maps are mostly 0 and the final selection pads with -1, so ties are
  everywhere; ``torch.topk`` orders them otherwise, so every top-k here is
  a stable descending sort and a slice;
- neighbours are ``jnp.roll``: wrap-around, mirrored by ``torch.roll``;
- the blur pads with the edge value (``mode="replicate"``), and
  ``torch.gradient`` takes the same one-sided differences at the edges as
  ``jnp.gradient``;
- cuDNN convolutions and batched products default to TF32 on the card,
  which moves the scores by about 1e-3 and reorders the top-k: the blur
  and the descriptor contraction run under ``precise()``.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gtsfm_tpu_torch.common.keypoints import Keypoints
from gtsfm_tpu_torch.utils.numerics import precise, resolve_device

# detect_and_describe calls by device type ("cuda", "cpu"): a run can show
# where the detector ran
calls_by_device: collections.Counter = collections.Counter()


class DoGSiftOptions(NamedTuple):
    max_keypoints: int = 2048
    num_octaves: int = 4
    scales_per_octave: int = 3
    sigma0: float = 1.6
    contrast_threshold: float = 0.015
    edge_ratio: float = 10.0
    descriptor_width: int = 4  # 4x4 spatial bins
    descriptor_bins: int = 8  # orientation bins
    patch_grid: int = 16  # sampling grid for the descriptor


def stable_topk(x: torch.Tensor, k: int) -> tuple:
    """The k largest values along the last dimension and their indices,
    equal values lowest index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def resize_linear(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """(..., H, W) -> (..., h, w) by ``jax.image.resize(x, ..., "linear")``'s
    rule: half-pixel centers, a triangle kernel widened by the scale when
    downsampling (antialiased)."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=size, mode="bilinear", align_corners=False,
                      antialias=True)
    return y.reshape(*lead, *size)


def _gaussian_kernel(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W) images with edge padding."""
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel(sigma, radius, img.device)
    x = F.pad(img[:, None], (radius, radius, 0, 0), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    x = F.pad(x, (0, 0, radius, radius), mode="replicate")
    return F.conv2d(x, k.view(1, 1, -1, 1))[:, 0]


def _detect_octave(gauss: torch.Tensor, opts: DoGSiftOptions) -> torch.Tensor:
    """gauss (B, S+3, H, W) -> extremum score maps (B, S, H, W)."""
    dog = gauss[:, 1:] - gauss[:, :-1]  # (B, S+2, H, W)
    S = opts.scales_per_octave
    center = dog[:, 1 : S + 1]

    def shift2(a, dy, dx):
        return torch.roll(a, (dy, dx), dims=(-2, -1))

    is_max = torch.ones_like(center, dtype=torch.bool)
    is_min = torch.ones_like(center, dtype=torch.bool)
    for ds in (-1, 0, 1):
        nb_stack = dog[:, 1 + ds : S + 1 + ds]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                nb = shift2(nb_stack, dy, dx)
                is_max &= center > nb
                is_min &= center < nb
    extremum = is_max | is_min
    contrast_ok = torch.abs(center) > opts.contrast_threshold

    dxx = shift2(center, 0, 1) + shift2(center, 0, -1) - 2 * center
    dyy = shift2(center, 1, 0) + shift2(center, -1, 0) - 2 * center
    dxy = 0.25 * (shift2(center, 1, 1) + shift2(center, -1, -1) - shift2(center, 1, -1) - shift2(center, -1, 1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = opts.edge_ratio
    edge_ok = (det > 0) & (tr**2 * r < (r + 1) ** 2 * det)

    H, W = center.shape[-2:]
    border = 8
    yy = torch.arange(H, device=gauss.device)
    xx = torch.arange(W, device=gauss.device)
    inb = ((yy[:, None] >= border) & (yy[:, None] < H - border)
           & (xx[None, :] >= border) & (xx[None, :] < W - border))
    return torch.where(extremum & contrast_ok & edge_ok & inb, torch.abs(center), torch.zeros((), device=gauss.device))


def _tri(x: torch.Tensor, n: int) -> torch.Tensor:
    """Triangular weights max(0, 1 - |x - c|) for centers c = 0..n-1:
    (...,) -> (..., n)."""
    c = torch.arange(n, dtype=x.dtype, device=x.device)
    return torch.clamp(1.0 - torch.abs(x[..., None] - c), min=0.0)


def _tri_circular(x: torch.Tensor, n: int) -> torch.Tensor:
    c = torch.arange(n, dtype=x.dtype, device=x.device)
    d = torch.abs(x[..., None] - c)
    d = torch.minimum(d, n - d)
    return torch.clamp(1.0 - d, min=0.0)


def _descriptors_at(gauss_img: torch.Tensor, kp_xy: torch.Tensor, sigma: float, opts: DoGSiftOptions):
    """SIFT-style descriptors of one level.

    gauss_img (B, H, W); kp_xy (B, k, 2) in this level's pixels; sigma the
    level's blur. Returns (B, k, nw*nw*nb) L2-normalized descriptors."""
    B, H, W = gauss_img.shape
    dev = gauss_img.device
    gy, gx = torch.gradient(gauss_img, dim=(-2, -1))
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)

    G = opts.patch_grid
    nb = opts.descriptor_bins
    nw = opts.descriptor_width
    lin = (torch.arange(G, dtype=torch.float32, device=dev) - (G - 1) / 2.0) / (G / 2.0)  # [-1, 1)
    off_y, off_x = torch.meshgrid(lin, lin, indexing="ij")
    off_y = off_y.reshape(-1)
    off_x = off_x.reshape(-1)
    spatial_w = torch.exp(-(off_y**2 + off_x**2) / (2 * 0.5**2))

    radius = torch.tensor(sigma, dtype=torch.float32, device=dev) * 6.0
    ys = kp_xy[..., 1:2] + off_y * radius  # (B, k, P)
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

    m = bilinear(mag, ys, xs)
    a = bilinear(ang, ys, xs)
    w = spatial_w * m  # (B, k, P)

    # orientation: a 36-bin circular histogram, smoothed, its first peak
    nb_o = 36
    bins_o = (a + math.pi) / (2 * math.pi) * nb_o
    hist = torch.sum(w[..., None] * _tri_circular(bins_o, nb_o), dim=-2)  # (B, k, 36)
    hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0
    peak = torch.argmax(hist, dim=-1)
    theta = (peak.to(torch.float32) + 0.5) / nb_o * 2 * math.pi - math.pi  # (B, k)

    # rotate the grid and the angles by -theta
    a_rel = torch.remainder(a - theta[..., None] + math.pi, 2 * math.pi)
    cos_t, sin_t = torch.cos(-theta)[..., None], torch.sin(-theta)[..., None]
    ry = off_y * cos_t + off_x * sin_t
    rx = -off_y * sin_t + off_x * cos_t
    by = (ry + 1.0) * 0.5 * nw - 0.5
    bx = (rx + 1.0) * 0.5 * nw - 0.5
    bo = a_rel / (2 * math.pi) * nb

    wy_b = _tri(by, nw)  # (B, k, P, nw)
    wx_b = _tri(bx, nw)
    wo_b = _tri_circular(bo, nb)  # (B, k, P, nb)
    with precise():
        desc = torch.einsum("bkp,bkpi,bkpj,bkpl->bkijl", w, wy_b, wx_b, wo_b)
    v = desc.reshape(B, kp_xy.shape[1], -1)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    v = torch.clamp(v, max=0.2)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def detect_and_describe(images: torch.Tensor, opts: DoGSiftOptions = DoGSiftOptions()) -> tuple:
    """images: (B, H, W) float32 in [0, 1], on the device to run on.

    Returns (coordinates (B, K, 2) as (x, y) input pixels, scales (B, K),
    responses (B, K), mask (B, K), descriptors (B, K, nw*nw*nb)), K =
    max_keypoints, as the reference's ``detect_and_describe`` gives for each
    image of the batch."""
    calls_by_device[images.device.type] += 1
    B = images.shape[0]
    dev = images.device
    S = opts.scales_per_octave
    n_levels = opts.num_octaves * S
    k_per_level = max(1, opts.max_keypoints // n_levels)
    base_sigmas = [opts.sigma0 * (2.0 ** (s / S)) for s in range(S + 3)]

    img = images.to(torch.float32)
    coords, sigmas, scores, valids, descs = [], [], [], [], []
    for o in range(opts.num_octaves):
        H, W = img.shape[-2:]
        with precise():
            gauss = torch.stack([_blur(img, s) for s in base_sigmas], dim=1)  # (B, S+3, H, W)
        score = _detect_octave(gauss, opts)
        scale_mult = 2.0**o
        for s in range(S):
            top_scores, top_idx = stable_topk(score[:, s].reshape(B, -1), k_per_level)
            kp_xy = torch.stack([(top_idx % W).to(torch.float32), (top_idx // W).to(torch.float32)], dim=-1)
            sigma_oct = base_sigmas[s + 1]
            descs.append(_descriptors_at(gauss[:, s + 1], kp_xy, sigma_oct, opts))
            coords.append(kp_xy * scale_mult)
            sigmas.append(torch.full((B, k_per_level), sigma_oct * scale_mult, device=dev))
            scores.append(top_scores)
            valids.append(top_scores > 0)
        img = resize_linear(gauss[:, S], (H // 2, W // 2))

    coords, sigmas, scores, valids, descs = (torch.cat(x, dim=1) for x in (coords, sigmas, scores, valids, descs))
    # the final top-K by response, padded so that the output is exactly K
    K = opts.max_keypoints
    pad = K - scores.shape[1]
    if pad > 0:
        coords = torch.cat([coords, torch.zeros((B, pad, 2), device=dev)], dim=1)
        sigmas = torch.cat([sigmas, torch.ones((B, pad), device=dev)], dim=1)
        scores = torch.cat([scores, torch.full((B, pad), -1.0, device=dev)], dim=1)
        valids = torch.cat([valids, torch.zeros((B, pad), dtype=torch.bool, device=dev)], dim=1)
        descs = torch.cat([descs, torch.zeros((B, pad, descs.shape[-1]), device=dev)], dim=1)
    sel_scores, sel = stable_topk(torch.where(valids, scores, torch.full((), -1.0, device=dev)), K)

    def take(x):
        return torch.gather(x, 1, sel.view(B, K, *([1] * (x.dim() - 2))).expand(B, K, *x.shape[2:]))

    return take(coords), take(sigmas), torch.clamp(sel_scores, min=0.0), sel_scores > 0, take(descs)


class DoGSift:
    """Detector-descriptor component: ``detect_batch(images)`` takes a
    (B, H, W) batch (numpy, or a tensor on the device to run on) and
    returns (coordinates (B, K, 2), mask (B, K), descriptors (B, K, 128))
    as numpy, the registry's detector contract."""

    def __init__(self, options: DoGSiftOptions = DoGSiftOptions()):
        self.options = options
        self.max_keypoints = options.max_keypoints

    def __call__(self, image, device="cuda") -> tuple:
        """One (H, W) image (numpy or a tensor) -> (Keypoints (K,),
        descriptors (K, 128)) on ``device``: the reference's per-image call,
        through the batched detector. The card by default; raises without
        one (``numerics.resolve_device``)."""
        image = torch.as_tensor(image, device=resolve_device(device))
        coords, scales, responses, mask, descs = detect_and_describe(image[None], self.options)
        return Keypoints(coordinates=coords[0], scales=scales[0], responses=responses[0], mask=mask[0]), descs[0]

    def detect_batch(self, images) -> tuple:
        coords, _scales, _responses, mask, descs = detect_and_describe(torch.as_tensor(images), self.options)
        return coords.cpu().numpy(), mask.cpu().numpy(), descs.cpu().numpy()
