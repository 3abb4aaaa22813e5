"""SuperGlue, the attentional graph matcher, in the public checkpoint's layout.

Port of gtsfm_tpu/frontend/matchers/superglue.py (Sarlin et al., CVPR
2020), with the module names of the official superglue_{indoor,outdoor}.pth
state_dicts:

- kenc: the keypoint encoder, an MLP of 1x1 convs (3, 32, 64, 128, 256,
  256) over [x, y, score] with BatchNorm (applied folded, as the reference
  folds it) and ReLU; its output is added to the descriptors;
- gnn: 18 alternating self and cross AttentionalPropagation layers, each a
  4-head attention (q, k, v projections and a merge; the heads are the
  inner stride of the channel axis, as the official ``view(b, dim, heads,
  n)``) and a residual MLP (512, 512, 256) on [x, message];
- final_proj and the learned dustbin score ``bin_score``;
- log-domain optimal transport with a dustbin row and column, 20
  iterations; padded keypoints get no marginal mass (the true counts are
  the marginals), so a padded problem gives the unpadded result; then the
  mutual maximum above the threshold.

Float32 with TF32 off, in chunks of ``PAIR_SCORE_BYTES`` of attention
scores (the reference vmaps the whole batch; its (P, 4, K, K) scores at
P=256, K=2048 take 17 GB). ``load_torch_weights`` reads an official
checkpoint; ``utils/convert.superglue_state_dict`` carries the reference's
params across.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gtsfm_tpu_torch.utils.numerics import precise
from gtsfm_tpu_torch.utils.torch_io import load_public_state_dict, load_torch_checkpoint

# float32 attention scores a pair chunk may hold
PAIR_SCORE_BYTES = 1 << 30
MASK_FILL = -1e9


class SuperGlueOptions(NamedTuple):
    dim: int = 256
    num_layers: int = 9  # self + cross pairs (18 propagation layers)
    num_heads: int = 4
    sinkhorn_iterations: int = 20
    match_threshold: float = 0.2
    encoder_layers: tuple = (32, 64, 128, 256)


class FoldedBatchNorm1d(nn.BatchNorm1d):
    """Eval-mode BatchNorm1d as x * scale + shift (the reference's fold)."""

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None] + shift[:, None]


def _mlp(channels: list) -> nn.Sequential:
    """1x1 convs with BatchNorm and ReLU after all but the last (the
    official ``MLP``: conv at 3i, BatchNorm at 3i + 1)."""
    layers = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], kernel_size=1, bias=True))
        if i < len(channels) - 1:
            layers += [FoldedBatchNorm1d(channels[i]), nn.ReLU()]
    return nn.Sequential(*layers)


class KeypointEncoder(nn.Module):
    def __init__(self, dim: int, layers: tuple):
        super().__init__()
        self.encoder = _mlp([3] + list(layers) + [dim])

    def forward(self, kpts, scores):
        """kpts (B, N, 2), scores (B, N) -> (B, dim, N)."""
        return self.encoder(torch.cat([kpts.transpose(1, 2), scores[:, None]], dim=1))


class MultiHeadedAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        self.num_heads = num_heads
        self.merge = nn.Conv1d(d_model, d_model, kernel_size=1)
        self.proj = nn.ModuleList([nn.Conv1d(d_model, d_model, kernel_size=1) for _ in range(3)])

    def forward(self, x, source, src_mask):
        """x (B, d, N), source (B, d, M), src_mask (B, M) -> (B, d, N)."""
        B, d, _ = x.shape
        dh = d // self.num_heads
        q, k, v = (l(a).view(B, dh, self.num_heads, -1) for l, a in zip(self.proj, (x, source, source)))
        s = torch.einsum("bdhn,bdhm->bhnm", q, k) / dh**0.5
        s = torch.where(src_mask[:, None, None, :], s, MASK_FILL)
        ctx = torch.einsum("bhnm,bdhm->bdhn", torch.softmax(s, dim=-1), v)
        return self.merge(ctx.reshape(B, d, -1))


class AttentionalPropagation(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, dim)
        self.mlp = _mlp([2 * dim, 2 * dim, dim])

    def forward(self, x, source, src_mask):
        return self.mlp(torch.cat([x, self.attn(x, source, src_mask)], dim=1))


class AttentionalGNN(nn.Module):
    def __init__(self, dim: int, num_layers: int, num_heads: int):
        super().__init__()
        self.layers = nn.ModuleList([AttentionalPropagation(dim, num_heads) for _ in range(2 * num_layers)])

    def forward(self, x0, x1, mask0, mask1):
        for i, layer in enumerate(self.layers):
            if i % 2 == 1:  # cross
                src0, src1, m0, m1 = x1, x0, mask1, mask0
            else:
                src0, src1, m0, m1 = x0, x1, mask0, mask1
            x0, x1 = x0 + layer(x0, src0, m0), x1 + layer(x1, src1, m1)
        return x0, x1


def log_sinkhorn(Z, log_mu, log_nu, iters: int):
    """Log-domain Sinkhorn normalization of Z (B, m, n) to the marginals
    log_mu (B, m), log_nu (B, n)."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores, alpha, iters: int, row_mask, col_mask):
    """Dustbin-augmented entropic optimal transport in log space, scores
    (B, m, n) -> (B, m + 1, n + 1). The masks mark the real keypoints: their
    counts are the marginals, and padded slots get no mass (-inf) and no
    dustbin coupling."""
    B, m, n = scores.shape
    ms = row_mask.sum(dim=1).to(scores.dtype)
    ns = col_mask.sum(dim=1).to(scores.dtype)
    alpha = alpha.to(scores.dtype)
    bins0 = torch.where(row_mask[:, :, None], alpha, MASK_FILL)
    bins1 = torch.where(col_mask[:, None, :], alpha, MASK_FILL)
    couplings = torch.cat([torch.cat([scores, bins0], dim=2),
                           torch.cat([bins1, alpha.expand(B, 1, 1)], dim=2)], dim=1)
    norm = -torch.log(ms + ns)
    row_m = torch.where(row_mask, norm[:, None], -torch.inf)
    col_m = torch.where(col_mask, norm[:, None], -torch.inf)
    log_mu = torch.cat([row_m, (torch.log(ns) + norm)[:, None]], dim=1)
    log_nu = torch.cat([col_m, (torch.log(ms) + norm)[:, None]], dim=1)
    return log_sinkhorn(couplings, log_mu, log_nu, iters) - norm[:, None, None]


class SuperGlueNet(nn.Module):
    def __init__(self, opts: SuperGlueOptions = SuperGlueOptions()):
        super().__init__()
        self.opts = opts
        self.kenc = KeypointEncoder(opts.dim, opts.encoder_layers)
        self.gnn = AttentionalGNN(opts.dim, opts.num_layers, opts.num_heads)
        self.final_proj = nn.Conv1d(opts.dim, opts.dim, kernel_size=1)
        self.register_parameter("bin_score", nn.Parameter(torch.tensor(1.0)))

    def forward(self, desc0, desc1, kpts0, kpts1, scores0, scores1, mask0, mask1):
        """desc (B, K, dim), kpts (B, K, 2) normalized, scores (B, K),
        masks (B, K) -> the (B, K0 + 1, K1 + 1) log-assignment."""
        x0 = desc0.transpose(1, 2) + self.kenc(kpts0, scores0)
        x1 = desc1.transpose(1, 2) + self.kenc(kpts1, scores1)
        x0, x1 = self.gnn(x0, x1, mask0, mask1)
        md0, md1 = self.final_proj(x0), self.final_proj(x1)
        s = torch.einsum("bdm,bdn->bmn", md0, md1) / self.opts.dim**0.5
        s = torch.where(mask0[:, :, None] & mask1[:, None, :], s, MASK_FILL)
        return log_optimal_transport(s, self.bin_score, self.opts.sinkhorn_iterations, mask0, mask1)


def normalize_keypoints_sg(coords: torch.Tensor, image_size) -> torch.Tensor:
    """The official normalization: shift by size/2, divide by 0.7 max(size);
    ``image_size`` is (w, h)."""
    size = torch.as_tensor(image_size, dtype=torch.float32, device=coords.device)
    return (coords - size / 2.0) / (torch.max(size) * 0.7)


class SuperGlueMatcher:
    """match_batch(desc0, desc1, coords0, coords1, mask0, mask1, image_size)
    -> (match_idx i32 (P, K0), match_mask bool (P, K0), scores f32 (P, K0)),
    the precomputed-match inputs of two_view.run_two_view_batch, on the
    inputs' device. Keypoint scores default to the masks, as in the
    reference. ``state_dict`` is an official-layout state_dict; without one
    the net keeps a random init of seed 0."""

    def __init__(self, options: SuperGlueOptions = SuperGlueOptions(), state_dict=None):
        self.options = options
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.net = SuperGlueNet(options)
        if state_dict is not None:
            load_public_state_dict(self.net, state_dict)
        self.net.eval().requires_grad_(False)

    def _postprocess(self, z, mask0, mask1):
        zi = z[:, :-1, :-1]
        zi = torch.where(mask0[:, :, None] & mask1[:, None, :], zi, MASK_FILL)
        nn12 = torch.argmax(zi, dim=2)
        nn21 = torch.argmax(zi, dim=1)
        mutual = torch.arange(zi.shape[1], device=z.device) == torch.gather(nn21, 1, nn12)
        score = torch.exp(torch.amax(zi, dim=2))
        ok = mask0 & mutual & (score > self.options.match_threshold)
        return torch.where(ok, nn12, -1).to(torch.int32), ok, score.to(torch.float32)

    def log_assignment(self, desc0, desc1, coords0, coords1, mask0, mask1, image_size,
                       kp_scores0=None, kp_scores1=None):
        """The net's log-assignment (P, K0 + 1, K1 + 1) for pixel
        coordinates, in pair chunks."""
        self.net.to(desc0.device)
        if kp_scores0 is None:
            kp_scores0, kp_scores1 = mask0.to(torch.float32), mask1.to(torch.float32)
        c0 = normalize_keypoints_sg(coords0, image_size)
        c1 = normalize_keypoints_sg(coords1, image_size)
        P, K0 = mask0.shape
        chunk = max(1, PAIR_SCORE_BYTES // (4 * self.options.num_heads * K0 * mask1.shape[1]))
        out = []
        with torch.no_grad(), precise():
            for s in range(0, P, chunk):
                sl = slice(s, s + chunk)
                out.append(self.net(desc0[sl], desc1[sl], c0[sl], c1[sl], kp_scores0[sl], kp_scores1[sl],
                                    mask0[sl], mask1[sl]))
        return torch.cat(out)

    def match_batch(self, desc0, desc1, coords0, coords1, mask0, mask1, image_size,
                    kp_scores0=None, kp_scores1=None):
        """Batched over pairs: desc (P, K, D), coords (P, K, 2) pixels,
        masks (P, K) bool, image_size (w, h)."""
        z = self.log_assignment(desc0, desc1, coords0, coords1, mask0, mask1, image_size, kp_scores0, kp_scores1)
        return self._postprocess(z, mask0, mask1)

    def match(self, desc0, desc1, coords0, coords1, mask0, mask1, image_size):
        """One pair: desc (K, D), coords (K, 2), masks (K,) -> (K0,) each."""
        out = self.match_batch(desc0[None], desc1[None], coords0[None], coords1[None], mask0[None], mask1[None],
                               image_size)
        return tuple(a[0] for a in out)


def load_torch_weights(path: str) -> dict:
    """An official SuperGlue checkpoint (superglue_{indoor,outdoor}.pth) ->
    its state_dict."""
    return load_torch_checkpoint(path)
