"""MASt3R, the two-view feed-forward correspondence generator.

Port of gtsfm_tpu/frontend/mast3r.py (AsymmetricMASt3R: symmetric
inference and reciprocal nearest-neighbour matching), in the layout of the
public MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth checkpoint as
the reference reads it:

- encoder: ViT-Large, a 16x16 patch embedding to 1024 channels, 24 blocks
  of 16 heads with croco's RoPE100 2D rotary positions (no learned
  position embedding), LayerNorm eps 1e-6;
- decoder: ``decoder_embed`` (1024 -> 768) and two asymmetric 12-block,
  768-wide, 12-head decoders (``dec_blocks`` for view 1, ``dec_blocks2``
  for view 2), each block RoPE self-attention, RoPE cross-attention to the
  other view's normed tokens and an MLP;
- ``downstream_head1.head_local_features``: an MLP on [encoder tokens,
  decoder tokens] to (24 + 1) x 16^2 values a token, pixel-shuffled to a
  unit 24-d descriptor and a confidence (1 + expm1(relu)) per pixel.

The DPT pts3d head of the checkpoint is not built: the correspondence path
reads only the descriptors and confidences, and ``load_torch_weights``
skips its weights, as the reference does.

``symmetric_inference`` runs both images through the encoder and both
decoder directions, giving four descriptor maps; ``reciprocal_nn`` seeds a
subsampled pixel grid of one map, walks argmax descriptor hops A -> B -> A
for a fixed number of rounds (equal scores: the lowest index) and keeps the
fixed points; ``Mast3rCorrespondenceGenerator`` runs it from both maps of
both directions, merges duplicates on the host (the most confident first)
and maps the pixels back to the original images. It encodes each image
once a call and reuses its tokens in every pair that holds it, where the
reference encodes both images again for every pair: the same values, since
the encoder sees one image at a time in both. Float32 with TF32 off; the
hops' products run in chunks of ``NN_SCORE_BYTES``.

Also the 2D rotary embedding (croco's RoPE2D, ``apply_rope2d``), which
VGGT's blocks use too (frontend/vggt.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.frontend.detectors.dog_sift import resize_linear
from gtsfm_tpu_torch.utils.numerics import precise

PATCH = 16
# float32 scores of one chunk of reciprocal_nn's hop products
NN_SCORE_BYTES = 1 << 30


class MASt3ROptions(NamedTuple):
    enc_dim: int = 1024
    enc_depth: int = 24
    enc_heads: int = 16
    dec_dim: int = 768
    dec_depth: int = 12
    dec_heads: int = 12
    mlp_ratio: int = 4
    local_feat_dim: int = 24
    rope_base: float = 100.0
    # matching
    subsample: int = 8
    nn_iterations: int = 6
    max_correspondences: int = 1024
    conf_threshold: float = 0.0
    # inference resolution (the long edge, as the reference's 512 pipeline)
    long_edge: int = 512


def _rope_cos_sin(pos: torch.Tensor, dim_half: int, base: float) -> tuple:
    """pos (N,) integer positions -> (cos, sin), each (N, dim_half), the
    frequencies repeated once."""
    freqs = 1.0 / (base ** (torch.arange(0, dim_half, 2, dtype=torch.float32, device=pos.device) / dim_half))
    ang = pos[:, None].to(torch.float32) * freqs[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_tables(positions: torch.Tensor, dim_half: int, base: float) -> tuple:
    """positions (N, 2) integer (y, x) -> (cos_y, sin_y, cos_x, sin_x), each
    (N, dim_half): the rotations of tokens whose halves are dim_half wide."""
    return _rope_cos_sin(positions[:, 0], dim_half, base) + _rope_cos_sin(positions[:, 1], dim_half, base)


def rotate_rope2d(tokens: torch.Tensor, tables: tuple) -> torch.Tensor:
    """tokens (..., N, D), D even, split into (y, x) halves, rotated by
    rope_tables' (cos_y, sin_y, cos_x, sin_x)."""
    cy, sy, cx, sx = tables
    dh = tokens.shape[-1] // 2
    ty, tx = tokens[..., :dh], tokens[..., dh:]
    ty = ty * cy + _rotate_half(ty) * sy
    tx = tx * cx + _rotate_half(tx) * sx
    return torch.cat([ty, tx], dim=-1)


def apply_rope2d(tokens: torch.Tensor, positions: torch.Tensor, base: float) -> torch.Tensor:
    """tokens (..., N, D), D even, split into (y, x) halves; positions (N, 2)
    integer (y, x)."""
    return rotate_rope2d(tokens, rope_tables(positions, tokens.shape[-1] // 2, base))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _attend(q, k, v, qrope, krope, num_heads: int):
    """Multi-head attention with RoPE: q (B, N, D), k and v (B, M, D), the
    queries' and keys' rope_tables -> (B, N, D)."""
    B, N, D = q.shape
    q, k, v = (a.reshape(B, a.shape[1], num_heads, D // num_heads).transpose(1, 2) for a in (q, k, v))
    q = rotate_rope2d(q, qrope)
    k = rotate_rope2d(k, krope)
    att = torch.softmax(q @ k.transpose(-1, -2) * (q.shape[-1] ** -0.5), dim=-1)
    return (att @ v).transpose(1, 2).reshape(B, N, D)


class _SelfAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, rope, num_heads):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(_attend(q, k, v, rope, rope, num_heads))


class _CrossAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, y, xrope, yrope, num_heads):
        return self.proj(_attend(self.projq(x), self.projk(y), self.projv(y), xrope, yrope, num_heads))


class _EncBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _SelfAttention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, mlp_ratio * dim)

    def forward(self, x, rope, num_heads):
        x = x + self.attn(self.norm1(x), rope, num_heads)
        return x + self.mlp(self.norm2(x))


class _DecBlock(nn.Module):
    """croco's DecoderBlock: self-attention, cross-attention to the other
    view's normed tokens, MLP."""

    def __init__(self, dim: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _SelfAttention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.cross_attn = _CrossAttention(dim)
        self.norm_y = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, mlp_ratio * dim)

    def forward(self, x, y, xrope, yrope, num_heads):
        x = x + self.attn(self.norm1(x), xrope, num_heads)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), xrope, yrope, num_heads)
        return x + self.mlp(self.norm3(x))


def _grid_positions(gh: int, gw: int, device) -> torch.Tensor:
    yy, xx = torch.meshgrid(torch.arange(gh, device=device), torch.arange(gw, device=device), indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


class MASt3RNet(nn.Module):
    def __init__(self, opts: MASt3ROptions = MASt3ROptions()):
        super().__init__()
        self.opts = opts
        De, Dd = opts.enc_dim, opts.dec_dim
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, De, PATCH, stride=PATCH)
        self.enc_blocks = nn.ModuleList([_EncBlock(De, opts.mlp_ratio) for _ in range(opts.enc_depth)])
        self.enc_norm = nn.LayerNorm(De, eps=1e-6)
        self.decoder_embed = nn.Linear(De, Dd)
        self.dec_blocks = nn.ModuleList([_DecBlock(Dd, opts.mlp_ratio) for _ in range(opts.dec_depth)])
        self.dec_blocks2 = nn.ModuleList([_DecBlock(Dd, opts.mlp_ratio) for _ in range(opts.dec_depth)])
        self.dec_norm = nn.LayerNorm(Dd, eps=1e-6)
        cat_d = De + Dd
        self.downstream_head1 = nn.Module()
        self.downstream_head1.head_local_features = nn.Module()
        self.downstream_head1.head_local_features.proj = nn.Sequential(
            nn.Linear(cat_d, 4 * cat_d), nn.GELU(), nn.Linear(4 * cat_d, (opts.local_feat_dim + 1) * PATCH * PATCH))

    def encode(self, images):
        """images (B, 3, H, W) in [-1, 1] -> (tokens (B, N, De), positions
        (N, 2))."""
        o = self.opts
        x = self.patch_embed.proj(images)
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)
        pos = _grid_positions(gh, gw, x.device)
        rope = rope_tables(pos, o.enc_dim // o.enc_heads // 2, o.rope_base)  # one set for every block
        for blk in self.enc_blocks:
            x = blk(x, rope, o.enc_heads)
        return self.enc_norm(x), pos

    def decode(self, f1, f2, pos1, pos2):
        """View 1 through dec_blocks attending to view 2, view 2 through
        dec_blocks2 attending to view 1 -> their normed final tokens."""
        o = self.opts
        r1, r2 = (rope_tables(p, o.dec_dim // o.dec_heads // 2, o.rope_base) for p in (pos1, pos2))
        x1, x2 = self.decoder_embed(f1), self.decoder_embed(f2)
        for b1, b2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = b1(x1, x2, r1, r2, o.dec_heads), b2(x2, x1, r2, r1, o.dec_heads)
        return self.dec_norm(x1), self.dec_norm(x2)

    def local_features(self, enc_tokens, dec_tokens, gh: int, gw: int):
        """-> (unit descriptors (B, H, W, D), confidences (B, H, W))."""
        B = enc_tokens.shape[0]
        D1 = self.opts.local_feat_dim + 1
        y = self.downstream_head1.head_local_features.proj(torch.cat([enc_tokens, dec_tokens], dim=-1))
        y = y.reshape(B, gh, gw, D1, PATCH, PATCH).permute(0, 1, 4, 2, 5, 3).reshape(B, gh * PATCH, gw * PATCH, D1)
        desc = y[..., :-1]
        desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
        return desc, 1.0 + torch.expm1(F.relu(y[..., -1]))

    def symmetric_inference(self, img1, img2):
        """img (B, 3, H, W) -> ((desc11, desc21, desc22, desc12), their
        confidences): both decoder directions, as the reference."""
        return self.symmetric_decode(self.encode(img1), self.encode(img2), img1.shape[-2] // PATCH,
                                     img1.shape[-1] // PATCH)

    def symmetric_decode(self, enc1, enc2, gh: int, gw: int):
        """symmetric_inference from both images' ``encode`` outputs on a
        (gh, gw) patch grid."""
        (f1, pos1), (f2, pos2) = enc1, enc2
        d11, d21 = self.decode(f1, f2, pos1, pos2)
        d22, d12 = self.decode(f2, f1, pos2, pos1)
        out = [self.local_features(f, d, gh, gw) for f, d in ((f1, d11), (f2, d21), (f2, d22), (f1, d12))]
        return tuple(o[0] for o in out), tuple(o[1] for o in out)


def _nn(q: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Index of each query row's largest product with f's rows (the first
    on ties), in chunks of NN_SCORE_BYTES."""
    rows = max(1, NN_SCORE_BYTES // (4 * f.shape[0]))
    return torch.cat([torch.argmax(q[s : s + rows] @ f.T, dim=-1) for s in range(0, q.shape[0], rows)])


def reciprocal_nn(descA: torch.Tensor, descB: torch.Tensor, subsample: int, iterations: int):
    """descA, descB (H, W, D) unit descriptors -> (idxA, idxB, converged)
    flat pixel indices, one slot per seed of the subsampled grid of A: the
    last hop's pair and whether it is a fixed point (mutual NNs)."""
    H, W, D = descA.shape
    fa = descA.reshape(-1, D)
    fb = descB.reshape(-1, D)
    ys = torch.arange(subsample // 2, H, subsample, device=fa.device)
    xs = torch.arange(subsample // 2, W, subsample, device=fa.device)
    idx_a = (ys[:, None] * W + xs[None, :]).reshape(-1)
    for _ in range(iterations):
        sb = _nn(fa[idx_a], fb)
        sa = _nn(fb[sb], fa)
        converged = sa == idx_a
        idx_a = sa
    return idx_a, sb, converged


def _merge_pairs(idx1, idx2, conf, max_out: int):
    """Dedup (idx1, idx2) pairs on the host, the most confident first."""
    key = idx1.astype(np.int64) * (2**31) + idx2.astype(np.int64)
    order = np.argsort(-conf, kind="stable")
    key, idx1, idx2, conf = key[order], idx1[order], idx2[order], conf[order]
    _, first = np.unique(key, return_index=True)
    first = np.sort(first)[:max_out]
    return idx1[first], idx2[first], conf[first]


def options_from_state_dict(sd, opts: MASt3ROptions = MASt3ROptions()) -> MASt3ROptions:
    """``opts`` with widths, depths and the descriptor width read off a
    state_dict's shapes; heads of 64 channels where the widths divide (the
    published 1024 / 16 and 768 / 12), else ``opts``' heads."""
    De = int(sd["patch_embed.proj.weight"].shape[0])
    Dd = int(sd["decoder_embed.weight"].shape[0])
    n_enc = len({k.split(".")[1] for k in sd if k.startswith("enc_blocks.")})
    n_dec = len({k.split(".")[1] for k in sd if k.startswith("dec_blocks.")})
    out_d = int(sd["downstream_head1.head_local_features.proj.2.bias"].shape[0])
    return opts._replace(enc_dim=De, dec_dim=Dd, enc_depth=n_enc, dec_depth=n_dec,
                         enc_heads=De // 64 if De % 64 == 0 else opts.enc_heads,
                         dec_heads=Dd // 64 if Dd % 64 == 0 else opts.dec_heads,
                         local_feat_dim=out_d // (PATCH * PATCH) - 1)


def load_torch_weights(path: str, opts: MASt3ROptions = MASt3ROptions()):
    """The public AsymmetricMASt3R checkpoint -> (the state_dict of the
    parts the correspondence path reads, options read off its shapes). The
    DPT pts3d head's weights are skipped."""
    from gtsfm_tpu_torch.utils.torch_io import load_torch_checkpoint

    ckpt = load_torch_checkpoint(path)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    opts = options_from_state_dict(sd, opts)
    keep = ("patch_embed.", "enc_blocks.", "enc_norm.", "decoder_embed.", "dec_blocks.", "dec_blocks2.",
            "dec_norm.", "downstream_head1.head_local_features.")
    return {k: v for k, v in sd.items() if k.startswith(keep)}, opts


class Mast3rCorrespondenceGenerator:
    """A direct generator: generate(images, pairs) -> {(i1, i2): (uv1, uv2)}
    in the original images' pixels, the net on ``device``. ``state_dict``
    (or the checkpoint at ``weights_path``) is in the public layout; without
    one the net keeps a random init of seed 0."""

    def __init__(self, options: MASt3ROptions = MASt3ROptions(), weights_path: Optional[str] = None,
                 state_dict=None, device="cuda"):
        if weights_path is not None and state_dict is None:
            state_dict, options = load_torch_weights(weights_path, options)
        self.options = options
        self.device = torch.device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.net = MASt3RNet(options)
        if state_dict is not None:
            self.net.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        self.net.eval().requires_grad_(False).to(self.device)

    def _preprocess(self, image: np.ndarray):
        """(H, W) in [0, 1] or (H, W, 3) -> the net's input (1, 3, h, w) in
        [-1, 1] (the long edge resized to ``long_edge``, antialiased, each
        side rounded to the patch grid) and the (x, y) scale back to the
        original pixels."""
        if image.ndim == 2:
            image = np.repeat(image[..., None], 3, axis=-1)
        H0, W0 = image.shape[:2]
        s = self.options.long_edge / max(H0, W0)
        H = max(PATCH, int(round(H0 * s / PATCH)) * PATCH)
        W = max(PATCH, int(round(W0 * s / PATCH)) * PATCH)
        x = torch.as_tensor(np.ascontiguousarray(image.transpose(2, 0, 1)), dtype=torch.float32,
                            device=self.device)
        return resize_linear(x, (H, W))[None] * 2.0 - 1.0, (W0 / W, H0 / H)

    def generate(self, images, pairs) -> dict:
        """images: (H, W[, 3]) float arrays, one per image; pairs (P, 2)."""
        opts = self.options
        out = {}
        with torch.no_grad(), precise():
            prep = {i: self._preprocess(np.asarray(images[i])) for i in sorted({int(i) for ij in pairs for i in ij})}
            enc = {}
            for i1, i2 in np.asarray(pairs).tolist():
                x1, (sx1, sy1) = prep[i1]
                x2, (sx2, sy2) = prep[i2]
                for i, x in ((i1, x1), (i2, x2)):
                    if i not in enc:
                        enc[i] = self.net.encode(x)
                descs, confs = self.net.symmetric_decode(enc[i1], enc[i2], x1.shape[-2] // PATCH,
                                                         x1.shape[-1] // PATCH)
                d11, d21, d22, d12 = (d[0] for d in descs)
                c11, c21, c22, c12 = (c[0].reshape(-1).cpu().numpy() for c in confs)
                W1, W2 = d11.shape[1], d22.shape[1]
                idx1_all, idx2_all, conf_all = [], [], []
                for A, B, CA, CB in ((d11, d21, c11, c21), (d12, d22, c12, c22)):
                    for a2b in (True, False):
                        if a2b:
                            ia, ib, ok = reciprocal_nn(A, B, opts.subsample, opts.nn_iterations)
                        else:
                            ib, ia, ok = reciprocal_nn(B, A, opts.subsample, opts.nn_iterations)
                        ia, ib, ok = ia.cpu().numpy(), ib.cpu().numpy(), ok.cpu().numpy()
                        q = np.sqrt(CA[ia] * CB[ib])
                        keep = ok & (q > opts.conf_threshold)
                        idx1_all.append(ia[keep])
                        idx2_all.append(ib[keep])
                        conf_all.append(q[keep])
                if sum(len(a) for a in idx1_all) == 0:
                    out[(i1, i2)] = (np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32))
                    continue
                idx1, idx2, _ = _merge_pairs(np.concatenate(idx1_all), np.concatenate(idx2_all),
                                             np.concatenate(conf_all), opts.max_correspondences)
                uv1 = np.stack([(idx1 % W1 + 0.5) * sx1, (idx1 // W1 + 0.5) * sy1], -1)
                uv2 = np.stack([(idx2 % W2 + 0.5) * sx2, (idx2 // W2 + 0.5) * sy2], -1)
                out[(i1, i2)] = (uv1.astype(np.float32), uv2.astype(np.float32))
        return out
