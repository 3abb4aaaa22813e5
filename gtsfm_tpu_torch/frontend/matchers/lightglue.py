"""LightGlue attention matcher in the official checkpoint layout.

Port of gtsfm_tpu/frontend/matchers/lightglue.py (the public LightGlue
architecture, Lindenberger et al., ICCV 2023), batched over an explicit
pair axis: descriptors (P, K, D), coordinates (P, K, 2), masks (P, K).

- input_proj: Linear(input_dim -> dim);
- posenc: learnable Fourier encoding of the normalized keypoint coordinates
  (Wr: 2 -> head_dim/2, rotary cos/sin repeat-interleaved x2);
- num_layers transformer layers (an ``nn.ModuleList``), each a SelfBlock
  (fused Wqkv, rotary q/k, out_proj, ffn on concat[x, message]) shared by
  both images, then a CrossBlock (shared to_qk, to_v, to_out, ffn);
- MatchAssignment: final_proj + matchability, the sigmoid-log-double-
  softmax assignment with a dustbin row and column. Every layer has its
  head, as the official checkpoint does; the forward uses the last one.

Parameter names are the official state_dict keys, so a checkpoint loads
with ``load_state_dict`` (``load_torch_weights`` drops the early-exit
``token_confidence`` heads, which the forward does not use).

Attention goes through fused_attention.py: on the merged (K, h*dh) layout
where ``_merged_heads_ok(dim, heads)`` holds, as the reference routes it,
and on the split (h, K, dh) layout otherwise. On a CUDA tensor every call
launches the hand-written kernel (any K; the reference's TPU-only
conditions on K do not carry over); on a CPU tensor every call runs the
plain version.

Precision follows ``mixed_precision`` as the reference does: the residual
stream and every linear of the transformer run in bf16 (inputs, weights
and biases cast to bf16), the LayerNorms inside the ffns normalize in
float32, and the input projection, positional encoding and assignment run
in float32. The forward runs under ``numerics.precise()``, so the float32
parts are not TF32 and bf16 products are summed in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa
from gtsfm_tpu_torch.utils.numerics import precise

LN_EPS = 1e-6  # the reference's LayerNorm (flax's default epsilon)
MASK_FILL = -1e9


class LightGlueOptions(NamedTuple):
    dim: int = 256
    num_layers: int = 9
    num_heads: int = 4
    match_threshold: float = 0.1
    input_dim: int = 256  # SuperPoint descriptors
    # bf16 residual stream and transformer linears (float32 LayerNorm and
    # assignment); off for float32 parity tests
    mixed_precision: bool = True


def _merged_heads_ok(dim: int, heads: int) -> bool:
    """The reference's merged-layout condition (two heads per 128-lane
    column block); kept so that the port takes the same route."""
    return heads % 2 == 0 and (2 * (dim // heads)) % 128 == 0


def _dense(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """A linear layer computed in ``dtype``: input, weight and bias cast to
    it, as flax's Dense(dtype=...) promotes them."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _ffn(seq: nn.Sequential, x: torch.Tensor, dtype) -> torch.Tensor:
    """Sequential[Linear(2d, 2d), LayerNorm(2d), GELU, Linear(2d, d)]: the
    LayerNorm and the exact GELU in float32, the linears in ``dtype``."""
    h = _dense(seq[0], x, dtype).float()
    h = F.layer_norm(h, h.shape[-1:], seq[1].weight.float(), seq[1].bias.float(), eps=LN_EPS)
    return _dense(seq[3], F.gelu(h), dtype)


def _make_ffn(dim: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(2 * dim, 2 * dim), nn.LayerNorm(2 * dim, eps=LN_EPS), nn.GELU(),
        nn.Linear(2 * dim, dim),
    )


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(..., 2k): pairwise (even, odd) -> (-odd, even), the official
    rotate_half."""
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


class FourierPosEnc(nn.Module):
    """LearnableFourierPositionalEncoding(M=2, head_dim): Wr (2 -> F/2, no
    bias); cos and sin each repeat-interleaved x2 to head_dim."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.Wr = nn.Linear(2, head_dim // 2, bias=False)

    def forward(self, coords: torch.Tensor):  # (P, K, 2) -> cos, sin (P, K, head_dim)
        proj = F.linear(coords.float(), self.Wr.weight.float())
        return torch.cos(proj).repeat_interleave(2, dim=-1), torch.sin(proj).repeat_interleave(2, dim=-1)


class SelfBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.Wqkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ffn = _make_ffn(dim)

    def forward(self, x, cos, sin, mask, dtype):
        P, K, d = x.shape
        h = self.heads
        # rotary in the compute dtype, as the reference casts cos/sin
        cos = cos.to(dtype)
        sin = sin.to(dtype)
        # official layout: unflatten(-1, (heads, dh, 3))
        qkv = _dense(self.Wqkv, x, dtype).reshape(P, K, h, d // h, 3)
        if _merged_heads_ok(d, h):
            # heads stay column slices of (K, d); rotary pairs adjacent lanes
            # and dh is even, so head-tiled cos/sin is per-head exact
            q, k, v = (qkv[..., i].reshape(P, K, d) for i in range(3))
            cos_t = cos.repeat(1, 1, h)
            sin_t = sin.repeat(1, 1, h)
            q = q * cos_t + _rotate_half(q) * sin_t
            k = k * cos_t + _rotate_half(k) * sin_t
            ctx = fa.fused_attention_merged(q, k, v, h, kv_mask=mask)
        else:
            q, k, v = (qkv[..., i].transpose(1, 2) for i in range(3))  # (P, h, K, dh)
            q = q * cos[:, None] + _rotate_half(q) * sin[:, None]
            k = k * cos[:, None] + _rotate_half(k) * sin[:, None]
            ctx = fa.merge_heads(fa.fused_attention(q, k, v, kv_mask=mask))
        message = _dense(self.out_proj, ctx, dtype)
        return x + _ffn(self.ffn, torch.cat([x, message.to(x.dtype)], dim=-1), dtype)


class CrossBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_qk = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)
        self.ffn = _make_ffn(dim)

    def forward(self, x0, x1, mask0, mask1, dtype):
        d, h = x0.shape[-1], self.heads
        qk0, qk1 = _dense(self.to_qk, x0, dtype), _dense(self.to_qk, x1, dtype)
        v0, v1 = _dense(self.to_v, x0, dtype), _dense(self.to_v, x1, dtype)
        if _merged_heads_ok(d, h):
            ctx0, ctx1 = fa.fused_cross_attention_merged(qk0, qk1, v0, v1, h, mask0=mask0, mask1=mask1)
        else:
            ctx0, ctx1 = fa.fused_cross_attention(*(fa.split_heads(x, h) for x in (qk0, qk1, v0, v1)),
                                                  mask0=mask0, mask1=mask1)
            ctx0, ctx1 = fa.merge_heads(ctx0), fa.merge_heads(ctx1)
        m0 = _dense(self.to_out, ctx0, dtype)
        m1 = _dense(self.to_out, ctx1, dtype)
        x0 = x0 + _ffn(self.ffn, torch.cat([x0, m0.to(x0.dtype)], dim=-1), dtype)
        x1 = x1 + _ffn(self.ffn, torch.cat([x1, m1.to(x1.dtype)], dim=-1), dtype)
        return x0, x1


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.self_attn = SelfBlock(dim, heads)
        self.cross_attn = CrossBlock(dim, heads)

    def forward(self, x0, x1, enc0, enc1, mask0, mask1, dtype):
        x0 = self.self_attn(x0, *enc0, mask0, dtype)
        x1 = self.self_attn(x1, *enc1, mask1, dtype)
        return self.cross_attn(x0, x1, mask0, mask1, dtype)


class MatchAssignment(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.matchability = nn.Linear(dim, 1)
        self.final_proj = nn.Linear(dim, dim)

    def forward(self, x0, x1):
        """x0 (P, m, d), x1 (P, n, d) float32 -> (log-assignment
        (P, m+1, n+1), matchability logits z0 (P, m), z1 (P, n))."""
        d = x0.shape[-1]
        md0 = self.final_proj(x0) / d**0.25
        md1 = self.final_proj(x1) / d**0.25
        sim = torch.matmul(md0, md1.transpose(-1, -2))
        z0 = self.matchability(x0)[..., 0]
        z1 = self.matchability(x1)[..., 0]
        P, m, n = sim.shape
        cert = F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
        scores = sim.new_zeros((P, m + 1, n + 1))
        scores[:, :m, :n] = F.log_softmax(sim, dim=2) + F.log_softmax(sim, dim=1) + cert
        scores[:, :m, n] = F.logsigmoid(-z0)
        scores[:, m, :n] = F.logsigmoid(-z1)
        return scores, z0, z1


class LightGlueNet(nn.Module):
    def __init__(self, opts: LightGlueOptions = LightGlueOptions()):
        super().__init__()
        self.opts = opts
        self.input_proj = nn.Linear(opts.input_dim, opts.dim)
        self.posenc = FourierPosEnc(opts.dim // opts.num_heads)
        self.transformers = nn.ModuleList(
            TransformerLayer(opts.dim, opts.num_heads) for _ in range(opts.num_layers))
        self.log_assignment = nn.ModuleList(MatchAssignment(opts.dim) for _ in range(opts.num_layers))

    def forward(self, desc0, desc1, coords0, coords1, mask0=None, mask1=None):
        """desc (P, K, input_dim); coords (P, K, 2) normalized
        (``normalize_keypoints``); masks (P, K) bool or None. Returns
        (log-assignment (P, K0+1, K1+1), matchability logits z0, z1)."""
        with precise():
            cdtype = torch.bfloat16 if self.opts.mixed_precision else torch.float32
            x0 = self.input_proj(desc0.float()).to(cdtype)
            x1 = self.input_proj(desc1.float()).to(cdtype)
            enc0 = self.posenc(coords0)
            enc1 = self.posenc(coords1)
            for layer in self.transformers:
                x0, x1 = layer(x0, x1, enc0, enc1, mask0, mask1, cdtype)
            return self.log_assignment[-1](x0.float(), x1.float())


def normalize_keypoints(coords: torch.Tensor, image_size) -> torch.Tensor:
    """Official LightGlue normalization: shift by size/2, divide by
    max(size)/2; ``image_size`` is (w, h)."""
    size = torch.as_tensor(image_size, dtype=torch.float32, device=coords.device)
    return (coords - size / 2.0) / (torch.max(size) / 2.0)


class LightGlueMatcher:
    """match_batch(desc0, desc1, coords0, coords1, mask0, mask1, image_size)
    -> (match_idx i32 (P, K0), match_mask bool (P, K0), scores f32 (P, K0)),
    the precomputed-match inputs of two_view.run_two_view_batch.

    ``state_dict`` is an official-layout LightGlue state_dict (tensors or
    numpy arrays); without one the net keeps a random init drawn from seed
    0, for pipeline-shape runs."""

    def __init__(self, options: LightGlueOptions = LightGlueOptions(), state_dict=None,
                 example_dim: int | None = None):
        if example_dim is not None and state_dict is None:
            options = options._replace(input_dim=example_dim)
        self.options = options
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.net = LightGlueNet(options)
        if state_dict is not None:
            self.net.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        self.net.eval().requires_grad_(False)

    def _postprocess(self, z, mask0, mask1):
        """z (P, K0+1, K1+1) log-assignment -> mutual argmax above the
        match threshold."""
        zi = z[:, :-1, :-1]
        zi = torch.where(mask0[:, :, None] & mask1[:, None, :], zi, MASK_FILL)
        nn12 = torch.argmax(zi, dim=2)
        nn21 = torch.argmax(zi, dim=1)
        mutual = torch.arange(zi.shape[1], device=z.device) == torch.gather(nn21, 1, nn12)
        score = torch.exp(torch.amax(zi, dim=2))
        ok = mask0 & mutual & (score > self.options.match_threshold)
        return torch.where(ok, nn12, -1).to(torch.int32), ok, score.to(torch.float32)

    def log_assignment(self, desc0, desc1, coords0, coords1, mask0, mask1, image_size):
        """The net's log-assignment (P, K0+1, K1+1) for pixel coordinates."""
        self.net.to(desc0.device)
        with torch.no_grad():
            z, _z0, _z1 = self.net(desc0, desc1, normalize_keypoints(coords0, image_size),
                                   normalize_keypoints(coords1, image_size), mask0, mask1)
        return z

    def match_batch(self, desc0, desc1, coords0, coords1, mask0, mask1, image_size):
        """Batched over pairs: desc (P, K, D), coords (P, K, 2) pixels,
        masks (P, K) bool, image_size (w, h)."""
        z = self.log_assignment(desc0, desc1, coords0, coords1, mask0, mask1, image_size)
        return self._postprocess(z, mask0, mask1)

    def match(self, desc0, desc1, coords0, coords1, mask0, mask1, image_size):
        """One pair: desc (K, D), coords (K, 2), masks (K,) -> (K0,) each."""
        out = self.match_batch(desc0[None], desc1[None], coords0[None], coords1[None],
                               mask0[None], mask1[None], image_size)
        return tuple(a[0] for a in out)


def options_from_state_dict(sd, opts: LightGlueOptions = LightGlueOptions()) -> LightGlueOptions:
    """``opts`` with depth, widths and heads read off an official-layout
    state_dict's shapes."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("transformers."))
    dim, input_dim = (int(s) for s in sd["input_proj.weight"].shape)
    head_dim = 2 * int(sd["posenc.Wr.weight"].shape[0])  # Wr: 2 -> head_dim/2
    return opts._replace(num_layers=n_layers, dim=dim, input_dim=input_dim, num_heads=dim // head_dim)


def load_torch_weights(path: str, opts: LightGlueOptions = LightGlueOptions()):
    """Load an official LightGlue checkpoint (superpoint_lightglue.pth) ->
    (state_dict without the unused token_confidence heads, options
    inferred from its shapes)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if not k.startswith("token_confidence.")}
    return sd, options_from_state_dict(sd, opts)
