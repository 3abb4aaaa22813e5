"""Plain references of the two matchers the cells run.

- Mutual nearest neighbours with Lowe's ratio test (0.8 on L2 distances of
  unit descriptors, d^2 = 2 - 2 s): the similarity in float32, or, for the
  control, from descriptors rounded through float8 (the step below the
  configuration's bf16 products).
- LightGlue (Lindenberger et al., ICCV 2023) in the official checkpoint
  layout, loaded from the same file the program reads: input projection,
  learnable Fourier positional encoding with rotary q/k, 9 layers of a
  self block (fused Wqkv, out_proj, ffn on [x, message]) and a cross block
  (shared to_qk, to_v, to_out, ffn), then the last layer's
  sigmoid-log-double-softmax assignment with a dustbin and the mutual
  argmax above the match threshold. Attention is the textbook formula:
  float32 scores, masked keys at -1e9, softmax, product with v. The
  reference runs it all in float32 with TF32 off; the control rounds every
  transformer linear's input and weight, and attention's q, k and v,
  through float8 with a bf16 residual stream, the step below the
  configuration's bf16 transformer.

Both return (match_idx (P, K1) into the second image or -1, match_mask,
score) and the scores the judge reads: the similarity (P, K1, K2) or the
log-assignment (P, K1, K2) without the dustbin.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.numerics import fp8, precision

NEG = -1e9
LN_EPS = 1e-6
SCORE_BYTES = 1 << 30  # float32 attention scores held at once


# ---------------------------------------------------------------- mutual NN
def mutual_nn(desc1, desc2, mask1, mask2, ratio: float = 0.8, low: bool = False):
    if low:
        desc1, desc2 = fp8(desc1), fp8(desc2)
    with precision(False):
        sim = torch.matmul(desc1.float(), desc2.float().transpose(-1, -2))
    sim = torch.where(mask1[..., :, None] & mask2[..., None, :], sim, torch.full((), NEG, device=sim.device))
    nn12 = torch.argmax(sim, dim=-1)
    best = torch.amax(sim, dim=-1)
    second = torch.amax(sim.scatter(-1, nn12[..., None], NEG), dim=-1)
    nn21 = torch.argmax(sim, dim=-2)
    mutual = torch.gather(nn21, -1, nn12) == torch.arange(sim.shape[-2], device=sim.device)
    d2_best = torch.clamp(2.0 - 2.0 * best, min=0.0)
    d2_second = torch.clamp(2.0 - 2.0 * second, min=1e-12)
    ok = mask1 & mutual & (best > -1e8) & (d2_best < ratio**2 * d2_second)
    return torch.where(ok, nn12, -1).to(torch.int32), ok, best, sim


# ---------------------------------------------------------------- LightGlue
def load_lightglue(path: str, device) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items() if not k.startswith("token_confidence.")}


def _rotate_half(x):
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


class _Net:
    """The LightGlue forward over a state_dict; ``low`` is the control."""

    def __init__(self, sd: dict, heads: int, low: bool):
        self.sd, self.heads, self.low = sd, heads, low
        self.dtype = torch.bfloat16 if low else torch.float32

    def linear(self, x, key):
        w, b = self.sd[f"{key}.weight"], self.sd.get(f"{key}.bias")
        if self.low:
            x, w = fp8(x.to(self.dtype)), fp8(w.to(self.dtype))
            b = None if b is None else b.to(self.dtype)
            return F.linear(x.float(), w.float(), None if b is None else b.float()).to(self.dtype)
        return F.linear(x, w, b)

    def ffn(self, x, key):
        h = self.linear(x, f"{key}.0").float()
        h = F.layer_norm(h, h.shape[-1:], self.sd[f"{key}.1.weight"], self.sd[f"{key}.1.bias"], eps=LN_EPS)
        return self.linear(F.gelu(h), f"{key}.3")

    def qkv(self, x):
        return (fp8(x) if self.low else x).float()

    def attend(self, q, k, v, mask):
        """q (P, Kq, h, dh), k/v (P, Kk, h, dh), mask (P, Kk) -> (P, Kq, h*dh)."""
        P, Kq, h, dh = q.shape
        q, k, v = (self.qkv(t).transpose(1, 2) for t in (q, k, v))
        step = max(1, SCORE_BYTES // (4 * h * Kq * k.shape[2]))
        out = []
        for s in range(0, P, step):
            sc = torch.matmul(q[s:s + step], k[s:s + step].transpose(-1, -2)) / math.sqrt(dh)
            sc = torch.where(mask[s:s + step, None, None, :], sc, NEG)
            out.append(torch.matmul(torch.softmax(sc, dim=-1), v[s:s + step]))
        return torch.cat(out).transpose(1, 2).reshape(P, Kq, h * dh).to(self.dtype)

    def self_block(self, x, cos, sin, mask, key):
        P, K, d = x.shape
        h = self.heads
        qkv = self.linear(x, f"{key}.Wqkv").reshape(P, K, h, d // h, 3)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
        cos, sin = cos[:, :, None, :].to(self.dtype), sin[:, :, None, :].to(self.dtype)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        msg = self.linear(self.attend(q, k, v, mask), f"{key}.out_proj")
        return x + self.ffn(torch.cat([x, msg.to(x.dtype)], dim=-1), f"{key}.ffn")

    def cross_block(self, x0, x1, m0, m1, key):
        P, K0, d = x0.shape
        h = self.heads
        split = lambda t: t.reshape(P, t.shape[1], h, d // h)  # noqa: E731
        qk0, qk1 = split(self.linear(x0, f"{key}.to_qk")), split(self.linear(x1, f"{key}.to_qk"))
        v0, v1 = split(self.linear(x0, f"{key}.to_v")), split(self.linear(x1, f"{key}.to_v"))
        c0 = self.linear(self.attend(qk0, qk1, v1, m1), f"{key}.to_out")
        c1 = self.linear(self.attend(qk1, qk0, v0, m0), f"{key}.to_out")
        x0 = x0 + self.ffn(torch.cat([x0, c0.to(x0.dtype)], dim=-1), f"{key}.ffn")
        x1 = x1 + self.ffn(torch.cat([x1, c1.to(x1.dtype)], dim=-1), f"{key}.ffn")
        return x0, x1

    def forward(self, d0, d1, c0, c1, m0, m1):
        sd = self.sd
        x0 = F.linear(d0.float(), sd["input_proj.weight"], sd["input_proj.bias"]).to(self.dtype)
        x1 = F.linear(d1.float(), sd["input_proj.weight"], sd["input_proj.bias"]).to(self.dtype)
        enc = []
        for c in (c0, c1):
            proj = F.linear(c.float(), sd["posenc.Wr.weight"])
            enc.append((torch.cos(proj).repeat_interleave(2, dim=-1), torch.sin(proj).repeat_interleave(2, dim=-1)))
        n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("transformers."))
        for i in range(n_layers):
            key = f"transformers.{i}"
            x0 = self.self_block(x0, *enc[0], m0, f"{key}.self_attn")
            x1 = self.self_block(x1, *enc[1], m1, f"{key}.self_attn")
            x0, x1 = self.cross_block(x0, x1, m0, m1, f"{key}.cross_attn")
        la = f"log_assignment.{n_layers - 1}"
        x0, x1 = x0.float(), x1.float()
        d = x0.shape[-1]
        md0 = F.linear(x0, sd[f"{la}.final_proj.weight"], sd[f"{la}.final_proj.bias"]) / d**0.25
        md1 = F.linear(x1, sd[f"{la}.final_proj.weight"], sd[f"{la}.final_proj.bias"]) / d**0.25
        sim = torch.matmul(md0, md1.transpose(-1, -2))
        z0 = F.linear(x0, sd[f"{la}.matchability.weight"], sd[f"{la}.matchability.bias"])[..., 0]
        z1 = F.linear(x1, sd[f"{la}.matchability.weight"], sd[f"{la}.matchability.bias"])[..., 0]
        cert = F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
        return F.log_softmax(sim, dim=2) + F.log_softmax(sim, dim=1) + cert


def lightglue(sd: dict, desc0, desc1, kp0, kp1, mask0, mask1, image_wh, heads: int, threshold: float,
              low: bool = False, pair_block: int = 32):
    """Pixel keypoints (P, K, 2), normalized as the official LightGlue by
    the image size (w, h); pairs run in blocks of ``pair_block``."""
    size = torch.tensor(image_wh, dtype=torch.float32, device=kp0.device)
    norm = lambda k: (k - size / 2.0) / (torch.max(size) / 2.0)  # noqa: E731
    net = _Net(sd, heads, low)
    outs = []
    with torch.no_grad(), precision(False):
        for s in range(0, desc0.shape[0], pair_block):
            b = slice(s, s + pair_block)
            outs.append(net.forward(desc0[b], desc1[b], norm(kp0[b]), norm(kp1[b]), mask0[b], mask1[b]))
    z = torch.cat(outs)
    z = torch.where(mask0[:, :, None] & mask1[:, None, :], z, NEG)
    nn12 = torch.argmax(z, dim=2)
    nn21 = torch.argmax(z, dim=1)
    mutual = torch.arange(z.shape[1], device=z.device) == torch.gather(nn21, 1, nn12)
    score = torch.exp(torch.amax(z, dim=2))
    ok = mask0 & mutual & (score > threshold)
    return torch.where(ok, nn12, -1).to(torch.int32), ok, score, z
