"""Seeded checkpoints in the public layouts: SuperPoint (MagicLeap's
superpoint_v1.pth keys) and LightGlue (the official
superpoint_lightglue.pth keys), drawn on the device from the run's seed
with one ``torch.Generator`` in one uniform and one normal call, and
written to files that the program loads through its configuration's
``weights_path`` and the reference loads on its own.

Random weights match nothing, so both are built as fixtures that act
their part (the construction of the port's chip_smoke fixtures):
SuperPoint carries every feature with its negative through zero-bias
convolutions, so its descriptors are random projections of a
neighbourhood's structure; LightGlue draws every linear as PyTorch's
default init does (uniform within 1/sqrt(fan_in)) and posenc.Wr from
N(0, 1), except an input projection of sqrt(200) I, a last assignment
head of final_proj = I and matchability bias +8, and LayerNorms at 1, 0.
Shapes and work are the published ones.
"""

from __future__ import annotations

import math
import os

import torch

SUPERPOINT_FILE = "superpoint_v1.pth"
LIGHTGLUE_FILE = "superpoint_lightglue.pth"


class _Draws:
    """Slices of one uniform and one normal draw, handed out in order."""

    def __init__(self, gen, device, n_uniform: int, n_normal: int):
        self.u = torch.rand(n_uniform, generator=gen, device=device) if n_uniform else None
        self.n = torch.randn(n_normal, generator=gen, device=device) if n_normal else None
        self.iu = self.iN = 0

    def uniform(self, shape, bound):
        k = math.prod(shape)
        out = (self.u[self.iu:self.iu + k].reshape(shape) * 2 - 1) * bound
        self.iu += k
        return out

    def normal(self, shape):
        k = math.prod(shape)
        out = self.n[self.iN:self.iN + k].reshape(shape)
        self.iN += k
        return out

    def check_used(self) -> None:
        for draw, used in ((self.u, self.iu), (self.n, self.iN)):
            if (0 if draw is None else draw.numel()) != used:
                raise RuntimeError("seeded weights: the draws do not match the checkpoint's sizes")


def _superpoint(draws: _Draws) -> dict:
    def signed(w):
        return torch.cat([torch.cat([w, -w], dim=1), torch.cat([-w, w], dim=1)])

    def conv(n_in, n_out, k=3):
        return signed(draws.normal((n_out, n_in, k, k)) / math.sqrt(n_in * k * k))

    f1 = draws.normal((32, 1, 3, 3))
    f1 = (f1 - f1.mean(dim=(1, 2, 3), keepdim=True)) / 3.0
    w = {"conv1a": torch.cat([f1, -f1]), "conv1b": conv(32, 32), "conv2a": conv(32, 32), "conv2b": conv(32, 32),
         "conv3a": conv(32, 64), "conv3b": conv(64, 64), "conv4a": conv(64, 64), "conv4b": conv(64, 64),
         "convDa": conv(64, 128)}
    w["convDb"] = signed(draws.normal((256, 128, 1, 1)) / math.sqrt(128))[:256]
    w["convPa"] = conv(64, 128)
    score = draws.normal((65, 128, 1, 1)) * (8.0 / math.sqrt(128))
    score[64] = 0.0
    w["convPb"] = signed(score)[:65]
    sd = {}
    for name, value in w.items():
        sd[f"{name}.weight"] = value
        sd[f"{name}.bias"] = torch.zeros(value.shape[0], device=value.device)
    return sd


# normal draws of _superpoint: f1, conv1b-conv2b, conv3a, conv3b-conv4b, convDa, convDb, convPa, the scores
SUPERPOINT_NORMALS = (32 * 9 + 3 * 32 * 32 * 9 + 64 * 32 * 9 + 3 * 64 * 64 * 9 + 128 * 64 * 9 + 256 * 128
                      + 128 * 64 * 9 + 65 * 128)


def _lightglue(draws: _Draws, dim: int, layers: int, heads: int, input_dim: int) -> dict:
    dev = draws.n.device
    sd = {}

    def linear(key, fan_in, fan_out):
        b = 1.0 / math.sqrt(fan_in)
        sd[f"{key}.weight"] = draws.uniform((fan_out, fan_in), b)
        sd[f"{key}.bias"] = draws.uniform((fan_out,), b)

    def ffn(key):
        linear(f"{key}.0", 2 * dim, 2 * dim)
        sd[f"{key}.1.weight"] = torch.ones(2 * dim, device=dev)
        sd[f"{key}.1.bias"] = torch.zeros(2 * dim, device=dev)
        linear(f"{key}.3", 2 * dim, dim)

    sd["input_proj.weight"] = math.sqrt(200.0) * torch.eye(dim, input_dim, device=dev)
    sd["input_proj.bias"] = torch.zeros(dim, device=dev)
    sd["posenc.Wr.weight"] = draws.normal((dim // heads // 2, 2))
    for i in range(layers):
        sa, ca = f"transformers.{i}.self_attn", f"transformers.{i}.cross_attn"
        linear(f"{sa}.Wqkv", dim, 3 * dim)
        linear(f"{sa}.out_proj", dim, dim)
        ffn(f"{sa}.ffn")
        for name in ("to_qk", "to_v", "to_out"):
            linear(f"{ca}.{name}", dim, dim)
        ffn(f"{ca}.ffn")
        la = f"log_assignment.{i}"
        if i < layers - 1:
            linear(f"{la}.matchability", dim, 1)
            linear(f"{la}.final_proj", dim, dim)
        else:
            sd[f"{la}.matchability.weight"] = torch.zeros((1, dim), device=dev)
            sd[f"{la}.matchability.bias"] = torch.full((1,), 8.0, device=dev)
            sd[f"{la}.final_proj.weight"] = torch.eye(dim, device=dev)
            sd[f"{la}.final_proj.bias"] = torch.zeros(dim, device=dev)
    return sd


def _lightglue_uniforms(dim: int, layers: int) -> int:
    lin = lambda i, o: i * o + o  # noqa: E731
    ffn = lin(2 * dim, 2 * dim) + lin(2 * dim, dim)
    per = lin(dim, 3 * dim) + lin(dim, dim) + ffn + 3 * lin(dim, dim) + ffn
    return layers * per + (layers - 1) * (lin(dim, 1) + lin(dim, dim))


def write(config: dict, seed: int, dirpath: str, device) -> dict:
    """Write the configuration's seeded checkpoints under ``dirpath``.
    Returns {config section: path} for the sections that take weights."""
    os.makedirs(dirpath, exist_ok=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    paths = {}
    model = config["model"]
    for section, kind in config["weights"].items():
        if kind == "superpoint":
            draws = _Draws(gen, device, 0, SUPERPOINT_NORMALS)
            sd = _superpoint(draws)
            path = os.path.join(dirpath, SUPERPOINT_FILE)
        elif kind == "lightglue":
            dim, layers, heads = model["lightglue_dim"], model["lightglue_layers"], model["lightglue_heads"]
            draws = _Draws(gen, device, _lightglue_uniforms(dim, layers), dim // heads)
            sd = _lightglue(draws, dim, layers, heads, model["descriptor_dim"])
            path = os.path.join(dirpath, LIGHTGLUE_FILE)
        else:
            raise ValueError(f"no seeded checkpoint for {kind!r}")
        draws.check_used()
        torch.save({k: v.float().cpu().contiguous() for k, v in sd.items()}, path)
        paths[section] = path
    return paths
