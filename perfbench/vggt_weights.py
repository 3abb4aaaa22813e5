"""A seeded VGGT checkpoint in the public layout (facebook/VGGT-1B's
``model.state_dict()`` keys: ``aggregator.*``, ``camera_head.*``,
``depth_head.*``, ``point_head.*``, ``track_head.*``), for the feed-forward
pipeline.

The keys and shapes are the plain reference's (perfbench/reference/vggt.py)
at the configuration's sizes. Values are drawn on the given device from a
generator seeded with the run's seed, at the port's init scales: weights,
tokens and embeddings N(0, 0.02^2), biases 0, norm scales 1, LayerScales
``layer_scale``, the empty pose token 0, the virtual tracks N(0, 1). The
depth head's confidence channel gets the bias ``conf_bias``, so that every
patch of frame 0 is confident and a pass always tracks ``max_queries``
points."""

from __future__ import annotations

import os

import torch

from perfbench.reference import vggt as reference

CONF_BIAS_KEY = "depth_head.scratch.output_conv2.2.bias"


def draw(model: dict, seed: int, device) -> dict:
    """The state_dict (CPU tensors) for the configuration's ``model``."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in reference.VGGT(reference.dims_from(model)).state_dict().items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sd = {}
    for key, shape in shapes.items():
        parts = key.split(".")
        leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
        if leaf.endswith("bias") or leaf == "empty_pose_tokens":
            v = torch.zeros(shape, device=device)
        elif leaf == "gamma":
            v = torch.full(shape, float(model["layer_scale"]), device=device)
        elif leaf == "weight" and "norm" in parent:
            v = torch.ones(shape, device=device)
        elif leaf == "virual_tracks":
            v = torch.randn(shape, generator=gen, device=device)
        else:
            v = torch.randn(shape, generator=gen, device=device) * float(model["init_std"])
        sd[key] = v.cpu()
    sd[CONF_BIAS_KEY][-1] = float(model["conf_bias"])
    return sd


def write(model: dict, seed: int, path: str, device) -> str:
    """Draw the checkpoint and save it at ``path``; returns the path."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(draw(model, seed, device), path)
    return path
