"""State carried between the reference's pytrees and the port's tensors.

The reference's pytrees (``SE3``, ``Cal3Bundler``, ``SfmData``, two-view
result dicts) reach the port as host numpy: objects or mappings whose
fields are numpy arrays (``jax.tree.map(np.asarray, x)`` gives one). These
helpers build the port's dataclasses from them and turn port dataclasses
back into dicts of numpy arrays. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler


def _field(src: Any, name: str):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def tensor(x, device=None, dtype=None) -> torch.Tensor:
    """numpy (or array-like) -> tensor (a copy); float64 becomes float32,
    integer index arrays int64."""
    a = np.asarray(x)
    if dtype is None:
        if a.dtype == np.float64:
            dtype = torch.float32
        elif np.issubdtype(a.dtype, np.integer):
            dtype = torch.int64
    return torch.tensor(a, dtype=dtype, device=device)


def se3(src, device=None) -> SE3:
    return SE3(R=tensor(_field(src, "R"), device, torch.float32),
               t=tensor(_field(src, "t"), device, torch.float32))


def cal3_bundler(src, device=None) -> Cal3Bundler:
    return Cal3Bundler(*(tensor(_field(src, k), device, torch.float32) for k in ("f", "k1", "k2", "u0", "v0")))


def sfm_data(src, device=None) -> SfmData:
    return SfmData(
        poses=se3(_field(src, "poses"), device),
        cal=cal3_bundler(_field(src, "cal"), device),
        pose_mask=tensor(_field(src, "pose_mask"), device, torch.bool),
        points=tensor(_field(src, "points"), device, torch.float32),
        track_mask=tensor(_field(src, "track_mask"), device, torch.bool),
        meas_cam=tensor(_field(src, "meas_cam"), device, torch.int64),
        meas_track=tensor(_field(src, "meas_track"), device, torch.int64),
        meas_uv=tensor(_field(src, "meas_uv"), device, torch.float32),
        meas_mask=tensor(_field(src, "meas_mask"), device, torch.bool),
    )


def two_view_result(src, device=None) -> dict:
    """A two-view result (dict or object with the TwoViewResult fields)
    -> dict of tensors."""
    names = ("i2Ri1", "i2Ui1", "corr_i1", "corr_i2", "corr_mask", "num_matches",
             "num_inliers", "inlier_ratio", "valid")
    return {k: tensor(_field(src, k), device) for k in names}


def to_numpy(obj):
    """Port dataclass (recursively) or tensor -> dict of numpy / array."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if isinstance(getattr(obj, f.name), torch.Tensor) or dataclasses.is_dataclass(getattr(obj, f.name))}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    return obj


def lightglue_state_dict(params) -> dict:
    """Flax params of the reference's ``LightGlueNet`` (numpy leaves; the
    layers scan-stacked on a leading axis; Dense kernels (in, out)) -> the
    port's official-layout state_dict of float32 tensors.

    The reference keeps only the last ``log_assignment`` head, the one the
    forward uses; every layer's head gets it so that the dict loads with
    ``load_state_dict``."""
    sd = {}

    def dense(key, p):
        sd[f"{key}.weight"] = tensor(np.asarray(p["kernel"]).T, dtype=torch.float32)
        if "bias" in p:
            sd[f"{key}.bias"] = tensor(p["bias"], dtype=torch.float32)

    def norm(key, p):
        sd[f"{key}.weight"] = tensor(p["scale"], dtype=torch.float32)
        sd[f"{key}.bias"] = tensor(p["bias"], dtype=torch.float32)

    def ffn(key, p, i):
        dense(f"{key}.0", {k: np.asarray(v)[i] for k, v in p["ffn0"].items()})
        norm(f"{key}.1", {k: np.asarray(v)[i] for k, v in p["ffn1"].items()})
        dense(f"{key}.3", {k: np.asarray(v)[i] for k, v in p["ffn3"].items()})

    dense("input_proj", params["input_proj"])
    dense("posenc.Wr", params["posenc"]["Wr"])
    layers = params["layers"]
    num_layers = np.asarray(layers["self"]["Wqkv"]["kernel"]).shape[0]
    for i in range(num_layers):
        for block, names in (("self", ("Wqkv", "out_proj")), ("cross", ("to_qk", "to_v", "to_out"))):
            key = f"transformers.{i}.{block}_attn"
            for name in names:
                dense(f"{key}.{name}", {k: np.asarray(v)[i] for k, v in layers[block][name].items()})
            ffn(f"{key}.ffn", layers[block]["ffn"], i)
        for name in ("final_proj", "matchability"):
            dense(f"log_assignment.{i}.{name}", params["assign"][name])
    return sd
