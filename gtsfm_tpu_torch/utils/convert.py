"""State carried between the reference's pytrees and the port's tensors.

The reference's pytrees (``SE3``, the four calibration models,
``SfmData``, two-view result dicts) reach the port as host numpy: objects or mappings whose
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
from gtsfm_tpu_torch.geometry import CALIBRATION_TYPES, SE3, Cal3Bundler, Cal3DS2, Cal3Fisheye, Cal3_S2
from gtsfm_tpu_torch.splat.gs_data import GSData


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


def _cal(cls, src, device):
    return cls(**{f.name: tensor(_field(src, f.name), device, torch.float32) for f in dataclasses.fields(cls)})


def cal3_bundler(src, device=None) -> Cal3Bundler:
    return _cal(Cal3Bundler, src, device)


def cal3_s2(src, device=None) -> Cal3_S2:
    return _cal(Cal3_S2, src, device)


def cal3ds2(src, device=None) -> Cal3DS2:
    return _cal(Cal3DS2, src, device)


def cal3_fisheye(src, device=None) -> Cal3Fisheye:
    return _cal(Cal3Fisheye, src, device)


_CAL_BY_NAME = {cls.__name__: cls for cls in CALIBRATION_TYPES}


def calibration(src, device=None):
    """A reference calibration of any of the four models -> the port's
    model of the same name. ``src`` is the reference object (numpy leaves)
    or a mapping of its fields; a mapping names its model by its fields
    (Cal3DS2 has p1, p2; Cal3Fisheye k3, k4; Cal3Bundler f)."""
    cls = _CAL_BY_NAME.get(type(src).__name__)
    if cls is None:
        if not isinstance(src, dict):
            raise TypeError(f"not a calibration model: {type(src).__name__}")
        keys = set(src)
        cls = next((c for c in CALIBRATION_TYPES if {f.name for f in dataclasses.fields(c)} == keys), None)
        if cls is None:
            raise TypeError(f"no calibration model has the fields {sorted(keys)}")
    return _cal(cls, src, device)


def sfm_data(src, device=None) -> SfmData:
    return SfmData(
        poses=se3(_field(src, "poses"), device),
        cal=calibration(_field(src, "cal"), device),
        pose_mask=tensor(_field(src, "pose_mask"), device, torch.bool),
        points=tensor(_field(src, "points"), device, torch.float32),
        track_mask=tensor(_field(src, "track_mask"), device, torch.bool),
        meas_cam=tensor(_field(src, "meas_cam"), device, torch.int64),
        meas_track=tensor(_field(src, "meas_track"), device, torch.int64),
        meas_uv=tensor(_field(src, "meas_uv"), device, torch.float32),
        meas_mask=tensor(_field(src, "meas_mask"), device, torch.bool),
    )


def gs_data(src, device=None) -> GSData:
    """A reference ``GSData`` (numpy leaves) -> the port's; ``alive`` keeps
    its dtype (bool, or float 0/1)."""
    floats = {k: tensor(_field(src, k), device, torch.float32)
              for k in ("means", "log_scales", "quats", "opacity_logit", "colors")}
    return GSData(alive=tensor(_field(src, "alive"), device), **floats)


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


# ---- the deep front end's nets: the reference's flax params (numpy leaves)
# -> the port's state_dicts. Flax convs are (kh, kw, I, O), torch's (O, I,
# kh, kw); flax Dense kernels are (in, out), torch Linear weights (out, in).


def _f32(a) -> torch.Tensor:
    return tensor(np.asarray(a), dtype=torch.float32)


def _put_conv(sd: dict, key: str, p) -> None:
    sd[f"{key}.weight"] = _f32(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{key}.bias"] = _f32(p["bias"])


def superpoint_state_dict(params) -> dict:
    """``SuperPointNet``'s params -> the MagicLeap-layout state_dict."""
    from gtsfm_tpu_torch.frontend.detectors.superpoint import LAYERS

    sd = {}
    for name in LAYERS:
        _put_conv(sd, name, params[name])
    return sd


def netvlad_state_dict(params) -> dict:
    """``NetVLADNet``'s params -> the port's ``NetVLADNet`` state_dict."""
    sd = {}
    for name in ("conv1", "conv2", "conv3", "conv4"):
        _put_conv(sd, name, params[name])
    sd["centers"] = _f32(params["centers"])
    for name in ("assign", "proj"):
        sd[f"{name}.weight"] = _f32(np.asarray(params[name]["kernel"]).T)
        sd[f"{name}.bias"] = _f32(params[name]["bias"])
    return sd


def hloc_netvlad_state_dict(params) -> dict:
    """``NetVLADVGG16``'s params -> hloc's checkpoint layout."""
    from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import VGG16_CONV_IDS

    sd = {}
    for i in VGG16_CONV_IDS:
        _put_conv(sd, f"backbone.{i}", params[f"conv{i}"])
    sd["netvlad.score_proj.weight"] = _f32(np.asarray(params["score_proj"]["kernel"]).T[:, :, None])
    sd["netvlad.centers"] = _f32(params["centers"])
    sd["whiten.weight"] = _f32(np.asarray(params["whiten"]["kernel"]).T)
    sd["whiten.bias"] = _f32(params["whiten"]["bias"])
    return sd


def megaloc_state_dict(params) -> dict:
    """MegaLoc's param tree (``init_params`` / ``load_torch_weights``) ->
    the megaloc.torch layout."""
    sd = {}
    bb, pre = params["backbone"], "backbone.model."

    def linear(key, kernel, bias):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _f32(np.asarray(kernel).T), _f32(bias)

    def norm(key, p):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _f32(p["scale"]), _f32(p["bias"])

    sd[pre + "cls_token"] = _f32(bb["cls_token"])
    sd[pre + "pos_embed"] = _f32(bb["pos_embed"])
    sd[pre + "patch_embed.proj.weight"] = _f32(np.asarray(bb["patch_kernel"]).transpose(3, 2, 0, 1))
    sd[pre + "patch_embed.proj.bias"] = _f32(bb["patch_bias"])
    for i, blk in enumerate(bb["blocks"]):
        b = f"{pre}blocks.{i}."
        norm(b + "norm1", blk["norm1"])
        linear(b + "attn.qkv", blk["attn"]["qkv_kernel"], blk["attn"]["qkv_bias"])
        linear(b + "attn.proj", blk["attn"]["proj_kernel"], blk["attn"]["proj_bias"])
        sd[b + "ls1.gamma"] = _f32(blk["ls1"])
        norm(b + "norm2", blk["norm2"])
        linear(b + "mlp.fc1", blk["mlp"]["fc1_kernel"], blk["mlp"]["fc1_bias"])
        linear(b + "mlp.fc2", blk["mlp"]["fc2_kernel"], blk["mlp"]["fc2_bias"])
        sd[b + "ls2.gamma"] = _f32(blk["ls2"])
    norm(pre + "norm", bb["norm"])
    agg, salad = "aggregator.agg.", params["salad"]
    linear(agg + "token_features.0", salad["token"]["fc1_kernel"], salad["token"]["fc1_bias"])
    linear(agg + "token_features.2", salad["token"]["fc2_kernel"], salad["token"]["fc2_bias"])
    for name, key in (("cluster", "cluster_features"), ("score", "score")):
        for src, dst in (("fc1", "0"), ("fc2", "3")):
            linear(f"{agg}{key}.{dst}", salad[name][f"{src}_kernel"], salad[name][f"{src}_bias"])
            sd[f"{agg}{key}.{dst}.weight"] = sd[f"{agg}{key}.{dst}.weight"][:, :, None, None]
    sd[agg + "dust_bin"] = _f32(salad["dust_bin"])
    linear("aggregator.linear", params["linear"]["kernel"], params["linear"]["bias"])
    return sd


def d2net_state_dict(params) -> dict:
    """``D2NetTrunk``'s params -> the d2net checkpoint layout."""
    from gtsfm_tpu_torch.frontend.detectors.d2net import CONV_IDS

    sd = {}
    for i in CONV_IDS:
        _put_conv(sd, f"dense_feature_extraction.model.{i}", params[f"conv{i}"])
    return sd


def disk_state_dict(params) -> dict:
    """DISK's param tree (``init_params`` / ``load_torch_weights``) -> the
    DISK U-Net layout."""
    sd = {}
    for k, blk in enumerate(params["down"]):
        if k == 0:
            _put_conv(sd, "unet.path_down.0.1.0", blk)
        else:
            sd[f"unet.path_down.{k}.1.1.weight"] = _f32(blk["slope"])
            _put_conv(sd, f"unet.path_down.{k}.1.2", blk)
    for j, blk in enumerate(params["up"]):
        sd[f"unet.path_up.{j}.conv.1.weight"] = _f32(blk["slope"])
        _put_conv(sd, f"unet.path_up.{j}.conv.2", blk)
    return sd


# ---- the feed-forward models: the reference's param trees -> the port's
# state_dicts. Flax Dense kernels and the reference's "kernel" matrices are
# (in, out), torch's (out, in); its conv kernels (kh, kw, I, O).


def feedforward_state_dict(params) -> dict:
    """The compact ``FeedforwardNet``'s Flax params (with or without the
    FastVGGT global blocks) -> the port's ``FeedforwardNet`` state_dict."""
    sd = {}

    def dense(key, p):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _f32(np.asarray(p["kernel"]).T), _f32(p["bias"])

    def norm(key, p):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _f32(p["scale"]), _f32(p["bias"])

    _put_conv(sd, "patch_embed", params["patch_embed"])
    for name in ("pos_embed", "camera_token", "frame_embed"):
        sd[name] = _f32(params[name])
    depth = len([k for k in params if k.startswith("frame_") and k[6:].isdigit()])
    for i in range(depth):
        for src, dst in ((f"frame_{i}", f"frame_blocks.{i}"), (f"global_{i}", f"global_blocks.{i}")):
            p = params[src]
            fast = "q" in p["attn"]
            norms = ("norm1", "norm_context", "norm2") if fast else ("norm1", "norm2")
            for j, n in enumerate(norms):
                norm(f"{dst}.{n}", p[f"LayerNorm_{j}"])
            for name in (("q", "kv", "proj") if fast else ("qkv", "proj")):
                dense(f"{dst}.attn.{name}", p["attn"][name])
            dense(f"{dst}.mlp.fc1", p["Dense_0"])
            dense(f"{dst}.mlp.fc2", p["Dense_1"])
    for name in ("pose_head", "depth_head", "conf_head", "track_head"):
        dense(name, params[name])
    return sd


def _vggt_block(sd: dict, key: str, p) -> None:
    for n in ("norm1", "norm2"):
        sd[f"{key}.{n}.weight"], sd[f"{key}.{n}.bias"] = _f32(p[n]["scale"]), _f32(p[n]["bias"])
    a = p["attn"]
    for n in ("qkv", "proj"):
        sd[f"{key}.attn.{n}.weight"] = _f32(np.asarray(a[f"{n}_kernel"]).T)
        sd[f"{key}.attn.{n}.bias"] = _f32(a[f"{n}_bias"])
    for n in ("q_norm", "k_norm"):
        if n in a:
            sd[f"{key}.attn.{n}.weight"], sd[f"{key}.attn.{n}.bias"] = _f32(a[n]["scale"]), _f32(a[n]["bias"])
    for n in ("fc1", "fc2"):
        sd[f"{key}.mlp.{n}.weight"] = _f32(np.asarray(p["mlp"][f"{n}_kernel"]).T)
        sd[f"{key}.mlp.{n}.bias"] = _f32(p["mlp"][f"{n}_bias"])
    for n in ("ls1", "ls2"):
        sd[f"{key}.{n}.gamma"] = _f32(np.broadcast_to(np.asarray(p.get(n, 1.0), np.float32), p["norm1"]["bias"].shape))


def _dpt_state_dict(sd: dict, head: str, p) -> None:
    """A reference DPT param dict -> ``head.*`` (refinenet4 without its
    unused first residual unit, the public layout; ``lax.conv_transpose``
    takes the kernel unflipped, so the torch weight is the flipped (I, O)
    kernel)."""
    sd[f"{head}.norm.weight"], sd[f"{head}.norm.bias"] = _f32(p["norm"]["scale"]), _f32(p["norm"]["bias"])
    for i, c in enumerate(p["projects"]):
        _put_conv(sd, f"{head}.projects.{i}", c)
    for i in (0, 1):
        k = np.asarray(p["resize"][i]["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        sd[f"{head}.resize_layers.{i}.weight"] = _f32(np.ascontiguousarray(k))
        sd[f"{head}.resize_layers.{i}.bias"] = _f32(p["resize"][i]["bias"])
    _put_conv(sd, f"{head}.resize_layers.3", p["resize"][3])
    sc = p["scratch"]
    for i in range(1, 5):
        sd[f"{head}.scratch.layer{i}_rn.weight"] = _f32(np.asarray(sc[f"layer{i}_rn"]["kernel"]).transpose(3, 2, 0, 1))
        r = sc[f"refinenet{i}"]
        for unit in (("resConfUnit2",) if i == 4 else ("resConfUnit1", "resConfUnit2")):
            for c in ("conv1", "conv2"):
                _put_conv(sd, f"{head}.scratch.refinenet{i}.{unit}.{c}", r[unit][c])
        _put_conv(sd, f"{head}.scratch.refinenet{i}.out_conv", r["out_conv"])
    _put_conv(sd, f"{head}.scratch.output_conv1", p["output_conv1"])
    if "output_conv2_0" in p:
        _put_conv(sd, f"{head}.scratch.output_conv2.0", p["output_conv2_0"])
        _put_conv(sd, f"{head}.scratch.output_conv2.2", p["output_conv2_2"])


def vggt_state_dict(params) -> dict:
    """The reference VGGT's param tree (``init_params`` or its converter's,
    with ``track_head``, ``point_head`` and AnySplat's ``gaussian_head``
    when present) -> the public ``model.state_dict()`` layout the port's
    ``VGGTNet`` loads (``gaussian_head.*`` in the depth head's layout)."""
    sd = {}
    agg, pe = params["aggregator"], params["aggregator"]["patch_embed"]
    pre = "aggregator.patch_embed."
    sd[pre + "patch_embed.proj.weight"] = _f32(np.asarray(pe["patch_kernel"]).transpose(3, 2, 0, 1))
    sd[pre + "patch_embed.proj.bias"] = _f32(pe["patch_bias"])
    for n in ("cls_token", "register_tokens", "pos_embed"):
        sd[pre + n] = _f32(pe[n])
    for i, blk in enumerate(pe["blocks"]):
        _vggt_block(sd, f"{pre}blocks.{i}", blk)
    sd[pre + "norm.weight"], sd[pre + "norm.bias"] = _f32(pe["norm"]["scale"]), _f32(pe["norm"]["bias"])
    sd["aggregator.camera_token"] = _f32(np.asarray(agg["camera_token"])[None])
    sd["aggregator.register_token"] = _f32(np.asarray(agg["register_token"])[None])
    for kind in ("frame_blocks", "global_blocks"):
        for i, blk in enumerate(agg[kind]):
            _vggt_block(sd, f"aggregator.{kind}.{i}", blk)
    ch = params["camera_head"]
    for n in ("token_norm", "trunk_norm"):
        sd[f"camera_head.{n}.weight"], sd[f"camera_head.{n}.bias"] = _f32(ch[n]["scale"]), _f32(ch[n]["bias"])
    for i, blk in enumerate(ch["trunk"]):
        _vggt_block(sd, f"camera_head.trunk.{i}", blk)
    sd["camera_head.empty_pose_tokens"] = _f32(np.asarray(ch["empty_pose_tokens"]).reshape(1, 1, -1))
    for src, dst in (("embed_pose", "embed_pose"), ("mod", "poseLN_modulation.1")):
        sd[f"camera_head.{dst}.weight"] = _f32(np.asarray(ch[f"{src}_kernel"]).T)
        sd[f"camera_head.{dst}.bias"] = _f32(ch[f"{src}_bias"])
    for n in ("fc1", "fc2"):
        sd[f"camera_head.pose_branch.{n}.weight"] = _f32(np.asarray(ch["pose_branch"][f"{n}_kernel"]).T)
        sd[f"camera_head.pose_branch.{n}.bias"] = _f32(ch["pose_branch"][f"{n}_bias"])
    for head in ("depth_head", "point_head", "gaussian_head"):
        if head in params:
            _dpt_state_dict(sd, head, params[head])
    if "track_head" in params:
        sd.update(vggt_track_state_dict(params["track_head"]))
    return sd


def vggt_track_state_dict(params) -> dict:
    """The reference track head's param tree -> ``track_head.*``."""
    sd = {}
    _dpt_state_dict(sd, "track_head.feature_extractor", params["feature_extractor"])
    tk, pre = params["tracker"], "track_head.tracker."

    def linear(key, p):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _f32(np.asarray(p["kernel"]).T), _f32(p["bias"])

    def norm(key, p):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _f32(p["scale"]), _f32(p["bias"])

    def mlp(key, p):
        linear(f"{key}.fc1", {"kernel": p["fc1_kernel"], "bias": p["fc1_bias"]})
        linear(f"{key}.fc2", {"kernel": p["fc2_kernel"], "bias": p["fc2_bias"]})

    def mha(key, p):
        sd[f"{key}.in_proj_weight"], sd[f"{key}.in_proj_bias"] = _f32(p["in_proj_weight"]), _f32(p["in_proj_bias"])
        sd[f"{key}.out_proj.weight"], sd[f"{key}.out_proj.bias"] = _f32(p["out_proj_weight"]), _f32(p["out_proj_bias"])

    norm(pre + "fmap_norm", tk["fmap_norm"])
    mlp(pre + "corr_mlp", tk["corr_mlp"])
    uf = tk["updateformer"]
    linear(pre + "updateformer.input_transform", uf["input_transform"])
    linear(pre + "updateformer.flow_head", uf["flow_head"])
    sd[pre + "updateformer.virual_tracks"] = _f32(uf["virual_tracks"])
    for kind in ("time_blocks", "space_virtual_blocks"):
        for i, b in enumerate(uf[kind]):
            key = f"{pre}updateformer.{kind}.{i}"
            norm(f"{key}.norm1", b["norm1"])
            mha(f"{key}.attn", b["attn"])
            norm(f"{key}.norm2", b["norm2"])
            mlp(f"{key}.mlp", b["mlp"])
    for kind in ("space_point2virtual_blocks", "space_virtual2point_blocks"):
        for i, b in enumerate(uf[kind]):
            key = f"{pre}updateformer.{kind}.{i}"
            for n in ("norm1", "norm_context", "norm2"):
                norm(f"{key}.{n}", b[n])
            mha(f"{key}.cross_attn", b["cross_attn"])
            mlp(f"{key}.mlp", b["mlp"])
    norm(pre + "ffeat_norm", tk["ffeat_norm"])
    for src, dst in (("ffeat_updater", "ffeat_updater.0"), ("vis_predictor", "vis_predictor.0"),
                     ("conf_predictor", "conf_predictor.0")):
        linear(pre + dst, tk[src])
    return sd


def patchmatchnet_state_dict(params, eps: float = 1e-5) -> dict:
    """The reference's PatchmatchNet param tree (BatchNorm folded into a
    scale and shift) -> the official model_000007.ckpt layout of
    ``densify.patchmatchnet.PatchmatchNet``. Each folded BatchNorm comes
    back as weight = scale, bias = shift, running_mean = 0 and
    running_var = 1 - eps, which folds to the same scale and shift."""
    sd = {}

    def conv(key, p, transposed=False):
        w = np.asarray(p["w"])  # HWIO
        sd[f"{key}.weight"] = _f32(w.transpose(2, 3, 0, 1) if transposed else w.transpose(3, 2, 0, 1))
        if "b" in p:
            sd[f"{key}.bias"] = _f32(p["b"])

    def bn(key, scale, shift):
        n = np.asarray(scale).shape[0]
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _f32(scale), _f32(shift)
        sd[f"{key}.running_mean"] = torch.zeros(n)
        sd[f"{key}.running_var"] = torch.full((n,), 1.0 - eps)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def cbr(key, p):
        conv(f"{key}.conv", p)
        bn(f"{key}.bn", p["scale"], p["shift"])

    def cbr3d(key, p):
        sd[f"{key}.conv.weight"] = _f32(np.asarray(p["w"]).T[:, :, None, None, None])
        bn(f"{key}.bn", p["scale"], p["shift"])

    def conv3d(key, p):
        sd[f"{key}.weight"] = _f32(np.asarray(p["w"]).T[:, :, None, None, None])
        sd[f"{key}.bias"] = _f32(p["b"])

    feat = params["feature"]
    for i in range(11):
        cbr(f"feature.conv{i}", feat[f"conv{i}"])
    for name in ("output1", "output2", "output3", "inner1", "inner2"):
        conv(f"feature.{name}", feat[name])
    for s in (1, 2, 3):
        q, p = f"patchmatch_{s}", params[f"patchmatch_{s}"]
        conv(f"{q}.eval_conv", p["eval_conv"])
        if "propa_conv" in p:
            conv(f"{q}.propa_conv", p["propa_conv"])
        for net, key in (("feature_weight_net", f"{q}.feature_weight_net"),
                         ("similarity_net", f"{q}.evaluation.similarity_net"),
                         ("pixel_wise_net", f"{q}.evaluation.pixel_wise_net")):
            if net not in p:
                continue
            cbr3d(f"{key}.conv0", p[net]["conv0"])
            cbr3d(f"{key}.conv1", p[net]["conv1"])
            final = "conv2" if net == "pixel_wise_net" else "similarity"
            conv3d(f"{key}.{final}", p[net][final])
    ref = params["refinement"]
    for i in range(4):
        cbr(f"upsample_net.conv{i}", ref[f"conv{i}"])
    conv("upsample_net.deconv", ref["deconv"], transposed=True)
    conv("upsample_net.res", ref["res"])
    bn("upsample_net.bn", ref["bn"]["scale"], ref["bn"]["shift"])
    return sd
