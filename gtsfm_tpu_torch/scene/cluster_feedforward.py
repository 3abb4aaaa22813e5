"""Feed-forward cluster optimizers (the VGGT, FastVGGT and AnySplat slots).

Port of gtsfm_tpu/scene/cluster_feedforward.py. ``ClusterFeedforward``
runs a feed-forward model on a cluster's images and turns its predictions
into an ``SfmData``, optionally polished by BA:

- the ``compact`` backbone (frontend/feedforward.py): poses, depth and
  patch confidence, multi-view tracks from its track features, depth
  self-tracks when fewer than 8 survive;
- the ``vggt_exact`` backbone (frontend/vggt.py): VGGT with the weights of
  ``vggt_weights_path`` (the public layout), or without a path a seeded
  reduced-dim VGGT with a reduced track head; its own intrinsics, its pixel
  confidence pooled to the compact model's patch grid and shifted to [0, 1]
  (1 - 1 / max(conf, 1)), tracks of frame-0 queries through the track head
  (the aggregator runs again there, as in the reference).

``ClusterFastFeedforward`` is the compact model with token-merged global
attention (stride 4). ``depth_to_splats`` lifts the depth maps to an
initial gaussian set (the anysplat slot with the compact backbone).

Models are cached per process (``_MODEL_CACHE``), keyed by the options,
the padded image size and the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment
from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.frontend.feedforward import (
    FeedforwardOptions,
    FeedforwardReconstruction,
    confident_patches,
    feedforward_to_sfm_data,
    feedforward_tracks_to_sfm_data,
    select_tracks_for_ba,
)
from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler, PinholeCamera
from gtsfm_tpu_torch.splat.gs_data import GSData
from gtsfm_tpu_torch.utils.numerics import resolve_device

MIN_TRACKS = 8  # fewer multi-view tracks fall back to depth self-tracks


class ClusterFeedforwardOptions(NamedTuple):
    model: FeedforwardOptions = FeedforwardOptions()
    # "compact" (frontend/feedforward.py) or "vggt_exact" (frontend/vggt.py,
    # the public VGGT-1B layout from vggt_weights_path)
    backbone: str = "compact"
    vggt_weights_path: str = ""
    run_post_ba: bool = True
    ba: BAOptions = BAOptions(max_iterations=10, layout="dense")
    conf_threshold: float = 0.5
    # multi-view tracks through the track head, else depth self-tracks
    use_tracking: bool = True
    tracks_per_camera: int = 12
    track_vis_threshold: float = 0.6


_MODEL_CACHE: dict = {}

# the seeded vggt_exact model without weights (the reference's shape-test
# dims), and its reduced track head
REDUCED_VGGT = dict(embed_dim=64, depth=2, num_heads=4, dino_depth=2, dino_heads=4, dino_pretrain_grid=4,
                    camera_trunk_depth=2, camera_iterations=2, dpt_features=32, dpt_out_channels=(16, 32, 64, 64),
                    intermediate_layer_idx=(0, 0, 1, 1))
REDUCED_TRACK = dict(latent_dim=32, hidden_size=48, corr_levels=3, corr_radius=2, depth=2, num_heads=8,
                     num_virtual_tracks=8, iters=2, dpt_features=32)


def _resolve_model(opts: ClusterFeedforwardOptions, hw: tuple, state_dict=None, device="cuda"):
    """The cached compact model for ``hw`` on ``device`` (the card unless
    asked for the CPU); a ``state_dict`` replaces it."""
    key = (opts.model, tuple(hw), str(resolve_device(device)))
    if state_dict is not None or key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = FeedforwardReconstruction(opts.model, state_dict=state_dict, example_hw=hw,
                                                      device=device)
    return _MODEL_CACHE[key]


def _resolve_vggt(weights_path: str, hw: tuple, device):
    from gtsfm_tpu_torch.frontend.vggt import VGGTModel, VGGTOptions, load_torch_weights
    from gtsfm_tpu_torch.frontend.vggt_track import TrackOptions

    key = ("vggt_exact", weights_path, tuple(hw), str(torch.device(device)))
    if key not in _MODEL_CACHE:
        if weights_path:
            _MODEL_CACHE[key] = VGGTModel(state_dict=load_torch_weights(weights_path), device=device)
        else:
            _MODEL_CACHE[key] = VGGTModel(VGGTOptions(**REDUCED_VGGT), seed=0,
                                          track_options=TrackOptions(**REDUCED_TRACK), device=device)
    return _MODEL_CACHE[key]


def pad_to_patch_grid(images: np.ndarray, P: int) -> np.ndarray:
    """Zero-pad (B, H, W) images up to the patch grid."""
    B, H, W = images.shape
    Hp, Wp = -(-H // P) * P, -(-W // P) * P
    if (Hp, Wp) == (H, W):
        return images
    out = np.zeros((B, Hp, Wp), np.float32)
    out[:, :H, :W] = images
    return out


class ClusterFeedforward:
    """The feed-forward cluster optimizer on ``device``: the CUDA card by
    default, raising without one; pass ``device="cpu"`` for a CPU run."""

    def __init__(self, options: ClusterFeedforwardOptions = ClusterFeedforwardOptions(), state_dict=None,
                 device="cuda"):
        self.options = options
        self.state_dict = state_dict
        self.device = resolve_device(device)

    def run(self, images: np.ndarray, cal) -> tuple:
        """images (B, H, W) grayscale in [0, 1]; cal: batched calibration
        [B] on the device -> (SfmData, metrics)."""
        data, metrics, _raw = self.run_raw(images, cal)
        return data, metrics

    def run_raw(self, images: np.ndarray, cal) -> tuple:
        """run, and the raw products (poses, depth (B, H, W), patch
        confidence) that depth_to_splats takes."""
        opts = self.options
        B, H, W = images.shape
        P = opts.model.patch_size
        Hp, Wp = -(-H // P) * P, -(-W // P) * P
        images = pad_to_patch_grid(images, P)
        vggt_model = model = None
        if opts.backbone == "vggt_exact":
            poses, depth, conf, cal, vggt_model = self._run_vggt_exact(images, cal)
        else:
            model = _resolve_model(opts, (Hp, Wp), self.state_dict, self.device)
            poses, depth, conf, _focal = model.run(images)
        depth, conf = depth.cpu().numpy(), conf.cpu().numpy()
        hp_c, wp_c = max(1, -(-H // P)), max(1, -(-W // P))
        if (Hp, Wp) != (H, W):
            depth, conf = depth[:, :H, :W], conf[:, :hp_c, :wp_c]
        data = None
        if opts.use_tracking and vggt_model is not None and vggt_model.has_track_head:
            data = vggt_exact_tracks_to_sfm_data(
                vggt_model, images, poses, depth, conf, cal, conf_threshold=opts.conf_threshold,
                vis_threshold=opts.track_vis_threshold, per_camera=opts.tracks_per_camera, patch_size=P)
        if data is None and opts.use_tracking and opts.backbone == "compact":
            data = feedforward_tracks_to_sfm_data(
                poses, depth, conf, cal, model.last_track_feat[:, :hp_c, :wp_c],
                conf_threshold=opts.conf_threshold, vis_threshold=opts.track_vis_threshold,
                per_camera=opts.tracks_per_camera, patch_size=P)
        if data is None or data.number_tracks() < MIN_TRACKS:
            data = feedforward_to_sfm_data(poses, depth, conf, cal, conf_threshold=opts.conf_threshold)
        metrics = {"num_tracks_ff": data.number_tracks()}
        if opts.run_post_ba and data.number_tracks() > 4:
            fixed = torch.zeros(B, dtype=torch.bool, device=self.device)
            fixed[0] = True
            data, metrics["post_ba"] = BundleAdjustment(opts.ba).run(data, fixed_cam=fixed)
        return data, metrics, (poses, depth, conf)

    def _run_vggt_exact(self, images: np.ndarray, cal) -> tuple:
        """VGGT's products in the compact model's contract: wTi poses,
        depth, confidence pooled to the compact patch grid and shifted to
        [0, 1], and the predicted calibrations (Cal3Bundler of the mean
        focal and the principal point), with the model."""
        model = _resolve_vggt(self.options.vggt_weights_path, images.shape[1:], self.device)
        out = model.run(np.repeat(images[..., None], 3, axis=-1))
        R_wc, t_wc = out["extrinsic"][:, :, :3], out["extrinsic"][:, :, 3]
        poses = SE3(R=R_wc.transpose(1, 2), t=-torch.einsum("bij,bi->bj", R_wc, t_wc))
        K = out["intrinsic"]
        B = images.shape[0]
        z = torch.zeros(B, device=self.device)
        cal_pred = Cal3Bundler.create(0.5 * (K[:, 0, 0] + K[:, 1, 1]), z, z, K[:, 0, 2], K[:, 1, 2])
        depth = out["depth"]
        P = self.options.model.patch_size
        Bc, H, W = depth.shape
        hp, wp = max(1, H // P), max(1, W // P)
        conf = out["depth_conf"][:, : hp * P, : wp * P].reshape(Bc, hp, P, wp, P).mean(dim=(2, 4))
        conf = 1.0 - 1.0 / torch.clamp(conf, min=1.0)
        return poses, depth, conf, cal_pred, model


def vggt_exact_tracks_to_sfm_data(model, images: np.ndarray, poses: SE3, depth: np.ndarray, conf: np.ndarray, cal,
                                  conf_threshold: float = 0.5, vis_threshold: float = 0.6, max_queries: int = 256,
                                  per_camera: int = 12, patch_size: int = 14) -> Optional[SfmData]:
    """Tracks of frame 0's confident patch centers through VGGT's track
    head: kept where seen by >= 2 views (visibility times confidence),
    coverage-selected for BA, each 3D point frame 0's depth unprojected.
    None when no track survives."""
    B, H, W = images.shape
    hp, wp = conf.shape[1], conf.shape[2]
    s = patch_size
    good = confident_patches(conf[0, :hp, :wp].reshape(-1), conf_threshold, max_queries)
    if len(good) == 0:
        return None
    qy, qx = good // wp, good % wp
    qp = np.stack([(qx + 0.5) * s, (qy + 0.5) * s], axis=-1).astype(np.float32)
    out = model.track(np.repeat(images[..., None], 3, axis=-1), qp)
    xy = out["tracks"].cpu().numpy()
    vis = (out["vis"] * out["conf"]).cpu().numpy()
    valid = vis.T >= vis_threshold  # (Q, B)
    valid[:, 0] = True
    multi = valid.sum(axis=1) >= 2
    chosen = np.nonzero(select_tracks_for_ba(vis.T * multi[:, None], valid & multi[:, None],
                                             per_camera=per_camera))[0]
    Hd, Wd = depth.shape[1], depth.shape[2]
    uv_ref = qp[chosen]
    iy = np.minimum(uv_ref[:, 1].astype(np.int64), Hd - 1)
    ix = np.minimum(uv_ref[:, 0].astype(np.int64), Wd - 1)
    dev = poses.t.device
    cam0 = PinholeCamera(pose=poses, cal=cal).map(lambda a: a[0])
    X = cam0.backproject(torch.as_tensor(uv_ref, device=dev),
                         torch.as_tensor(depth[0, iy, ix], device=dev)).cpu().numpy()
    tracks = []
    for j, qi in enumerate(chosen):
        obs = []
        for b in range(B):
            if not valid[qi, b]:
                continue
            uv = uv_ref[j] if b == 0 else xy[b, qi]
            if 0 <= uv[0] < W and 0 <= uv[1] < H:
                obs.append((b, np.asarray(uv, np.float32)))
        if len(obs) >= 2:
            tracks.append((X[j], obs))
    if not tracks:
        return None
    return SfmData.from_cameras_and_tracks(poses, cal, tracks, num_cameras=B)


class ClusterFastFeedforward(ClusterFeedforward):
    """The FastVGGT-class slot: the compact model with token-merged global
    attention (``global_kv_stride`` 4 unless the options set more than 1)."""

    def __init__(self, options: Optional[ClusterFeedforwardOptions] = None, state_dict=None, device="cuda"):
        if options is None:
            options = ClusterFeedforwardOptions(model=FeedforwardOptions(global_kv_stride=4))
        elif options.model.global_kv_stride <= 1:
            options = options._replace(model=options.model._replace(global_kv_stride=4))
        super().__init__(options, state_dict=state_dict, device=device)


def depth_to_splats(poses: SE3, depth: np.ndarray, conf: np.ndarray, cal, images: Optional[np.ndarray] = None,
                    conf_threshold: float = 0.5, stride: int = 8, max_gaussians: int = 100_000) -> GSData:
    """Confident depths every ``stride`` pixels lifted to gaussians, frame
    by frame until more than ``max_gaussians``: the scale the pixel
    footprint at the depth, the color the source image's."""
    B, H, W = depth.shape
    pts, cols, scales = [], [], []
    dev = poses.t.device
    for b in range(B):
        cam = PinholeCamera(pose=poses, cal=cal).map(lambda a: a[b])
        f = float(cam.cal.fx)
        hp, wp = conf[b].shape
        ys, xs = np.mgrid[0:H:stride, 0:W:stride]
        keep = conf[b][np.minimum(ys * hp // H, hp - 1), np.minimum(xs * wp // W, wp - 1)] >= conf_threshold
        uv = np.stack([xs[keep], ys[keep]], -1).astype(np.float32)
        d = depth[b][ys[keep], xs[keep]].astype(np.float32)
        pts.append(cam.backproject(torch.as_tensor(uv, device=dev), torch.as_tensor(d, device=dev)).cpu().numpy())
        scales.append(d * stride / f)
        if images is not None:
            cols.append(images[b][ys[keep], xs[keep]])
        if sum(len(p) for p in pts) > max_gaussians:
            break
    P = np.concatenate(pts)[:max_gaussians]
    S = np.concatenate(scales)[:max_gaussians]
    C = np.concatenate(cols)[:max_gaussians] if cols else None
    gs = GSData.from_points(P, colors=C, max_gaussians=len(P), device=dev)
    return gs.replace(log_scales=torch.as_tensor(np.log(np.maximum(S, 1e-5))[:, None].repeat(3, 1), device=dev))
