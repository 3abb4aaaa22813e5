"""The compact feed-forward reconstruction model (VGGT-class).

Port of gtsfm_tpu/frontend/feedforward.py: patch-embedded grayscale frames
-> ``depth`` pairs of a frame block (attention within each frame's tokens)
and a global block (attention over every token of every frame) -> a camera
token per frame decoded to a pose and a focal ratio, a per-patch depth
head, a confidence head and a track-feature head; then the tracking
helpers (frame ranking, correlation tracking with a 3x3 soft-argmax,
BA-coverage selection) and the conversions of the predictions to an
``SfmData``.

``FeedforwardNet`` is an ``nn.Module`` whose state_dict carries the
reference's Flax params (``utils/convert.feedforward_state_dict``). Flax's
defaults are kept: LayerNorm epsilon 1e-6, the tanh GELU. With
``global_kv_stride`` > 1 (FastVGGT-class) the global block attends to a
mean pool of every ``stride`` tokens, zero-padded at the end as the
reference pads (the last group's mean counts the pads). The frame
embedding has 32 rows, as the reference's: more than 32 views raise.

Attention is plain PyTorch (the reference's is an einsum and a softmax,
not a Pallas kernel), computed in chunks of query rows (``attention``) so
that the global block's scores fit the card. The net runs in float32 under
``precise()``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.geometry import SE3, PinholeCamera, so3
from gtsfm_tpu_torch.utils.numerics import attention, precise, resolve_device

LN_EPS = 1e-6  # flax.linen.LayerNorm's default
MAX_FRAMES = 32  # rows of the frame embedding


class FeedforwardOptions(NamedTuple):
    patch_size: int = 16
    dim: int = 256
    depth: int = 6  # pairs of (frame, global) attention
    num_heads: int = 4
    # FastVGGT-class: global keys and values are the mean pool of groups of
    # this many tokens (1 = the full global attention)
    global_kv_stride: int = 1
    track_dim: int = 64  # track-feature width


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(_gelu(self.fc1(x)))


class _MHA(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):  # (..., T, D), attention over T
        D = x.shape[-1]
        h, dh = self.heads, D // self.heads
        q, k, v = (a.reshape(a.shape[:-1] + (h, dh)) for a in self.qkv(x).chunk(3, dim=-1))
        out = attention(q, k, v, score_div=math.sqrt(dh))
        return self.proj(out.reshape(out.shape[:-2] + (D,)))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _MHA(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _CrossMHA(nn.Module):
    """Queries from x, keys and values from a (pooled) context y."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, y):
        D = x.shape[-1]
        h, dh = self.heads, D // self.heads
        q = self.q(x)
        k, v = self.kv(y).chunk(2, dim=-1)
        q, k, v = (a.reshape(a.shape[:-1] + (h, dh)) for a in (q, k, v))
        out = attention(q, k, v, score_div=math.sqrt(dh))
        return self.proj(out.reshape(out.shape[:-2] + (D,)))


class _FastGlobalBlock(nn.Module):
    """Every token attends to a stride-pooled summary of all tokens."""

    def __init__(self, dim: int, heads: int, stride: int):
        super().__init__()
        self.stride = stride
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_context = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _CrossMHA(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, 4 * dim)

    def forward(self, x):  # (1, N, D)
        B, N, D = x.shape
        s = self.stride
        pad = (-N) % s
        pooled = F.pad(x, (0, 0, 0, pad)).reshape(B, (N + pad) // s, s, D).mean(dim=-2)
        x = x + self.attn(self.norm1(x), self.norm_context(pooled))
        return x + self.mlp(self.norm2(x))


class FeedforwardNet(nn.Module):
    """The reference's ``FeedforwardNet`` for frames of ``hw`` (the
    position embedding has one row per patch of that size)."""

    def __init__(self, opts: FeedforwardOptions, hw: tuple):
        super().__init__()
        self.opts = o = opts
        hp, wp = hw[0] // o.patch_size, hw[1] // o.patch_size
        self.patch_embed = nn.Conv2d(1, o.dim, o.patch_size, stride=o.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, hp * wp, o.dim))
        self.camera_token = nn.Parameter(torch.zeros(1, 1, o.dim))
        self.frame_embed = nn.Parameter(torch.zeros(MAX_FRAMES, o.dim))
        self.frame_blocks = nn.ModuleList([_Block(o.dim, o.num_heads) for _ in range(o.depth)])
        self.global_blocks = nn.ModuleList([
            _FastGlobalBlock(o.dim, o.num_heads, o.global_kv_stride) if o.global_kv_stride > 1
            else _Block(o.dim, o.num_heads) for _ in range(o.depth)])
        self.pose_head = nn.Linear(o.dim, 7)
        self.depth_head = nn.Linear(o.dim, o.patch_size**2)
        self.conf_head = nn.Linear(o.dim, 1)
        self.track_head = nn.Linear(o.dim, o.track_dim)

    def forward(self, images: torch.Tensor):
        """images (B, H, W) grayscale in [0, 1] -> (pose_out (B, 7), depth
        (B, H, W), conf (B, hp, wp), unit track features (B, hp, wp,
        track_dim))."""
        o = self.opts
        B, H, W = images.shape
        if B > MAX_FRAMES:
            raise ValueError(f"{B} frames: the frame embedding has {MAX_FRAMES} rows")
        P = o.patch_size
        hp, wp = H // P, W // P
        tokens = self.patch_embed(images[:, None]).flatten(2).transpose(1, 2) + self.pos_embed
        tokens = torch.cat([self.camera_token.expand(B, -1, -1), tokens], dim=1)
        tokens = tokens + self.frame_embed[:B][:, None, :]
        T = tokens.shape[1]
        for fblk, gblk in zip(self.frame_blocks, self.global_blocks):
            tokens = fblk(tokens)
            tokens = gblk(tokens.reshape(1, B * T, o.dim)).reshape(B, T, o.dim)
        pose_out = self.pose_head(tokens[:, 0])
        patch = tokens[:, 1:]
        depth = self.depth_head(patch).reshape(B, hp, wp, P, P).permute(0, 1, 3, 2, 4).reshape(B, H, W)
        conf = self.conf_head(patch)[..., 0].reshape(B, hp, wp)
        tfeat = self.track_head(patch)
        tfeat = tfeat / torch.clamp(torch.linalg.vector_norm(tfeat, dim=-1, keepdim=True), min=1e-12)
        return pose_out, torch.exp(depth), torch.sigmoid(conf), tfeat.reshape(B, hp, wp, o.track_dim)


def init_net(opts: FeedforwardOptions, hw: tuple, seed: int = 0) -> FeedforwardNet:
    """The net at Flax's init scales (Dense and Conv kernels
    lecun-normal, biases 0, norms 1, the three embeddings N(0, 0.02^2)),
    drawn from a torch generator seeded with ``seed``; torch cannot repeat
    the reference's ``jax.random`` draws."""
    net = FeedforwardNet(opts, hw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name in ("pos_embed", "camera_token", "frame_embed"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif name.endswith("bias"):
                p.zero_()
            elif "norm" in name:
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
    return net


class FeedforwardReconstruction:
    """run(images (B, H, W)) -> (poses SE3 [B], depth (B, H, W), conf (B,
    hp, wp), focal ratio (B,)), the last track features in
    ``last_track_feat``. ``state_dict`` (the port's layout) or the seeded
    init of ``init_net``; the net runs on ``device``, the CUDA card unless
    given ``device="cpu"``."""

    def __init__(self, options: FeedforwardOptions = FeedforwardOptions(), state_dict: Optional[dict] = None,
                 example_hw: tuple = (64, 64), device="cuda"):
        device = resolve_device(device)
        self.options = options
        self.net = init_net(options, example_hw)
        if state_dict is not None:
            self.net.load_state_dict({k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
                                      for k, v in state_dict.items()})
        self.net.to(device).eval().requires_grad_(False)
        self.device = device
        self.last_track_feat = None

    def run(self, images) -> tuple:
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        with torch.no_grad(), precise():
            pose_out, depth, conf, track_feat = self.net(x)
        poses = SE3(R=so3.expmap(pose_out[:, :3]), t=pose_out[:, 3:6])
        self.last_track_feat = track_feat
        return poses, depth, conf, F.softplus(pose_out[:, 6]) + 0.5


def _backproject(poses: SE3, cal, cams: np.ndarray, uv: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """World points of pixels ``uv`` (N, 2) at ``depth`` (N,) seen by
    cameras ``cams`` (N,)."""
    dev = poses.t.device
    idx = torch.as_tensor(cams, dtype=torch.int64, device=dev)
    cam = PinholeCamera(pose=poses, cal=cal).map(lambda a: a[idx])
    X = cam.backproject(torch.as_tensor(uv, dtype=torch.float32, device=dev),
                        torch.as_tensor(depth, dtype=torch.float32, device=dev))
    return X.cpu().numpy()


def feedforward_to_sfm_data(poses: SE3, depth: np.ndarray, conf: np.ndarray, cal, conf_threshold: float = 0.5,
                            stride: int = 8, max_tracks: int = 2000) -> SfmData:
    """Confident depths, every ``stride`` pixels in raster order, frame by
    frame, unprojected to 3D points seen twice by their own view (tracks of
    length 2), at most ``max_tracks``."""
    B, H, W = depth.shape
    picks = []
    for b in range(B):
        hp, wp = conf[b].shape
        ys, xs = np.meshgrid(np.arange(0, H, stride), np.arange(0, W, stride), indexing="ij")
        ys, xs = ys.reshape(-1), xs.reshape(-1)
        keep = conf[b][np.minimum(ys * hp // H, hp - 1), np.minimum(xs * wp // W, wp - 1)] >= conf_threshold
        picks.append(np.stack([np.full(int(keep.sum()), b), ys[keep], xs[keep]], axis=-1))
    picks = np.concatenate(picks)[:max_tracks]
    uv = picks[:, [2, 1]].astype(np.float32)
    X = _backproject(poses, cal, picks[:, 0], uv, depth[picks[:, 0], picks[:, 1], picks[:, 2]])
    tracks = [(X[j], [(int(b), uv[j]), (int(b), uv[j])]) for j, b in enumerate(picks[:, 0])]
    return SfmData.from_cameras_and_tracks(poses, cal, tracks, num_cameras=B)


def rank_frames(track_feat: torch.Tensor) -> torch.Tensor:
    """Each frame's mean similarity of its mean unit feature to the other
    frames': track_feat (B, hp, wp, D) -> scores (B,)."""
    B = track_feat.shape[0]
    mean_tok = track_feat.reshape(B, -1, track_feat.shape[-1]).mean(dim=1)
    mean_tok = mean_tok / torch.clamp(torch.linalg.vector_norm(mean_tok, dim=-1, keepdim=True), min=1e-12)
    sim = mean_tok @ mean_tok.T
    return (sim.sum(dim=1) - 1.0) / max(B - 1, 1)


def track_queries(track_feat: torch.Tensor, query_feat: torch.Tensor) -> tuple:
    """Correlation tracking: per frame, the peak of each query's
    correlation map, refined by a soft-argmax (temperature 10) over its
    3x3 neighbourhood (clamped at the borders); the peak value is the
    visibility. track_feat (B, hp, wp, D), query_feat (Q, D) -> (xy (B, Q,
    2) in patch units, vis (B, Q))."""
    B, hp, wp, D = track_feat.shape
    corr = torch.einsum("qd,bhwd->bqhw", query_feat, track_feat)
    flat = corr.reshape(B, -1, hp * wp)
    vis, idx = flat.max(dim=-1)  # first maximum, as argmax
    cy, cx = idx // wp, idx % wp
    offs = torch.arange(-1, 2, device=corr.device)
    ys = torch.clamp(cy[..., None] + offs, 0, hp - 1)  # (B, Q, 3)
    xs = torch.clamp(cx[..., None] + offs, 0, wp - 1)
    Q = corr.shape[1]
    patch = corr[torch.arange(B, device=corr.device)[:, None, None, None],
                 torch.arange(Q, device=corr.device)[None, :, None, None], ys[..., :, None], xs[..., None, :]]
    w = torch.softmax(patch.reshape(B, Q, 9) * 10.0, dim=-1).reshape(B, Q, 3, 3)
    ref_y = (w * ys[..., :, None]).sum(dim=(-2, -1))
    ref_x = (w * xs[..., None, :]).sum(dim=(-2, -1))
    return torch.stack([ref_x, ref_y], dim=-1), vis


def select_tracks_for_ba(vis: np.ndarray, valid: np.ndarray, per_camera: int = 12) -> np.ndarray:
    """Greedy BA-coverage selection: tracks in order of total quality,
    each kept while it covers a camera seen by fewer than ``per_camera``
    kept tracks, until every camera has that many. vis, valid (Q, B) ->
    bool (Q,)."""
    Q, B = vis.shape
    coverage = np.zeros(B, np.int64)
    chosen = np.zeros(Q, bool)
    for q in np.argsort(-(vis * valid).sum(axis=1)):
        if (valid[q] & (coverage < per_camera)).any():
            chosen[q] = True
            coverage += valid[q]
        if (coverage >= per_camera).all():
            break
    return chosen


def confident_patches(flat_conf: np.ndarray, conf_threshold: float, max_queries: int) -> np.ndarray:
    """Indices of the confident patches, best first, at most
    ``max_queries`` (the best ``max_queries`` when none is confident)."""
    good = np.nonzero(flat_conf >= conf_threshold)[0]
    if len(good) == 0:
        good = np.argsort(-flat_conf)[: min(max_queries, flat_conf.size)]
    return good[np.argsort(-flat_conf[good])][:max_queries]


def feedforward_tracks_to_sfm_data(poses: SE3, depth: np.ndarray, conf: np.ndarray, cal, track_feat,
                                   conf_threshold: float = 0.5, vis_threshold: float = 0.6, max_queries: int = 512,
                                   per_camera: int = 12, patch_size: int = 16) -> Optional[SfmData]:
    """Multi-view tracks from the track features: the best-ranked frame's
    confident patches as queries, tracked across every frame, kept where
    seen by >= 2 views, coverage-selected for BA, each 3D point the
    reference frame's depth unprojected. None when no track survives."""
    B, H, W = depth.shape
    tf = torch.as_tensor(track_feat)
    _, hp, wp, _ = tf.shape
    ref = int(np.argmax(rank_frames(tf).cpu().numpy()))
    good = confident_patches(np.asarray(conf[ref])[:hp, :wp].reshape(-1), conf_threshold, max_queries)
    qy, qx = good // wp, good % wp
    qfeat = tf[ref, torch.as_tensor(qy, device=tf.device), torch.as_tensor(qx, device=tf.device)]
    xy, vis = track_queries(tf, qfeat)
    xy, vis = xy.cpu().numpy(), vis.cpu().numpy()
    valid = vis.T >= vis_threshold  # (Q, B)
    valid[:, ref] = True
    multi = valid.sum(axis=1) >= 2
    chosen = np.nonzero(select_tracks_for_ba(vis.T * multi[:, None], valid & multi[:, None],
                                             per_camera=per_camera))[0]
    s = patch_size
    uv_ref = np.stack([(qx[chosen] + 0.5) * s, (qy[chosen] + 0.5) * s], axis=-1).astype(np.float32)
    iy = np.minimum(uv_ref[:, 1].astype(np.int64), H - 1)
    ix = np.minimum(uv_ref[:, 0].astype(np.int64), W - 1)
    X = _backproject(poses, cal, np.full(len(chosen), ref), uv_ref, depth[ref, iy, ix])
    tracks = []
    for j, qi in enumerate(chosen):
        obs = []
        for b in range(B):
            if not valid[qi, b]:
                continue
            uv = uv_ref[j] if b == ref else (xy[b, qi] + 0.5) * s
            if 0 <= uv[0] < W and 0 <= uv[1] < H:
                obs.append((b, uv.astype(np.float32)))
        if len(obs) >= 2:
            tracks.append((X[j], obs))
    if not tracks:
        return None
    return SfmData.from_cameras_and_tracks(poses, cal, tracks, num_cameras=B)
