#!/usr/bin/env python3
"""Drive the PyTorch port (gtsfm_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each printing one or more lines:

1. device: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile every csrc/*.cu from the checkout (one nvcc per source,
   all at once, sm_90a);
3. kernel: the fused mutual-NN matcher kernel against its plain PyTorch
   version on the card, at the two-view shape of the slice (P=96 pairs,
   K=1024, D=128), plus an all-masked pair and a K=1000 pair; both timed
   (median of 20 runs, CUDA events);
4. attention: the fused attention kernel through all four entries against
   their plain versions: LightGlue's shape (P=96 pairs, K=2048, 4 heads of
   64, masked keys), a fully masked key set, K=1000, K=384 and K0 != K1;
   each entry timed at LightGlue's shape (median of 20 runs, CUDA events);
5. slice: SceneOptimizer.run on a 32-camera ring fed through the detector
   slot with synthetic keypoints and descriptors (the descriptor feed
   below), on `cuda`; 32/32 cameras registered and pose AUC@5 >= 0.978
   required, and the matcher kernel must have launched during the run;
6. lightglue: the same ring through SceneOptimizer.run with the LightGlue
   matcher at full width (dim 256, 9 layers, 4 heads, bf16) on the glue
   fixture below, K=2048 keypoints with D=256 descriptors; 32/32
   registered, AUC@5 >= 0.978 and attention launches during the run
   required, and the matches through the kernel must agree with a forward
   through the plain attention on every decisive row.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero with no result.
There is no CPU mode: without a CUDA device the script stops.

The descriptor feed and the glue fixture are defined here once, with numpy
only; the CPU tests import them from this file.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

NUM_CAMERAS = 32
IMAGE_HW = (240, 320)
FOCAL = 300.0
NUM_KEYPOINTS = 1024
DESC_DIM = 128
AUC5_BAR = 0.978  # the 32-camera gate's bar (tests/scene/test_accuracy_gate_32.py)
KERNEL_TOL_BEST = 1e-5  # |best| agreement; sums of exact bf16 products, f32 order only
KERNEL_GAP = 1e-4  # idx/ok must agree where best and second differ by more
# attention kernel vs plain version, both bf16 out: |got - want| <=
# ATTN_TOL_V * max|v| + ATTN_TOL_OUT * |want|. Two bf16 roundings differ:
# the probabilities (the kernel rounds exp(s - running max) and divides by
# the float32 sum at the end, the plain version rounds the normalized
# softmax; each is within 2^-9 of exact, so the outputs differ by at most
# 2^-8 * sum p|v| <= 2^-8 max|v|) and the outputs (each rounded to bf16, at
# most one ulp, 2^-7 relative, apart).
ATTN_TOL_V = 2.0**-8
ATTN_TOL_OUT = 2.0**-7

GLUE_KEYPOINTS = 2048  # max_keypoints of gtsfm_tpu/configs/deep_front_end.yaml
GLUE_DESC_DIM = 256  # SuperPoint's descriptor width, LightGlue's input_dim
GLUE_SIGMA = 0.05 * (DESC_DIM / GLUE_DESC_DIM) ** 0.5  # the feed's noise norm at D=128
# matches through the kernel and through the plain attention must agree on
# every row whose log-assignment top-2 margin (row and matched column) and
# distance to the match threshold exceed this: bf16 forwards that round
# attention at different places drift apart (0.33 max after two layers,
# port against reference on the CPU; 0.76 max after nine layers at K=2048,
# kernel against plain on an H100)
GLUE_GAP = 1.0


# ---------------------------------------------------------------------------
# the descriptor feed (numpy only)
# ---------------------------------------------------------------------------
def ring_pairs(n: int) -> np.ndarray:
    """(i, i+1..3) mod n as sorted unique (i1 < i2) pairs: 3n pairs."""
    ring = [(i, (i + k) % n) for i in range(n) for k in (1, 2, 3)]
    return np.asarray(sorted({(min(a, b), max(a, b)) for a, b in ring}), np.int32)


def descriptor_feed(
    R: np.ndarray,
    t: np.ndarray,
    focal: float,
    image_hw: tuple,
    num_points: int,
    dim: int = DESC_DIM,
    noise_px: float = 0.4,
    desc_sigma: float = 0.05,
    distractor_fraction: float = 0.1,
    seed: int = 0,
):
    """Keypoints and descriptors of a synthetic scene, per image.

    R (N, 3, 3), t (N, 3): camera-to-world GT poses; the calibration is a
    distortion-free Cal3Bundler with the principal point at the image
    center. ``num_points`` 3D points are sampled as frontend/synthetic.py
    samples them; keypoint k of every image is the projection of point k
    (0.4 px noise) and is masked in where the point is in view. Each point
    has one random unit descriptor; each view adds N(0, 0.05^2) per
    dimension and renormalizes. In each image a random 10% of the keypoints
    are distractors with fresh random descriptors.

    Returns kp_xy f32 (N, K, 2), kp_mask bool (N, K), descs f32 (N, K, D).
    """
    rng = np.random.default_rng(seed)
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    n = len(t)
    h, w = image_hw
    fwd = R[:, :, 2]
    target = (t + fwd * np.linalg.norm(np.ptp(t, 0)) * 0.8).mean(0)
    spread = max(np.ptp(t, axis=0).max() * 0.4, 1.0)
    pts = target + rng.uniform(-spread, spread, (num_points, 3))

    p_cam = np.einsum("nji,nkj->nki", R, pts[None] - t[:, None, :])  # R^T (X - t)
    z = p_cam[..., 2]
    z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
    uv = focal * p_cam[..., :2] / z_safe[..., None] + np.array([w / 2.0, h / 2.0])
    kp_mask = (z > 1e-6) & (uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
    uv = uv + rng.normal(0, noise_px, uv.shape)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    base = unit(rng.normal(size=(num_points, dim)))
    descs = unit(base[None] + desc_sigma * rng.normal(size=(n, num_points, dim)))
    n_dis = int(round(distractor_fraction * num_points))
    for i in range(n):
        idx = rng.permutation(num_points)[:n_dis]
        descs[i, idx] = unit(rng.normal(size=(n_dis, dim)))
    return uv.astype(np.float32), kp_mask, descs.astype(np.float32)


def glue_fixture(seed: int = 0, dim: int = 256, num_layers: int = 9, num_heads: int = 4,
                 input_dim: int = 256) -> dict:
    """A LightGlue state_dict in the official layout (numpy float32) that
    matches the descriptor feed: a test input, not a trained model.

    Every linear weight and bias is drawn as PyTorch's default nn.Linear
    init draws them (uniform +-1/sqrt(fan_in)) and posenc.Wr from N(0, 1),
    except: input_proj = alpha * I with alpha^2 = 200 (a descriptor's
    projection dominates the random residual updates), the last
    log_assignment head's final_proj = I (the assignment scores the
    transformed descriptors' similarity), its matchability weight 0 and
    bias +8 (every keypoint matchable), and LayerNorms at weight 1, bias 0.
    The attention still moves the assignment: the 9 random layers sit in
    the residual stream between the projection and the head."""
    rng = np.random.default_rng(seed)
    head_dim = dim // num_heads
    sd = {}

    def linear(key, fan_in, fan_out, bias=True):
        b = 1.0 / np.sqrt(fan_in)
        sd[f"{key}.weight"] = rng.uniform(-b, b, (fan_out, fan_in)).astype(np.float32)
        if bias:
            sd[f"{key}.bias"] = rng.uniform(-b, b, fan_out).astype(np.float32)

    def ffn(key):
        linear(f"{key}.0", 2 * dim, 2 * dim)
        sd[f"{key}.1.weight"] = np.ones(2 * dim, np.float32)
        sd[f"{key}.1.bias"] = np.zeros(2 * dim, np.float32)
        linear(f"{key}.3", 2 * dim, dim)

    sd["input_proj.weight"] = (np.sqrt(200.0) * np.eye(dim, input_dim)).astype(np.float32)
    sd["input_proj.bias"] = np.zeros(dim, np.float32)
    sd["posenc.Wr.weight"] = rng.normal(size=(head_dim // 2, 2)).astype(np.float32)
    for i in range(num_layers):
        sa, ca = f"transformers.{i}.self_attn", f"transformers.{i}.cross_attn"
        linear(f"{sa}.Wqkv", dim, 3 * dim)
        linear(f"{sa}.out_proj", dim, dim)
        ffn(f"{sa}.ffn")
        for name in ("to_qk", "to_v", "to_out"):
            linear(f"{ca}.{name}", dim, dim)
        ffn(f"{ca}.ffn")
        la = f"log_assignment.{i}"
        if i < num_layers - 1:
            linear(f"{la}.matchability", dim, 1)
            linear(f"{la}.final_proj", dim, dim)
        else:
            sd[f"{la}.matchability.weight"] = np.zeros((1, dim), np.float32)
            sd[f"{la}.matchability.bias"] = np.full(1, 8.0, np.float32)
            sd[f"{la}.final_proj.weight"] = np.eye(dim, dtype=np.float32)
            sd[f"{la}.final_proj.bias"] = np.zeros(dim, np.float32)
    return sd


class FeedDetector:
    """Detector-slot stub (detect_batch(images) -> (kp_xy, kp_mask, descs))
    handing out the feed's per-image arrays in call order."""

    def __init__(self, kp_xy, kp_mask, descs):
        self.kp_xy, self.kp_mask, self.descs = kp_xy, kp_mask, descs
        self.max_keypoints = kp_xy.shape[1]
        self._next = 0

    def detect_batch(self, images):
        s = self._next
        self._next += images.shape[0]
        e = self._next
        return self.kp_xy[s:e], self.kp_mask[s:e], self.descs[s:e]


class FixedPairs:
    """Retriever returning a fixed pair list."""

    def __init__(self, pairs):
        self.pairs = pairs

    def get_image_pairs(self, num_images, global_descriptors=None, loader=None):
        return self.pairs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device found; this script runs the port on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}", flush=True)
    return smi


def phase_build():
    from gtsfm_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build(verbose=True)
    print(f"build: {', '.join(f'{n}.cu' for n in logs)} in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, log in logs.items():
        regs = " ".join(line.strip() for line in log.splitlines() if "registers" in line)
        print(f"build {name}.cu: {regs}", flush=True)


def _median_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_agrees(got, want, desc1, desc2, mask1, mask2):
    """Hold the kernel's (idx, ok, best) against the plain version's on the
    same inputs: ``best`` must agree to KERNEL_TOL_BEST, and ``idx`` / ``ok``
    exactly on every row whose best and second-best similarities differ by
    more than KERNEL_GAP (float32 sums of exact bf16 products in another
    order may swap nearer ties).

    Returns (max |best| error, decisive rows, decisive rows that differ);
    the kernel agrees when the error is within tolerance and none differ."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers.mutual_nn import NEG
    from gtsfm_tpu_torch.utils.numerics import precise

    with precise():
        a = desc1.to(torch.bfloat16).float()
        b = desc2.to(torch.bfloat16).float()
        sim = torch.where(mask1[..., :, None] & mask2[..., None, :], a @ b.transpose(-1, -2),
                          torch.full((), NEG, device=a.device))
    if sim.shape[-1] > 1:
        second = torch.topk(sim, 2, dim=-1).values[..., 1]
    else:  # no other column: the plain version's second best is the mask value
        second = torch.full_like(sim[..., 0], NEG)
    gi, gok, gb = got
    wi, wok, wb = want
    err = float((gb - wb).abs().max())
    decisive = (wb - second) > KERNEL_GAP
    bad = int((decisive & ((gi != wi) | (gok != wok))).sum())
    return err, int(decisive.sum()), bad


def phase_kernel(kp_mask, descs, pairs):
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_matcher
    from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
    from gtsfm_tpu_torch.utils.numerics import precise

    dev = torch.device("cuda")
    d = torch.as_tensor(descs, device=dev)
    m = torch.as_tensor(kp_mask, device=dev)
    i1 = torch.as_tensor(pairs[:, 0], device=dev, dtype=torch.int64)
    i2 = torch.as_tensor(pairs[:, 1], device=dev, dtype=torch.int64)
    cases = {"P96_K1024": (d[i1], d[i2], m[i1], m[i2])}
    masked = torch.zeros_like(m[:1])
    cases["all_masked"] = (d[:1], d[1:2], masked, masked)
    cases["K1000"] = (d[i1[:1], :1000], d[i2[:1], :1000], m[i1[:1], :1000], m[i2[:1], :1000])

    worst = 0.0
    with precise():
        for name, (a, b, ma, mb) in cases.items():
            got = fused_matcher.fused_match_descriptors(a, b, ma, mb)
            want = match_descriptors(a, b, ma, mb)
            err, n_dec, bad = kernel_agrees(got, want, a, b, ma, mb)
            if name == "all_masked" and bool(got[1].any()):
                raise AssertionError("all-masked pair produced matches")
            if err > KERNEL_TOL_BEST or bad:
                raise AssertionError(f"kernel disagrees on {name}: max|best| err {err:.3g}, "
                                     f"{bad}/{n_dec} decisive rows differ")
            worst = max(worst, err)
            print(f"kernel check {name}: max|best| err {err:.3g}, {n_dec} decisive rows agree, "
                  f"{int(got[1].sum())} matches", flush=True)
        a, b, ma, mb = cases["P96_K1024"]
        order = []
        ms = {}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = (lambda: match_descriptors(a, b, ma, mb)) if which == "plain" else (
                lambda: fused_matcher.fused_match_descriptors(a, b, ma, mb))
            order.append((which, _median_ms(fn)))
        for which in ("plain", "kernel"):
            ms[which] = float(np.median([t for w, t in order if w == which]))
    print(f"kernel timing P96_K1024 (median of 20, CUDA events): kernel {ms['kernel']:.4f} ms, "
          f"plain {ms['plain']:.4f} ms | runs {order}", flush=True)
    return worst, ms


def attention_agrees(got, want, v):
    """Hold the attention kernel's output against the plain version's on
    the same inputs: every element within ATTN_TOL_V * max|v| +
    ATTN_TOL_OUT * |want|. Returns (max abs error, worst error over its
    bound, finite); the kernel agrees when the ratio is <= 1 and every
    value is finite."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = ATTN_TOL_V * v.float().abs().max() + ATTN_TOL_OUT * w.abs()
    return float(err.max()), float((err / bound).max()), bool(torch.isfinite(g).all())


def attention_entries(q0, q1, v0, v1, m0, m1, heads):
    """The four entries of fused_attention on one image pair batch, each as
    (name, kernel call, plain call, v the output weighs, output index):
    self attention of image 0 over image 1's keys (split and merged
    layouts), and both directions of cross attention (split and merged)."""
    from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa

    sp = [fa.split_heads(x, heads) for x in (q0, q1, v0, v1)]
    return [
        ("fused_attention", lambda: [fa.fused_attention(sp[0], sp[1], sp[3], m1)],
         lambda: [fa.attend(sp[0], sp[1], sp[3], m1)], [v1]),
        ("fused_attention_merged", lambda: [fa.fused_attention_merged(q0, q1, v1, heads, m1)],
         lambda: [fa.attend_merged(q0, q1, v1, heads, m1)], [v1]),
        ("fused_cross_attention", lambda: list(fa.fused_cross_attention(*sp, m0, m1)),
         lambda: list(fa.cross_attend(*sp, m0, m1)), [v1, v0]),
        ("fused_cross_attention_merged",
         lambda: list(fa.fused_cross_attention_merged(q0, q1, v0, v1, heads, m0, m1)),
         lambda: list(fa.cross_attend_merged(q0, q1, v0, v1, heads, m0, m1)), [v1, v0]),
    ]


def phase_attention(seed: int = 0):
    """All four attention entries against their plain versions, then each
    timed at LightGlue's shape. Returns (worst max abs error, {entry:
    {"kernel": ms, "plain": ms}})."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa
    from gtsfm_tpu_torch.utils.numerics import precise

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    heads, dh = 4, 64

    def make(P, K0, K1, masked=0.2):
        """q/k and v of both images, bf16 (P, K, heads*dh); key masks."""
        def x(K):
            return torch.as_tensor(rng.normal(size=(P, K, heads * dh)).astype(np.float32),
                                   device=dev).to(torch.bfloat16)

        m0 = torch.as_tensor(rng.random((P, K0)) >= masked, device=dev)
        m1 = torch.as_tensor(rng.random((P, K1)) >= masked, device=dev)
        return x(K0), x(K1), x(K0), x(K1), m0, m1

    cases = {
        "P96_K2048": make(96, GLUE_KEYPOINTS, GLUE_KEYPOINTS),
        "all_masked": make(2, 256, 256, masked=1.0),
        "K1000": make(4, 1000, 1000),
        "K384": make(4, 384, 384),
        "K0_1000_K1_384": make(4, 1000, 384),
    }
    worst = 0.0
    with precise():
        for name, (q0, q1, v0, v1, m0, m1) in cases.items():
            for entry, kern, plain, vs in attention_entries(q0, q1, v0, v1, m0, m1, heads):
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                res = [attention_agrees(g, w, v) for g, w, v in zip(got, want, vs)]
                err = max(r[0] for r in res)
                ratio = max(r[1] for r in res)
                if ratio > 1.0 or not all(r[2] for r in res):
                    raise AssertionError(f"attention kernel disagrees on {name} / {entry}: max abs err "
                                         f"{err:.4g}, {ratio:.3f} of the tolerance, finite {[r[2] for r in res]}")
                if name == "all_masked":  # the -1e9 fill gives the mean of v, not NaN
                    o = got[0] if got[0].dim() == 3 else fa.merge_heads(got[0])
                    mean_v = v1.float().mean(dim=1, keepdim=True).expand(o.shape)
                    if attention_agrees(o, mean_v, v1)[1] > 1.0:
                        raise AssertionError(f"{entry}: a fully masked key set did not give the mean of v")
                worst = max(worst, err)
                print(f"attention check {name} {entry}: max abs err {err:.4g} "
                      f"({ratio:.3f} of the tolerance)", flush=True)

        q0, q1, v0, v1, m0, m1 = cases["P96_K2048"]
        ms = {}
        for entry, kern, plain, _vs in attention_entries(q0, q1, v0, v1, m0, m1, heads):
            runs = [(which, _median_ms(kern if which == "kernel" else plain))
                    for which in ("plain", "kernel", "kernel", "plain")]
            ms[entry] = {w: float(np.median([t for k, t in runs if k == w])) for w in ("kernel", "plain")}
            print(f"attention timing P96_K2048 {entry} (median of 20, CUDA events): kernel "
                  f"{ms[entry]['kernel']:.4f} ms, plain {ms[entry]['plain']:.4f} ms | runs {runs}", flush=True)
    del cases
    torch.cuda.empty_cache()
    return worst, ms


def _ring_slice(name, kp_xy, kp_mask, descs, pairs, R, t, matcher=None):
    """SceneOptimizer.run on the 32-camera ring on `cuda`, fed through the
    detector slot, with every kernel's launch count set to 0 just before
    the run and read just after. Requires 32/32 registered, pose AUC@5 >=
    AUC5_BAR and finite output. Returns ({"matcher": n, "attention": n},
    stage seconds)."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
    from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
    from gtsfm_tpu_torch.loader.synthetic import SyntheticSceneLoader
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions

    dev = torch.device("cuda")
    n = NUM_CAMERAS
    poses = SE3(R=torch.as_tensor(R, device=dev), t=torch.as_tensor(t, device=dev))
    cal = Cal3Bundler.create(
        torch.full((n,), FOCAL), torch.zeros(n), torch.zeros(n),
        torch.full((n,), IMAGE_HW[1] / 2.0), torch.full((n,), IMAGE_HW[0] / 2.0), device=dev,
    )
    loader = SyntheticSceneLoader(poses, cal=cal, image_size=IMAGE_HW)
    so = SceneOptimizer(
        SceneOptimizerOptions(),
        retriever=FixedPairs(pairs),
        detector=FeedDetector(kp_xy, kp_mask, descs),
        matcher=matcher,
    )
    fused_matcher.launch_count = 0
    fused_attention.launch_count = 0
    torch.cuda.synchronize()
    data, groups = so.run(loader)
    torch.cuda.synchronize()
    launches = {"matcher": fused_matcher.launch_count, "attention": fused_attention.launch_count}

    metrics = {g.name: {m.name: m for m in g.metrics} for g in groups}
    registered = data.number_images()
    auc5 = metrics["ba_pose_metrics"]["pose_auc_@5.0_deg"].scalar
    pts = data.points[data.track_mask]
    if not bool(torch.isfinite(pts).all()) or not bool(torch.isfinite(data.poses.R).all()):
        raise AssertionError(f"{name}: non-finite poses or points")
    sec = {
        "two_view_sec": metrics["frontend_summary"]["two_view_sec"].scalar,
        "backend_sec": metrics["multiview_optimizer_metrics"]["backend_sec"].scalar,
        "total_runtime_sec": metrics["total_summary"]["total_runtime_sec"].scalar,
    }
    matches = metrics["frontend_summary"]["num_matches_per_pair"].dist
    print(f"{name}: {registered}/{n} registered, pose AUC@5 {auc5:.4f} (bar {AUC5_BAR}), "
          f"{data.number_tracks()} tracks, matches per pair median {float(np.median(matches)):.0f} "
          f"min {int(np.min(matches))}, launches {launches} | "
          + " ".join(f"{k} {v:.3f}" for k, v in sec.items()), flush=True)
    if registered != n:
        raise AssertionError(f"{name}: registered {registered}/{n} cameras")
    if auc5 < AUC5_BAR:
        raise AssertionError(f"{name}: pose AUC@5 {auc5:.4f} < {AUC5_BAR}")
    return launches, sec


def phase_slice(kp_xy, kp_mask, descs, pairs, R, t):
    launches, _sec = _ring_slice("slice", kp_xy, kp_mask, descs, pairs, R, t)
    if launches["matcher"] <= 0:
        raise AssertionError("the slice never launched the matcher kernel")
    return launches["matcher"]


def glue_decisive(z, mask0, mask1, threshold: float):
    """Rows of a log-assignment z (P, K0+1, K1+1) whose match cannot change
    under a perturbation of z below GLUE_GAP/2: the row's top-2 margin, the
    top-2 margin of the column it picks, and the distance of its best score
    from log(threshold) all exceed GLUE_GAP."""
    import torch

    zi = torch.where(mask0[:, :, None] & mask1[:, None, :], z[:, :-1, :-1], -1e9)
    row = torch.topk(zi, 2, dim=2).values
    col = torch.topk(zi, 2, dim=1).values
    pick = torch.argmax(zi, dim=2)
    col_margin = torch.gather(col[:, 0] - col[:, 1], 1, pick)
    return (mask0 & (row[..., 0] - row[..., 1] > GLUE_GAP) & (col_margin > GLUE_GAP)
            & ((row[..., 0] - float(np.log(threshold))).abs() > GLUE_GAP))


def _plain_attention(fa):
    """Swap fused_attention's four entries for their plain versions; returns
    the function that swaps them back."""
    saved = {n: getattr(fa, n) for n in ("fused_attention", "fused_attention_merged",
                                         "fused_cross_attention", "fused_cross_attention_merged")}
    fa.fused_attention, fa.fused_attention_merged = fa.attend, fa.attend_merged
    fa.fused_cross_attention, fa.fused_cross_attention_merged = fa.cross_attend, fa.cross_attend_merged

    def restore():
        for k, v in saved.items():
            setattr(fa, k, v)

    return restore


def phase_lightglue(pairs, R, t):
    """The ring through SceneOptimizer.run with the LightGlue matcher at
    full width on the glue fixture, then the slice's matcher input through
    the kernel and through the plain attention (swapped in here), timed on
    the host clock (plain, kernel, kernel, plain). Returns (attention
    launches during the run, stage seconds, forward seconds)."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa
    from gtsfm_tpu_torch.frontend.matchers.lightglue import LightGlueMatcher, LightGlueOptions

    kp_xy, kp_mask, descs = descriptor_feed(R, t, FOCAL, IMAGE_HW, GLUE_KEYPOINTS, dim=GLUE_DESC_DIM,
                                            desc_sigma=GLUE_SIGMA)
    matcher = LightGlueMatcher(LightGlueOptions(), state_dict=glue_fixture(0))
    launches, sec = _ring_slice("lightglue", kp_xy, kp_mask, descs, pairs, R, t, matcher=matcher)
    if launches["attention"] <= 0:
        raise AssertionError("the LightGlue slice never launched the attention kernel")
    if launches["matcher"] != 0:
        raise AssertionError("the LightGlue slice launched the mutual-NN kernel")

    dev = torch.device("cuda")
    i1 = torch.as_tensor(pairs[:, 0], dtype=torch.int64, device=dev)
    i2 = torch.as_tensor(pairs[:, 1], dtype=torch.int64, device=dev)
    d, xy, m = (torch.as_tensor(a, device=dev) for a in (descs, kp_xy, kp_mask))
    args = (d[i1], d[i2], xy[i1], xy[i2], m[i1], m[i2], (IMAGE_HW[1], IMAGE_HW[0]))
    z, fwd_sec = {}, {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        restore = _plain_attention(fa) if which == "plain" else (lambda: None)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z[which] = matcher.log_assignment(*args)
            torch.cuda.synchronize()
            fwd_sec[which].append(time.perf_counter() - t0)
        finally:
            restore()
    m0, m1 = args[4], args[5]
    idx = {w: matcher._postprocess(z[w], m0, m1)[0] for w in z}
    decisive = glue_decisive(z["plain"], m0, m1, matcher.options.match_threshold)
    bad = int((decisive & (idx["kernel"] != idx["plain"])).sum())
    valid = torch.nn.functional.pad(m0, (0, 1), value=True)[:, :, None] & \
        torch.nn.functional.pad(m1, (0, 1), value=True)[:, None, :]
    zerr = float(torch.where(valid, (z["kernel"] - z["plain"]).abs(), 0.0).max())
    n_match = int((idx["kernel"] >= 0).sum())
    print(f"lightglue check: log-assignment max |kernel - plain| {zerr:.4g}; {int(decisive.sum())} "
          f"decisive rows (gap {GLUE_GAP}), {bad} differ; {n_match} matches through the kernel, "
          f"{int((idx['plain'] >= 0).sum())} through the plain attention | forward s (96 pairs, host "
          f"clock) kernel {fwd_sec['kernel']}, plain {fwd_sec['plain']}", flush=True)
    if bad or int(decisive.sum()) == 0:
        raise AssertionError(f"LightGlue matches through the kernel differ from the plain attention's "
                             f"on {bad} of {int(decisive.sum())} decisive rows")
    return launches["attention"], sec, {w: float(np.median(v)) for w, v in fwd_sec.items()}


def main() -> int:
    import torch

    smi = phase_device()
    phase_build()

    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses

    pairs = ring_pairs(NUM_CAMERAS)
    gt = spectral_ring_poses(pairs, NUM_CAMERAS)
    R, t = gt.R.numpy(), gt.t.numpy()
    kp_xy, kp_mask, descs = descriptor_feed(R, t, FOCAL, IMAGE_HW, NUM_KEYPOINTS)

    err, ms = phase_kernel(kp_mask, descs, pairs)
    attn_err, attn_ms = phase_attention()
    launches = phase_slice(kp_xy, kp_mask, descs, pairs, R, t)
    attn_launches, _sec, _fwd = phase_lightglue(pairs, R, t)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_mutual_nn_matcher",
        "route": "cuda",
        "source": "gtsfm_tpu_torch/csrc/fused_matcher.cu",
        "replaces": "gtsfm_tpu/frontend/matchers/pallas_matcher.py:29",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
    }, {
        "name": "fused_attention",
        "route": "cuda",
        "source": "gtsfm_tpu_torch/csrc/fused_attention.cu",
        "replaces": "gtsfm_tpu/frontend/matchers/pallas_attention.py:127",
        "also_replaces": ["gtsfm_tpu/frontend/matchers/pallas_attention.py:99",
                          "gtsfm_tpu/frontend/matchers/pallas_attention.py:29"],
        "launches": attn_launches,
        "max_abs_err": attn_err,
        "ms": attn_ms["fused_attention_merged"]["kernel"],
        "plain_ms": attn_ms["fused_attention_merged"]["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
