#!/usr/bin/env python3
"""Drive the PyTorch port (gtsfm_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each printing one line:

1. device: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile csrc/fused_matcher.cu from the checkout (nvcc, sm_90a);
3. kernel: the fused mutual-NN matcher kernel against its plain PyTorch
   version on the card, at the two-view shape of the slice (P=96 pairs,
   K=1024, D=128), plus an all-masked pair and a K=1000 pair; both timed
   (median of 20 runs, CUDA events);
4. slice: SceneOptimizer.run on a 32-camera ring fed through the detector
   slot with synthetic keypoints and descriptors (the descriptor feed
   below), on `cuda`; 32/32 cameras registered and pose AUC@5 >= 0.978
   required, and the matcher kernel must have launched during the run.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero with no result.
There is no CPU mode: without a CUDA device the script stops.

The descriptor feed is defined here once, with numpy only; the CPU tests
import it from this file.
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
    from gtsfm_tpu_torch.frontend.matchers import fused_matcher

    t0 = time.perf_counter()
    log = fused_matcher.build_library(verbose=True)
    regs = " ".join(line.strip() for line in log.splitlines() if "registers" in line or "smem" in line)
    print(f"build: fused_matcher.cu in {time.perf_counter() - t0:.2f}s | {regs}", flush=True)


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


def phase_slice(kp_xy, kp_mask, descs, pairs, R, t):
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_matcher
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
    )
    fused_matcher.launch_count = 0
    torch.cuda.synchronize()
    data, groups = so.run(loader)
    torch.cuda.synchronize()
    launches = fused_matcher.launch_count

    metrics = {g.name: {m.name: m for m in g.metrics} for g in groups}
    registered = data.number_images()
    auc5 = metrics["ba_pose_metrics"]["pose_auc_@5.0_deg"].scalar
    pts = data.points[data.track_mask]
    if not bool(torch.isfinite(pts).all()) or not bool(torch.isfinite(data.poses.R).all()):
        raise AssertionError("non-finite poses or points")
    sec = {
        "two_view_sec": metrics["frontend_summary"]["two_view_sec"].scalar,
        "backend_sec": metrics["multiview_optimizer_metrics"]["backend_sec"].scalar,
        "total_runtime_sec": metrics["total_summary"]["total_runtime_sec"].scalar,
    }
    print(f"slice: {registered}/{n} registered, pose AUC@5 {auc5:.4f} (bar {AUC5_BAR}), "
          f"{data.number_tracks()} tracks, {launches} matcher launches | "
          + " ".join(f"{k} {v:.3f}" for k, v in sec.items()), flush=True)
    if registered != n:
        raise AssertionError(f"registered {registered}/{n} cameras")
    if auc5 < AUC5_BAR:
        raise AssertionError(f"pose AUC@5 {auc5:.4f} < {AUC5_BAR}")
    if launches <= 0:
        raise AssertionError("the slice never launched the matcher kernel")
    return launches


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
    launches = phase_slice(kp_xy, kp_mask, descs, pairs, R, t)

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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
