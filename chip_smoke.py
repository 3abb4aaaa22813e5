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
   K=1024, D=128), plus an all-masked pair, a K=1000 pair and the tiling's
   edges (K1 = 127 and 129, K2 = 63 and 65, D = 136, one pair); two
   launches must be bitwise equal and the finish kernel must equal its
   plain version (fused_matcher._finish); the HMMA and FFMA counts of its SASS
   (cuobjdump); both timed (median of 20 samples of back-to-back calls,
   CUDA events), the kernels also as a CUDA graph (their device time alone)
   and by the host's clock (the wrapper's host time per call), with its
   TFLOP/s and share of the bound;
4. attention: the fused attention kernel through all four entries against
   their plain versions: LightGlue's shape (P=96 pairs, K=2048, 4 heads of
   64, masked keys), a fully masked key set, K=1000, K=384, K0 != K1 and
   the tiling's edges (Kk = 1, Kk = 129, Kq = 1, Kq = 129, P = 2 at
   K = 2048); each entry timed at LightGlue's shape (median of 20 samples
   of back-to-back calls, CUDA events) in turns with its plain version and with
   scaled_dot_product_attention (once per direction) as the yardstick,
   with its TFLOP/s and share of the bound;
5. composite: the splat tile-compositing kernel against its plain version
   on the tiles of a seeded 50,000-gaussian scene (the splat scene below)
   seen by one ring camera at 480x640, f=600, binned by the port's
   render_tiled: a low-opacity copy where no tile stops early (|d| <=
   1e-5), the full scene (|d| <= 1/255 + 1e-5, the early stop's bound), an
   all-empty tile set (exact), a ragged tile count, and the kernel's
   edges: every count cut to 256 and to 257 (the stop boundary), indices
   -1 and G among the faint copy's slots, and cap 100 (only 64 slots
   composited); TiledComposite's gradient on the card against the plain
   path's; kernel and plain timed (median of 20 samples, CUDA events), the
   kernel also as a CUDA graph of 5 calls (its device time alone), with
   its share of the bound;
6. slice: SceneOptimizer.run on a 32-camera ring fed through the detector
   slot with synthetic keypoints and descriptors (the descriptor feed
   below), on `cuda`, with the splat trainer after it (run_gs, 400 steps on
   the loader's flat gray images); 32/32 cameras registered, pose AUC@5 >=
   0.978, a falling splat L1, and launches of the matcher and compositing
   kernels during the run required;
7. lightglue: the same ring through SceneOptimizer.run with the LightGlue
   matcher at full width (dim 256, 9 layers, 4 heads, bf16) on the glue
   fixture below, K=2048 keypoints with D=256 descriptors; 32/32
   registered, AUC@5 >= 0.978 and attention launches during the run
   required, and the matches through the kernel must agree with a forward
   through the plain attention on every decisive row;
8. gate: the twin of tests/scene/test_accuracy_gate_32.py on `cuda`: the
   32-camera ring through SceneOptimizer.run with the synthetic
   correspondence generator (600 points, 0.4 px noise) in the direct
   branch, flat; 32/32 registered and compare_reconstructions' pose AUC@5
   >= 0.978 required, and no matcher launch (the two-view batch verifies
   the generator's matches);
9. hierarchical: bench.py's palace-281 configuration through the port on
   `cuda`: 281 cameras, 4,095 pairs from the default SequentialRetriever,
   GT on a spectral ring over them, the synthetic generator (800 points,
   0.4 px), SceneOptimizerOptions(hierarchical=True, max_cluster_size=40):
   the METIS partition, per-cluster MVO, Sim3 merges with parent BAs; run
   cold and then warm, each requiring the METIS partitioner, >= 4
   clusters, no merge failure, no matcher launch, registered >= 278 (the
   JAX reference's 281 - 3, above test_scale_synthetic.py's 0.95 n), AUC@5
   >= the reference's 0.9739 - 0.02, and median rotation and translation
   errors after a Sim3 alignment to GT < 0.5 deg and < 0.3; prints the
   cluster tree and the stage seconds with the card's name and power limit;
10. splat: GaussianSplatting.train at full width, 50,000 gaussian slots at
   480x640 for 400 steps, on the 32 ring views of the splat scene rendered
   by the port; final L1 < 0.7 of the initial and >= 400 compositing
   launches required; seconds per step and peak device memory printed.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero with no result.
There is no CPU mode: without a CUDA device the script stops.

The descriptor feed, the glue fixture and the splat scene are defined here
once, with numpy only; the CPU tests import them from this file.
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

GATE_POINTS = 600  # the 32-camera gate's SyntheticOptions (tests/scene/test_accuracy_gate_32.py)
# the hierarchical phase: palace-281's size and bench.py's _palace_bench
# configuration, its visibility graph replaced by the default
# SequentialRetriever's (lookahead 15: 4,095 pairs, palace has 4,139)
HIER_CAMERAS = 281
HIER_POINTS = 800
HIER_CLUSTER_SIZE = 40
HIER_MIN_CLUSTERS = 4
# the JAX package on the CPU on the same inputs (scripts/hierarchical_reference.py):
# 281/281 registered, compare_reconstructions' pose AUC@5 0.97389
HIER_REF_REGISTERED = 281
HIER_REF_AUC5 = 0.9738916772552285
HIER_REGISTERED_SLACK = 3  # the port may register up to 3 fewer cameras
HIER_AUC5_SLACK = 0.02
HIER_MIN_REGISTERED = 0.95  # tests/scene/test_scale_synthetic.py:122-123
HIER_MEDIAN_ROT_DEG = 0.5  # test_scale_synthetic.py:128-131, after a Sim3 alignment to GT
HIER_MEDIAN_TRANS = 0.3

SPLAT_HW = (480, 640)  # the synthetic loader's default image size
SPLAT_FOCAL = 600.0  # and focal length
SPLAT_GAUSSIANS = 50_000  # GSTrainOptions.max_gaussians
SPLAT_POINTS = 12_500  # SfM points of the trainer phase: G = min(50,000, 4 * 12,500)
SPLAT_STEPS = 400  # trainer steps of the slice and the trainer phase (one densify, at 300)
SPLAT_L1_RATIO = 0.7  # the reference's trainer bar (tests/splat/test_splat.py:133)
COMPOSITE_TOL = 1e-5  # kernel vs plain where no tile stops early: float32 order only
# with the early stop: a tile stops once every pixel has T <= 1/255, and the
# skipped tail adds at most T * max(rgb) <= 1/255 to any output
COMPOSITE_TOL_STOP = 1.0 / 255.0 + 1e-5
# float32 operations per pixel and slot of the compositing function, counted
# from its plain version (splat/rendering.py composite_tiles_plain) and the
# reference's _composite_kernel (gtsfm_tpu/splat/rendering.py:420), not from
# any implementation, so the bound stays one yardstick: dx, dy 2; q 9;
# clamp 1; -q/2 1; exp 1; alpha * exp 1; min 1; cutoff select 1; w = a T 1;
# three color FMAs 6; 1 - a 1; T update 1
COMPOSITE_FLOPS = 26
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, float32
# outside them, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# calls per timed sample (_median_ms); the plain versions, at tens of ms a
# call, take one
TIMING_BATCH = 5


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


def splat_scene(center, n: int = SPLAT_GAUSSIANS, radius: float = 8.0, seed: int = 0) -> dict:
    """GSData fields (numpy float32; alive bool) of a seeded scene: n
    gaussians uniform in a ball of ``radius`` around ``center``, random
    orientations, per-axis scales 0.04-0.12, opacities from normal logits
    (about 70% mean opacity), and colors that vary smoothly with position
    (a wavelength of about 6 units per channel, plus a little noise), so a
    quarter of the means as SfM points can learn the views."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    means = np.asarray(center, np.float64) + d * radius * rng.random((n, 1)) ** (1.0 / 3.0)
    return {
        "means": means.astype(np.float32),
        "log_scales": np.log(rng.uniform(0.04, 0.12, (n, 3))).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity_logit": rng.normal(1.0, 1.0, n).astype(np.float32),
        "colors": (2.5 * np.sin((means - np.asarray(center)) @ rng.normal(0, 1.0, (3, 3)) + rng.uniform(0, 6.3, 3))
                   + rng.normal(0.0, 0.3, (n, 3))).astype(np.float32),
        "alive": np.ones(n, bool),
    }


def rotation_error_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle of Ra^T Rb per rotation, in degrees, from float64 atan2 of the
    skew part and the trace (an arccos of the trace resolves no angle below
    about 0.02 deg from float32 matrices)."""
    M = np.einsum("nji,njk->nik", np.asarray(Ra, np.float64), np.asarray(Rb, np.float64))
    v = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return np.degrees(np.arctan2(0.5 * np.linalg.norm(v, axis=-1), 0.5 * (np.trace(M, axis1=1, axis2=2) - 1.0)))


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


def _median_ms(fn, reps: int = 20, batch: int = TIMING_BATCH) -> float:
    """Device ms of one call of fn: the median over ``reps`` samples, each
    CUDA events around ``batch`` calls back to back (so the host's work
    between calls overlaps the device's), divided by ``batch``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
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


def matcher_sass(path: str, symbol: str = "fused_matcher_kernelILi8E") -> dict:
    """Instruction counts of the matcher kernel's main-path instantiation
    (D <= 128, fragments in registers) in the built library's SASS
    (cuobjdump -sass): the whole function, and its desc2 tile loop (the
    backward branch spanning the most instructions), by opcode."""
    import os
    import re

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True, check=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = symbol in line
        elif inside:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*);", line)
            if m:
                body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    if not body:
        raise AssertionError(f"no {symbol} in the SASS of {path}")
    loop = (0, 0)
    for i, (addr, op, rest) in enumerate(body):
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and target and int(target.group(1), 16) < addr:
            start = next(j for j, x in enumerate(body) if x[0] >= int(target.group(1), 16))
            if i - start > loop[1] - loop[0]:
                loop = (start, i + 1)

    def counts(ins):
        by = {}
        for _, op, _ in ins:
            key = op.split(".")[0]
            by[key] = by.get(key, 0) + 1
        return by

    return {"function": counts(body), "loop": counts(body[loop[0]:loop[1]]), "loop_len": loop[1] - loop[0]}


def _unit_rows(rng, shape):
    x = rng.normal(size=shape)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def phase_kernel(kp_mask, descs, pairs):
    """The matcher kernel against its plain version at the slice's shape
    and at the tiling's edges, then timed at the slice's shape in turns
    with the plain version, as a CUDA graph (device time alone) and by the
    host's clock (the wrapper's host time per call). Returns (worst max
    |best| error, {"kernel", "plain", "device", "wrapped", "host": ms},
    (bound ms, bound by)): "kernel" is 5 calls back to back through the
    wrapper, "device" the tile and finish kernels alone and "wrapped" the
    whole call (casts included) in a CUDA graph."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_matcher
    from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
    from gtsfm_tpu_torch.utils import cuda_build
    from gtsfm_tpu_torch.utils.numerics import precise

    sass = matcher_sass(cuda_build.library_path("fused_matcher"))
    loop = sass["loop"]
    # per desc2 tile a warp holds 32 rows x 64 columns: 64 similarities a thread
    print(f"kernel SASS (D <= 128 instantiation): {sum(sass['function'].values())} instructions, "
          f"HMMA {sass['function'].get('HMMA', 0)}, FFMA {sass['function'].get('FFMA', 0)}; desc2 tile loop "
          f"{sass['loop_len']} instructions = {sass['loop_len'] / 64:.2f} per similarity a thread, HMMA "
          f"{loop.get('HMMA', 0)}, FFMA {loop.get('FFMA', 0)}, LDSM {loop.get('LDSM', 0)}, SHFL "
          f"{loop.get('SHFL', 0)} | loop by opcode {dict(sorted(loop.items(), key=lambda kv: -kv[1]))}",
          flush=True)
    if not loop.get("HMMA") or loop.get("FFMA"):
        raise AssertionError("the matcher's tile loop must multiply with HMMA and hold no FFMA")

    dev = torch.device("cuda")
    d = torch.as_tensor(descs, device=dev)
    m = torch.as_tensor(kp_mask, device=dev)
    i1 = torch.as_tensor(pairs[:, 0], device=dev, dtype=torch.int64)
    i2 = torch.as_tensor(pairs[:, 1], device=dev, dtype=torch.int64)
    cases = {"P96_K1024": (d[i1], d[i2], m[i1], m[i2])}
    masked = torch.zeros_like(m[:1])
    cases["all_masked"] = (d[:1], d[1:2], masked, masked)
    cases["K1000"] = (d[i1[:1], :1000], d[i2[:1], :1000], m[i1[:1], :1000], m[i2[:1], :1000])
    # the tiling's edges: 128 desc1 rows per block, 64 desc2 rows per tile
    # (32 above D = 128), D = 136 zero-padded to 144, one pair
    for name, k1, k2 in (("K1_127", 127, 1024), ("K1_129", 129, 1024), ("K2_63", 1024, 63), ("K2_65", 1024, 65)):
        cases[name] = (d[i1[:4], :k1], d[i2[:4], :k2], m[i1[:4], :k1], m[i2[:4], :k2])
    rng = np.random.default_rng(0)
    w1 = _unit_rows(rng, (2, 129, 136))
    w2 = _unit_rows(rng, (2, 33, 136))
    w2[:, :16] = _unit_rows(rng, (2, 16, 136)) * 0.05 + w1[:, :16]
    cases["D136"] = tuple(torch.as_tensor(x, device=dev) for x in (
        w1.astype(np.float32), (w2 / np.linalg.norm(w2, axis=-1, keepdims=True)).astype(np.float32),
        rng.random((2, 129)) > 0.1, rng.random((2, 33)) > 0.1))
    cases["P1"] = (d[i1[:1]], d[i2[:1]], m[i1[:1]], m[i2[:1]])

    worst = 0.0
    with precise():
        for name, (a, b, ma, mb) in cases.items():
            got = fused_matcher.fused_match_descriptors(a, b, ma, mb)
            want = match_descriptors(a, b, ma, mb)
            err, n_dec, bad = kernel_agrees(got, want, a, b, ma, mb)
            # the finish kernel against its plain version on the tile
            # kernel's own outputs: exactly
            (fi, fok, fb), rest = fused_matcher.match_tiles(a.to(torch.bfloat16), b.to(torch.bfloat16), ma, mb)
            pi, pok, _ = fused_matcher._finish(fb, *rest, ma, 0.8)
            if not (torch.equal(fi, pi) and torch.equal(fok, pok)):
                raise AssertionError(f"the finish kernel disagrees with _finish on {name}")
            if name == "all_masked" and bool(got[1].any()):
                raise AssertionError("all-masked pair produced matches")
            if err > KERNEL_TOL_BEST or bad:
                raise AssertionError(f"kernel disagrees on {name}: max|best| err {err:.3g}, "
                                     f"{bad}/{n_dec} decisive rows differ")
            worst = max(worst, err)
            print(f"kernel check {name} {tuple(a.shape)} x {tuple(b.shape)}: max|best| err {err:.3g}, {n_dec} "
                  f"decisive rows agree, {int(got[1].sum())} matches", flush=True)
        a, b, ma, mb = cases["P96_K1024"]
        first = fused_matcher.fused_match_descriptors(a, b, ma, mb)
        again = fused_matcher.fused_match_descriptors(a, b, ma, mb)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError("two matcher launches on the same inputs differ")
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        # "alone": the tile and finish kernels on bf16 inputs, no casts
        calls = {"plain": lambda: match_descriptors(a, b, ma, mb),
                 "kernel": lambda: fused_matcher.fused_match_descriptors(a, b, ma, mb),
                 "alone": lambda: fused_matcher.match_tiles(ab, bb, ma, mb)}
        order = [(which, _median_ms(calls[which], batch=1 if which == "plain" else TIMING_BATCH))
                 for which in ("plain", "kernel", "kernel", "plain")]
        ms = {wh: float(np.median([t for w, t in order if w == wh])) for wh in ("plain", "kernel")}
        # device time alone: the whole call (the two casts and the kernels)
        # and the kernels by themselves on bf16 inputs
        wrapped = [_graph_ms(calls["kernel"]) for _ in range(2)]
        device = [_graph_ms(calls["alone"]) for _ in range(2)]
        ms["wrapped"] = float(np.median(wrapped))
        ms["device"] = float(np.median(device))
        # host time: 20 calls without a synchronize (about 500 launches, well
        # inside the launch queue), the median of 5 such runs
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                calls["kernel"]()
            host.append((time.perf_counter() - t0) / 20 * 1e3)
            torch.cuda.synchronize()
        ms["host"] = float(np.median(host))
    P, K1, D = a.shape
    K2 = b.shape[1]
    flop = 2.0 * P * K1 * K2 * D
    bound = max((flop / PEAK_BF16 * 1e3, "operations"),
                ((a.nbytes + b.nbytes + ma.nbytes + mb.nbytes + P * K1 * (4 + 1 + 4)) / PEAK_BYTES * 1e3, "bytes"))
    print(f"kernel timing P96_K1024 (median of 20 samples, CUDA events): {ms['kernel']:.4f} ms through the "
          f"wrapper ({TIMING_BATCH} calls back to back), plain {ms['plain']:.4f} ms, kernel / plain "
          f"{ms['kernel'] / ms['plain']:.3f} | runs {order} | device alone (a CUDA graph of {TIMING_BATCH} calls): "
          f"the tile and finish kernels {ms['device']:.4f} ms (runs {[round(x, 4) for x in device]}), the whole call "
          f"{ms['wrapped']:.4f} ms (runs {[round(x, 4) for x in wrapped]}) | host {ms['host']:.4f} ms a call (runs "
          f"{[round(x, 4) for x in host]}) | {flop / ms['device'] * 1e-9:.1f} TFLOP/s device, "
          f"{flop / ms['kernel'] * 1e-9:.1f} back to back | bound {bound[0]:.4f} ms ({bound[1]}): "
          f"{bound[0] / ms['device']:.3f} of it device, {bound[0] / ms['kernel']:.3f} back to back", flush=True)
    return worst, ms, bound


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


def attention_library(q0, q1, v0, v1, m0, m1, heads):
    """The yardstick of each attention entry, never called by the port:
    scaled_dot_product_attention with the additive -1e9 mask on split-head
    views of the same inputs, once for a self entry and once per direction
    for a cross entry. Returns {entry: call}."""
    import torch

    P, K0, C = q0.shape
    K1 = q1.shape[1]
    sp0 = [x.view(P, K0, heads, C // heads).transpose(1, 2) for x in (q0, v0)]
    sp1 = [x.view(P, K1, heads, C // heads).transpose(1, 2) for x in (q1, v1)]
    add1 = torch.where(m1, 0.0, -1e9).to(torch.bfloat16)[:, None, None, :]
    add0 = torch.where(m0, 0.0, -1e9).to(torch.bfloat16)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def one():
        return sdpa(sp0[0], sp1[0], sp1[1], attn_mask=add1)

    def two():
        return one(), sdpa(sp1[0], sp0[0], sp0[1], attn_mask=add0)

    return {"fused_attention": one, "fused_attention_merged": one,
            "fused_cross_attention": two, "fused_cross_attention_merged": two}


def phase_attention(seed: int = 0):
    """All four attention entries against their plain versions, on
    LightGlue's shape and the kernel's tiling edges, then each timed at
    LightGlue's shape in turns with its plain version and its library
    yardstick. Returns (worst max abs error, {entry: {"kernel", "plain",
    "library": ms}}, (bound ms, bound by) of the merged self entry)."""
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
        # the tiling's edges: 128 query rows per block, 128 keys per tile;
        # a cross entry also runs the swapped direction (Kq <-> Kk)
        "Kk1": make(2, 200, 1),
        "Kk129": make(2, 300, 129),
        "Kq1": make(2, 1, 300),
        "Kq129": make(2, 129, 256),
        "P2_K2048": make(2, GLUE_KEYPOINTS, GLUE_KEYPOINTS),
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
        del got, want

        q0, q1, v0, v1, m0, m1 = cases["P96_K2048"]
        P, K, C = q0.shape
        flops = 4.0 * P * heads * K * K * (C // heads)  # one direction: q.k and p.v, 2 flops per product term
        bound = max((flops / PEAK_BF16 * 1e3, "operations"), ((4 * q0.nbytes + m1.nbytes) / PEAK_BYTES * 1e3, "bytes"))
        library = attention_library(q0, q1, v0, v1, m0, m1, heads)
        ms = {}
        for entry, kern, plain, _vs in attention_entries(q0, q1, v0, v1, m0, m1, heads):
            calls = {"kernel": kern, "plain": plain, "library": library[entry]}
            order = ("kernel", "library", "plain", "plain", "library", "kernel")
            runs = [(which, _median_ms(calls[which], batch=1 if which == "plain" else TIMING_BATCH)) for which in order]
            ms[entry] = {w: float(np.median([t for k, t in runs if k == w])) for w in calls}
            n_dir = 2 if "cross" in entry else 1
            k_ms = ms[entry]["kernel"]
            print(f"attention timing P96_K2048 {entry} (median of 20 samples, CUDA events, in turns): kernel {k_ms:.4f} ms, "
                  f"plain {ms[entry]['plain']:.4f} ms, scaled_dot_product_attention x{n_dir} "
                  f"{ms[entry]['library']:.4f} ms | {n_dir * flops / k_ms / 1e9:.1f} TFLOP/s, "
                  f"{n_dir * bound[0] / k_ms:.3f} of the bound {n_dir * bound[0]:.4f} ms ({bound[1]}) | "
                  f"kernel / library {k_ms / ms[entry]['library']:.3f} | runs {runs}", flush=True)
    del cases, library
    torch.cuda.empty_cache()
    return worst, ms, bound


def splat_camera(R, t, index: int, dev):
    """Ring camera ``index`` (SE3) and the loader's default intrinsics at
    SPLAT_HW, f = SPLAT_FOCAL (3x3 K), on ``dev``."""
    import torch

    from gtsfm_tpu_torch.geometry import SE3

    h, w = SPLAT_HW
    K = torch.tensor([[SPLAT_FOCAL, 0, w / 2.0], [0, SPLAT_FOCAL, h / 2.0], [0, 0, 1]], device=dev)
    return SE3(R=torch.as_tensor(R[index], device=dev), t=torch.as_tensor(t[index], device=dev)), K


def evaluated_slots(packed, gidx, counts, origins, batch: int = 256):
    """Slots per tile that the compositing kernel must evaluate on these
    inputs: all of a tile's live slots, except that a tile stops at the
    first batch boundary where every pixel has T <= 1/255 (transmittance
    from the plain version on the slots before the boundary)."""
    import torch

    from gtsfm_tpu_torch.splat import rendering

    counts = counts.long()
    need = counts.clone()
    stopped = torch.zeros_like(counts, dtype=torch.bool)
    for b in range(batch, gidx.shape[1], batch):
        clamp = torch.clamp(counts, max=b).to(torch.int32)
        _c, T = rendering.composite_tiles_plain(*rendering._gather_attrs_f32(packed, gidx, clamp), origins,
                                                rendering.KERNEL_TILE)
        stop = ~stopped & (counts > b) & (T.max(dim=1).values <= 1.0 / 255.0)
        need = torch.where(stop, torch.full_like(need, b), need)
        stopped |= stop
    return need


def composite_bound(packed, counts_needed, n_tiles: int):
    """(bound ms, "operations" or "bytes") of the compositing at these
    inputs: COMPOSITE_FLOPS per pixel and evaluated slot over the float32
    peak, against each evaluated slot's index and 9 attributes read once,
    the (G, 9) table, each tile's count and origin read and its color and
    transmittance written once, over the memory rate."""
    slots = int(counts_needed.sum())
    ops_ms = slots * 256 * COMPOSITE_FLOPS / PEAK_F32 * 1e3
    nbytes = slots * (4 + 36) + packed.numel() * 4 + n_tiles * (12 + 256 * 16)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def composite_plain(packed, gidx, counts, origins):
    """The plain compositing of these inputs, every slot index outside
    [0, G) sent to an added all-zero row (alpha 0: no contribution), which
    is what the kernel computes for such an index."""
    import torch

    from gtsfm_tpu_torch.splat import rendering

    G = packed.shape[0]
    ext = torch.cat([packed, torch.zeros_like(packed[:1])])
    inside = (gidx >= 0) & (gidx < G)
    gidx = torch.where(inside, gidx, torch.full_like(gidx, G))
    return rendering.composite_tiles_plain(*rendering._gather_attrs_f32(ext, gidx, counts), origins,
                                           rendering.KERNEL_TILE)


def _graph_ms(fn, calls: int = TIMING_BATCH, reps: int = 20) -> float:
    """Device ms of one call of fn alone: ``calls`` calls captured in one
    CUDA graph, the median of ``reps`` replays (CUDA events) over
    ``calls``. Unlike _median_ms, no host time is in it."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def phase_composite(R, t):
    """The compositing kernel against its plain version on the splat
    scene's tiles from ring camera 0, binned by the port's render_tiled,
    and on the kernel's edges. Returns (max abs error on the full scene,
    {"kernel": ms, "plain": ms, "device": ms}, (bound ms, bound by))."""
    import torch

    from gtsfm_tpu_torch.splat import rendering
    from gtsfm_tpu_torch.splat.gs_data import GSData
    from gtsfm_tpu_torch.utils.numerics import precise

    dev = torch.device("cuda")
    h, w = SPLAT_HW
    fields = splat_scene(np.asarray(t).mean(axis=0), n=SPLAT_GAUSSIANS)
    full = GSData(**{k: torch.as_tensor(v, device=dev) for k, v in fields.items()})
    # alpha 0.004: T >= (1 - 0.004)^512 = 0.13 > 1/255, so no tile stops early
    faint = full.replace(opacity_logit=torch.full_like(full.opacity_logit, float(np.log(0.004 / 0.996))))
    pose, K = splat_camera(R, t, 0, dev)

    def plain(packed, gidx, counts, origins):
        return rendering.composite_tiles_plain(*rendering._gather_attrs_f32(packed, gidx, counts), origins,
                                               rendering.KERNEL_TILE)

    def kernel(packed, gidx, counts, origins):
        return rendering.composite_tiles(packed, gidx, counts, origins, rendering.KERNEL_TILE)

    with torch.no_grad(), precise():
        bins = {name: rendering.bin_tiles(g, pose, K, h, w) for name, g in (("faint", faint), ("full", full))}
        packed, gidx, counts, origins = bins["full"]
        p_f, gidx_f, counts_f, origins_f = bins["faint"]
        n_tiles = gidx.shape[0]
        G = packed.shape[0]
        bad = gidx_f.clone()
        bad[:, ::7] = -1
        bad[:, 3::11] = G
        cases = {
            "faint": (bins["faint"], COMPOSITE_TOL),
            "full": (bins["full"], COMPOSITE_TOL_STOP),
            "all_empty": ((packed, gidx, torch.zeros_like(counts), origins), 0.0),
            "ragged_997": (tuple(a[:997].contiguous() if a is not packed else a for a in bins["full"]),
                           COMPOSITE_TOL_STOP),
            # the stop boundary: at count 256 no tile checks (none stops
            # early), at 257 each checks once after 256 slots
            "count_256": ((packed, gidx, torch.clamp(counts, max=256), origins), COMPOSITE_TOL),
            "count_257": ((packed, gidx, torch.clamp(counts, max=257), origins), COMPOSITE_TOL_STOP),
            "out_of_range": ((p_f, bad, counts_f, origins_f), COMPOSITE_TOL),
            # cap 100: only composited_slots(100) = 64 slots are read
            "cap_100": ((p_f, gidx_f[:, :100].contiguous(), torch.clamp(counts_f, max=100), origins_f),
                        COMPOSITE_TOL),
        }
        errs = {}
        for name, (args, tol) in cases.items():
            got = kernel(*args)
            torch.cuda.synchronize()
            want = composite_plain(*args)
            err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
            stopped = int((want[1].max(dim=1).values <= 1.0 / 255.0).sum())
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            print(f"composite check {name}: {args[1].shape[0]} tiles, max abs err {err:.4g} (tolerance {tol:.4g}), "
                  f"{stopped} tiles saturated, live slots per tile median {float(args[2].float().median()):.0f} "
                  f"max {int(args[2].max())}", flush=True)
            if not finite or err > tol:
                raise AssertionError(f"composite kernel disagrees on {name}: max abs err {err:.4g} > {tol:.4g}")
            if name in ("faint", "out_of_range", "cap_100") and stopped:
                raise AssertionError(f"the {name} case saturated a tile; it must not")
            if name in ("count_256", "count_257") and not stopped:
                raise AssertionError(f"no tile of {name} saturates: the stop boundary is not exercised")
            if name == "all_empty" and not (bool((got[0] == 0).all()) and bool((got[1] == 1).all())):
                raise AssertionError("an empty tile is not black with T = 1")
            errs[name] = err
        need = evaluated_slots(packed, gidx, counts, origins)

    # the gradient: fixed upstream weights, so both sides see the same
    # cotangents; only the gather's scatter-add order (float atomics) differs
    gen = torch.Generator(device=dev).manual_seed(0)
    wc = torch.rand((n_tiles, 256, 3), generator=gen, device=dev)
    wt = torch.rand((n_tiles, 256), generator=gen, device=dev)
    grads = {}
    with precise():
        for which in ("kernel", "plain"):
            p = p_f.detach().clone().requires_grad_(True)
            if which == "kernel":
                c, T = rendering.TiledComposite.apply(p, gidx_f, counts_f, origins_f, rendering.KERNEL_TILE)
            else:
                c, T = plain(p, gidx_f, counts_f, origins_f)
            ((c * wc).sum() + (T * wt).sum()).backward()
            grads[which] = p.grad
    gerr = float((grads["kernel"] - grads["plain"]).norm() / grads["plain"].norm())
    print(f"composite gradient: |kernel path - plain path| / |plain path| {gerr:.3g} (tolerance 1e-5)", flush=True)
    if not gerr <= 1e-5:
        raise AssertionError(f"TiledComposite's gradient on the card differs from the plain path's: {gerr:.3g}")

    with torch.no_grad(), precise():
        calls = {"kernel": lambda: kernel(packed, gidx, counts, origins),
                 "plain": lambda: plain(packed, gidx, counts, origins)}
        runs = [(which, _median_ms(calls[which], batch=1 if which == "plain" else TIMING_BATCH))
                for which in ("plain", "kernel", "kernel", "plain")]
        device = [_graph_ms(calls["kernel"]) for _ in range(2)]
    ms = {wh: float(np.median([x for k, x in runs if k == wh])) for wh in ("kernel", "plain")}
    ms["device"] = float(np.median(device))
    bound = composite_bound(packed, need, n_tiles)
    print(f"composite timing {n_tiles} tiles x cap {gidx.shape[1]}, G {packed.shape[0]} (median of 20 samples, CUDA "
          f"events): kernel {ms['kernel']:.4f} ms ({TIMING_BATCH} calls back to back), {ms['device']:.4f} ms device "
          f"(a CUDA graph of {TIMING_BATCH} calls, runs {[round(x, 4) for x in device]}), plain {ms['plain']:.4f} ms "
          f"| runs {runs} | evaluated slots {int(need.sum())} of {int(counts.sum())} live | bound {bound[0]:.4f} ms "
          f"({bound[1]}): {bound[0] / ms['kernel']:.3f} of it back to back, {bound[0] / ms['device']:.3f} device",
          flush=True)
    del bins, cases, grads
    torch.cuda.empty_cache()
    return errs["full"], ms, bound


def _ring_slice(name, kp_xy, kp_mask, descs, pairs, R, t, matcher=None, options=None):
    """SceneOptimizer.run on the 32-camera ring on `cuda`, fed through the
    detector slot, with every kernel's launch count set to 0 just before
    the run and read just after. Requires 32/32 registered, pose AUC@5 >=
    AUC5_BAR and finite output. Returns ({"matcher": n, "attention": n,
    "composite": n}, stage seconds, metrics by group)."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
    from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
    from gtsfm_tpu_torch.loader.synthetic import SyntheticSceneLoader
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions
    from gtsfm_tpu_torch.splat import rendering

    dev = torch.device("cuda")
    n = NUM_CAMERAS
    poses = SE3(R=torch.as_tensor(R, device=dev), t=torch.as_tensor(t, device=dev))
    cal = Cal3Bundler.create(
        torch.full((n,), FOCAL), torch.zeros(n), torch.zeros(n),
        torch.full((n,), IMAGE_HW[1] / 2.0), torch.full((n,), IMAGE_HW[0] / 2.0), device=dev,
    )
    loader = SyntheticSceneLoader(poses, cal=cal, image_size=IMAGE_HW)
    so = SceneOptimizer(
        options or SceneOptimizerOptions(),
        retriever=FixedPairs(pairs),
        detector=FeedDetector(kp_xy, kp_mask, descs),
        matcher=matcher,
    )
    fused_matcher.launch_count = 0
    fused_attention.launch_count = 0
    rendering.launch_count = 0
    torch.cuda.synchronize()
    data, groups = so.run(loader)
    torch.cuda.synchronize()
    launches = {"matcher": fused_matcher.launch_count, "attention": fused_attention.launch_count,
                "composite": rendering.launch_count}

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
    return launches, sec, metrics


def phase_slice(kp_xy, kp_mask, descs, pairs, R, t):
    """The mutual-NN slice with the splat trainer after it (run_gs,
    SPLAT_STEPS steps on the loader's flat gray images). Returns the
    matcher's and the compositing kernel's launches during the run."""
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizerOptions

    launches, _sec, metrics = _ring_slice("slice", kp_xy, kp_mask, descs, pairs, R, t,
                                          options=SceneOptimizerOptions(run_gs=True, gs_iterations=SPLAT_STEPS))
    gs = {k: m.scalar for k, m in metrics["gaussian_splatting_metrics"].items()}
    print(f"slice splat: {gs}", flush=True)
    if launches["matcher"] <= 0:
        raise AssertionError("the slice never launched the matcher kernel")
    if launches["composite"] <= 0:
        raise AssertionError("the slice's splat trainer never launched the compositing kernel")
    if not gs["final_l1"] < gs["initial_l1"]:
        raise AssertionError(f"the slice's splat L1 did not fall: {gs}")
    return launches["matcher"], launches["composite"]


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
    launches, sec, _metrics = _ring_slice("lightglue", kp_xy, kp_mask, descs, pairs, R, t, matcher=matcher)
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
            before = fa.launch_count
            t0 = time.perf_counter()
            z[which] = matcher.log_assignment(*args)
            torch.cuda.synchronize()
            fwd_sec[which].append(time.perf_counter() - t0)
            per_forward = fa.launch_count - before if which == "kernel" else None
        finally:
            restore()
        if which == "kernel":
            fwd_launches = per_forward
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
          f"clock) kernel {fwd_sec['kernel']}, plain {fwd_sec['plain']}; {fwd_launches} attention launches "
          f"per forward", flush=True)
    if bad or int(decisive.sum()) == 0:
        raise AssertionError(f"LightGlue matches through the kernel differ from the plain attention's "
                             f"on {bad} of {int(decisive.sum())} decisive rows")
    return launches["attention"], sec, {w: float(np.median(v)) for w, v in fwd_sec.items()}


def _synthetic_run(name, n, pairs, points, options):
    """SceneOptimizer.run on `cuda` with the synthetic correspondence
    generator (``points`` points, noise 0.4 px) on an n-camera spectral ring
    over ``pairs``,
    every kernel's launch count set to 0 just before the run and read just
    after; ``pairs=None`` leaves them to the default SequentialRetriever
    (the ring is then laid over the same pairs). Returns (optimizer, data,
    metrics by group, launches, GT poses, compare_reconstructions'
    scalars)."""
    import torch

    from gtsfm_tpu_torch.evaluation.compare import compare_reconstructions
    from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
    from gtsfm_tpu_torch.frontend.synthetic import SyntheticCorrespondenceGenerator, SyntheticOptions
    from gtsfm_tpu_torch.geometry import Cal3Bundler
    from gtsfm_tpu_torch.loader.synthetic import SyntheticSceneLoader, spectral_ring_poses
    from gtsfm_tpu_torch.retriever.retrievers import RetrieverOptions, sequential_pairs
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer
    from gtsfm_tpu_torch.splat import rendering

    dev = torch.device("cuda")
    ring = pairs if pairs is not None else sequential_pairs(n, RetrieverOptions().max_frame_lookahead)
    gt = spectral_ring_poses(ring, n, device=dev)
    cal = Cal3Bundler.create(
        torch.full((n,), FOCAL), torch.zeros(n), torch.zeros(n),
        torch.full((n,), IMAGE_HW[1] / 2.0), torch.full((n,), IMAGE_HW[0] / 2.0), device=dev,
    )
    so = SceneOptimizer(options, retriever=FixedPairs(pairs) if pairs is not None else None,
                        correspondence=SyntheticCorrespondenceGenerator(
                            SyntheticOptions(num_points=points, noise_px=0.4, seed=0)))
    fused_matcher.launch_count = 0
    fused_attention.launch_count = 0
    rendering.launch_count = 0
    torch.cuda.synchronize()
    data, groups = so.run(SyntheticSceneLoader(gt, cal=cal, image_size=IMAGE_HW))
    torch.cuda.synchronize()
    launches = {"matcher": fused_matcher.launch_count, "attention": fused_attention.launch_count,
                "composite": rendering.launch_count}
    metrics = {g.name: {m.name: m for m in g.metrics} for g in groups}
    cmp = {m.name: m.scalar for m in compare_reconstructions(data, data.replace(poses=gt)).metrics
           if m.dist is None}
    pts = data.points[data.track_mask]
    if not bool(torch.isfinite(pts).all()) or not bool(torch.isfinite(data.poses.R[data.pose_mask]).all()):
        raise AssertionError(f"{name}: non-finite poses or points")
    if launches["matcher"] != 0:
        raise AssertionError(f"{name}: the direct branch launched the mutual-NN kernel ({launches})")
    return so, data, metrics, launches, gt, cmp


def _stage_sec(metrics) -> dict:
    mvo = metrics["multiview_optimizer_metrics"]
    sec = {"two_view_sec": metrics["frontend_summary"]["two_view_sec"].scalar}
    sec.update({k: mvo[k].scalar for k in ("leaf_mvo_sec", "merge_sec") if k in mvo})
    sec["backend_sec"] = mvo["backend_sec"].scalar
    sec["total_runtime_sec"] = metrics["total_summary"]["total_runtime_sec"].scalar
    return sec


def phase_gate():
    """The twin of tests/scene/test_accuracy_gate_32.py on `cuda`: the
    32-camera ring over pairs (i, i+1..3), the synthetic generator (600
    points, 0.4 px), flat. 32/32 registered and compare_reconstructions'
    pose AUC@5 >= AUC5_BAR required."""
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizerOptions

    n = NUM_CAMERAS
    _so, data, metrics, launches, _gt, cmp = _synthetic_run("gate", n, ring_pairs(n), GATE_POINTS,
                                                         SceneOptimizerOptions())
    auc5 = cmp["pose_auc_@5.0_deg"]
    vs = {k: m.scalar for k, m in metrics["verifier_summary"].items() if m.dist is None}
    print(f"gate: {data.number_images()}/{n} registered, pose AUC@5 {auc5:.4f} (bar {AUC5_BAR}), "
          f"{data.number_tracks()} tracks, verifier {vs}, launches {launches} | "
          + " ".join(f"{k} {v:.3f}" for k, v in _stage_sec(metrics).items()), flush=True)
    if data.number_images() != n:
        raise AssertionError(f"gate: registered {data.number_images()}/{n} cameras")
    if auc5 < AUC5_BAR:
        raise AssertionError(f"gate: pose AUC@5 {auc5:.4f} < {AUC5_BAR}")


def phase_hierarchical(smi: str, n: int = HIER_CAMERAS):
    """bench.py's palace-281 configuration through the port on `cuda`: n
    cameras, pairs from the default SequentialRetriever, the synthetic
    generator (800 points, 0.4 px), SceneOptimizerOptions(hierarchical=True,
    max_cluster_size=40), run cold and then warm in this process. Each run
    requires the METIS partitioner, >= HIER_MIN_CLUSTERS clusters, no merge
    failure, no matcher launch, registered >= max(0.95 n, the JAX
    reference's - 3), AUC@5 >= the reference's - 0.02, and after a Sim3
    alignment to GT median rotation error < 0.5 deg and median translation
    error < 0.3. Prints the cluster tree and the stage seconds."""
    import torch

    from gtsfm_tpu_torch.geometry.sim3 import align_poses_sim3
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizerOptions
    from gtsfm_tpu_torch.utils.numerics import precise

    opts = SceneOptimizerOptions(hierarchical=True, max_cluster_size=HIER_CLUSTER_SIZE)
    min_registered = max(int(np.ceil(HIER_MIN_REGISTERED * n)), HIER_REF_REGISTERED - HIER_REGISTERED_SLACK
                         if n == HIER_CAMERAS else 0)
    min_auc5 = HIER_REF_AUC5 - HIER_AUC5_SLACK
    for run in ("cold", "warm"):
        so, data, metrics, launches, gt, cmp = _synthetic_run("hierarchical", n, None, HIER_POINTS, opts)
        hm = so.backend_metrics
        paths = [p for p, _ in so.node_results]
        tree = " ".join(f"{'/'.join(map(str, p)) or 'root'}:{d.number_images()}"
                        + ("" if any(q[: len(p)] == p and len(q) > len(p) for q in paths) else "*")
                        for p, d in so.node_results)
        est = data.pose_mask
        with precise():
            sim = align_poses_sim3(data.poses, gt, mask=est)
            aligned = sim.transform_pose(data.poses)
            rot = rotation_error_deg(aligned.R[est].cpu().numpy(), gt.R[est].cpu().numpy())
            trans = torch.linalg.vector_norm(aligned.t - gt.t, dim=-1)[est].cpu().numpy()
        registered = data.number_images()
        auc5 = cmp["pose_auc_@5.0_deg"]
        pairs = int(metrics["frontend_summary"]["num_pairs"].scalar)
        print(f"hierarchical {run}: {n} cameras, {pairs} pairs, partitioner {hm.get('partitioner')}, "
              f"{hm['num_clusters']} clusters, {hm['tree_nodes']} nodes, merge failures "
              f"{hm.get('merge_failures', 0)} {hm.get('merge_failure_reasons', [])}; registered {registered} "
              f"(bar {min_registered}), pose AUC@5 {auc5:.4f} (bar {min_auc5:.4f}), median rotation error "
              f"{float(np.median(rot)):.4f} deg, median translation error {float(np.median(trans)):.4f}, "
              f"{data.number_tracks()} tracks, launches {launches}", flush=True)
        print(f"hierarchical {run} tree (path:cameras, * = leaf): {tree}", flush=True)
        print(f"hierarchical {run} seconds: " + " ".join(f"{k} {v:.3f}" for k, v in _stage_sec(metrics).items())
              + f" | {smi}", flush=True)
        leaf_sec = {}
        for cm in hm["cluster_metrics"]:
            for k, v in cm.items():
                if k.endswith("_sec") and k != "total_sec":
                    leaf_sec[k] = leaf_sec.get(k, 0.0) + v
        print(f"hierarchical {run} leaf stages, summed over the {len(hm['cluster_metrics'])} leaves: "
              + " ".join(f"{k} {v:.3f}" for k, v in leaf_sec.items()), flush=True)
        if hm.get("partitioner") != "metis":
            raise AssertionError(f"hierarchical: the partitioner was {hm.get('partitioner')!r}, not METIS")
        if hm["num_clusters"] < HIER_MIN_CLUSTERS or hm.get("merge_failures"):
            raise AssertionError(f"hierarchical: {hm['num_clusters']} clusters, merge failures "
                                 f"{hm.get('merge_failure_reasons')}")
        if registered < min_registered or auc5 < min_auc5:
            raise AssertionError(f"hierarchical: registered {registered} (bar {min_registered}), "
                                 f"AUC@5 {auc5:.4f} (bar {min_auc5:.4f})")
        if not (np.median(rot) < HIER_MEDIAN_ROT_DEG and np.median(trans) < HIER_MEDIAN_TRANS):
            raise AssertionError(f"hierarchical: median errors {np.median(rot):.4f} deg, {np.median(trans):.4f}")


def splat_trainer_inputs(R, t):
    """The full-width trainer's inputs: the splat scene's views from every
    ring camera (R, t) at SPLAT_HW, rendered by the port, and an SfmData of
    the ring poses, f = SPLAT_FOCAL, and SPLAT_POINTS of the scene's means
    plus seeded noise as points. Returns (SfmData, views (n, H, W, 3))."""
    import torch

    from gtsfm_tpu_torch.common.sfm_data import SfmData
    from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
    from gtsfm_tpu_torch.splat import rendering
    from gtsfm_tpu_torch.splat.gs_data import GSData

    dev = torch.device("cuda")
    h, w = SPLAT_HW
    n = len(t)
    fields = splat_scene(np.asarray(t).mean(axis=0), n=SPLAT_GAUSSIANS)
    scene = GSData(**{k: torch.as_tensor(v, device=dev) for k, v in fields.items()})
    with torch.no_grad():
        views = np.stack([rendering.render_tiled(scene, *splat_camera(R, t, i, dev), h, w)[0].cpu().numpy()
                          for i in range(n)])
    rng = np.random.default_rng(1)
    pts = fields["means"][:SPLAT_POINTS] + rng.normal(0, 0.05, (SPLAT_POINTS, 3)).astype(np.float32)
    z = torch.zeros(n)
    data = SfmData(
        poses=SE3(R=torch.as_tensor(R, device=dev), t=torch.as_tensor(t, device=dev)),
        cal=Cal3Bundler.create(torch.full((n,), SPLAT_FOCAL), z, z, torch.full((n,), w / 2.0),
                               torch.full((n,), h / 2.0), device=dev),
        pose_mask=torch.ones(n, dtype=torch.bool, device=dev),
        points=torch.as_tensor(pts, device=dev),
        track_mask=torch.ones(SPLAT_POINTS, dtype=torch.bool, device=dev),
        meas_cam=torch.zeros(1, dtype=torch.int64, device=dev),
        meas_track=torch.zeros(1, dtype=torch.int64, device=dev),
        meas_uv=torch.zeros((1, 2), device=dev),
        meas_mask=torch.zeros(1, dtype=torch.bool, device=dev),
    )
    return data, views


def phase_splat(R, t):
    """GaussianSplatting.train at full width: SPLAT_GAUSSIANS slots at
    SPLAT_HW for SPLAT_STEPS steps on splat_trainer_inputs. Returns
    compositing launches during the training."""
    import torch

    from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
    from gtsfm_tpu_torch.splat import rendering
    from gtsfm_tpu_torch.splat.gaussian_splatting import GaussianSplatting, GSTrainOptions

    dev = torch.device("cuda")
    h, w = SPLAT_HW
    data, views = splat_trainer_inputs(R, t)
    trainer = GaussianSplatting(GSTrainOptions(iterations=SPLAT_STEPS))
    fused_matcher.launch_count = fused_attention.launch_count = rendering.launch_count = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gs, metrics = trainer.train(data, views)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = rendering.launch_count
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        counts = rendering.bin_tiles(gs, *splat_camera(R, t, 0, dev), h, w)[2].float()
    print(f"splat: {gs.max_gaussians} slots at {h}x{w}, {SPLAT_STEPS} steps in {sec:.3f} s "
          f"({sec / SPLAT_STEPS:.4f} s/step, host clock), peak device memory {peak / 2**30:.3f} GiB, {launches} "
          f"composite launches | {metrics} | live slots per tile of the trained splats from camera 0: median "
          f"{float(counts.median()):.0f}, mean {float(counts.mean()):.1f}, max {int(counts.max())}", flush=True)
    if launches < SPLAT_STEPS:
        raise AssertionError(f"the trainer launched the compositing kernel {launches} times in {SPLAT_STEPS} steps")
    if not metrics["final_l1"] < SPLAT_L1_RATIO * metrics["initial_l1"]:
        raise AssertionError(f"the trainer's L1 did not fall below {SPLAT_L1_RATIO} of the initial: {metrics}")
    if not bool(torch.isfinite(gs.means).all()):
        raise AssertionError("the trained splats are not finite")
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

    err, ms, bound = phase_kernel(kp_mask, descs, pairs)
    attn_err, attn_ms, attn_bound = phase_attention()
    comp_err, comp_ms, comp_bound = phase_composite(R, t)
    launches, slice_comp_launches = phase_slice(kp_xy, kp_mask, descs, pairs, R, t)
    attn_launches, _sec, fwd = phase_lightglue(pairs, R, t)
    # the forward's 36 launches: per layer two self entries and one cross
    # entry (two launches), each at the timed P96_K2048 shape
    from gtsfm_tpu_torch.frontend.matchers.lightglue import LightGlueOptions

    layers = LightGlueOptions().num_layers
    attn_fwd_ms = layers * (2 * attn_ms["fused_attention_merged"]["kernel"]
                            + attn_ms["fused_cross_attention_merged"]["kernel"])
    print(f"lightglue forward: {fwd['kernel'] * 1e3:.3f} ms warm (host clock), of which the attention kernel "
          f"{attn_fwd_ms:.3f} ms ({layers} layers x (2 self + 1 cross entry) at the timed medians), "
          f"{attn_fwd_ms / (fwd['kernel'] * 1e3):.3f} of the forward", flush=True)
    phase_gate()
    phase_hierarchical(smi)
    comp_launches = phase_splat(R, t)

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
        "device_ms": ms["device"],
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
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
        "bound_ms": attn_bound[0],
        "bound_by": attn_bound[1],
        "library_ms": attn_ms["fused_attention_merged"]["library"],
    }, {
        "name": "splat_composite",
        "route": "cuda",
        "source": "gtsfm_tpu_torch/csrc/splat_composite.cu",
        "replaces": "gtsfm_tpu/splat/rendering.py:420",
        "launches": comp_launches,
        "slice_launches": slice_comp_launches,
        "max_abs_err": comp_err,
        "ms": comp_ms["kernel"],
        "plain_ms": comp_ms["plain"],
        "device_ms": comp_ms["device"],
        "bound_ms": comp_bound[0],
        "bound_by": comp_bound[1],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
