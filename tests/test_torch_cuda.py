"""The port on a CUDA card: the fused matcher, attention and splat
compositing kernels against their plain PyTorch versions, the splat
trainer, the back end's run-to-run reproducibility, and the card against
the CPU on the synthetic direct branch (equal index outputs, no matcher
launch), on the merge's compacted BA (``run_compact``) and on DoG-SIFT
(its stable top-k, and the keypoints of a padded batch); the three BA
layouts against each other and the CPU, the dense layout's fallback to
entry past 128 views, and Cal3DS2's calibrate against the CPU; the
two-view checks (the batched homography RANSAC on draws made on the card,
LMedS votes, the information spectrum) on the card against the CPU; the
deep front end's nets (SuperPoint, D2-Net, DISK, NetVLAD, hloc NetVLAD,
MegaLoc, on their seeded inits) on the card against the CPU, with
chip_smoke's DEEP_KEYPOINT_SHARE and DEEP_DESC_TOL, and RANSAC on a
one-match pair (NaN hypotheses) without a raise.

These tests need a CUDA card (marker ``cuda``) and skip elsewhere. The
file imports no JAX, so it also runs on a card's machine without it; there
run it without tests/conftest.py, which sets JAX up for the reference tests:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Matcher shapes cover the runner's (64, 2048, 128) and what the kernel takes
beyond the slice's (P, 1024, 128):
ragged K1 != K2, narrow and wide D, a single keypoint, an all-masked pair,
exact ties, one pair, and the tiling's edges (K1 one below and one above
the 128-row block, K2 one below and one above the 64-row desc2 tile, D =
136, which is not a multiple of 16); two launches on the same inputs must
be bitwise equal (no atomics). Tolerances: ``best``
1e-5 everywhere; ``idx`` / ``ok`` exact on every row whose best and
second-best similarities differ by more than 1e-4 (float32 sums of exact
bf16 products in another order can swap nearer ties).

Attention shapes cover what the kernel takes beyond LightGlue's
(96, 2048, 4 heads of 64): ragged K0 != K1, one pair, narrow (16, 32) and
wide (128) head dims, a fully masked key set, and the tiling's edges (one
key, one past a 128-key tile, one query, one past the 128-row block, two
pairs at K = 2048), through all four entries. Tolerance: chip_smoke's
``attention_agrees`` (ATTN_TOL_V * max|v| + ATTN_TOL_OUT * |want|, the two
bf16 roundings the kernel and the plain version place differently).

Compositing cases cover caps 64 and 512 with ragged counts, empty tiles, a
saturating tile (early stop), a single tile, and the kernel's edges: counts
256 and 257 on saturating tiles (the stop boundary), indices -1 and G, cap
100 (only 64 slots composited) and 133 tiles. Tolerance: 1e-5 where no
tile stops early (float32 order only), 1/255 + 1e-5 where one does (the
skipped tail's bound), chip_smoke's COMPOSITE_TOL and COMPOSITE_TOL_STOP.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    COMPOSITE_TOL,
    COMPOSITE_TOL_STOP,
    DEEP_DESC_TOL,
    DEEP_KEYPOINT_SHARE,
    KERNEL_TOL_BEST,
    attention_agrees,
    attention_entries,
    composite_plain,
    kernel_agrees,
    keypoints_agree,
)
from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
from gtsfm_tpu_torch.splat import rendering
from gtsfm_tpu_torch.utils.numerics import precise
# by its own name (pytest puts tests/ on the path): on a card's machine a
# ``tests`` package in site-packages can shadow this directory
from torch_threads import cap_threads

cap_threads()

# name: (P, K1, K2, D, seed)
SHAPES = {
    "square": (4, 256, 256, 128, 4),
    "ragged": (3, 1000, 777, 128, 2),
    "narrow": (2, 70, 130, 24, 1),
    "wide": (2, 128, 192, 512, 6),
    "single": (2, 1, 1, 8, 3),
    "all_masked": (2, 64, 64, 128, 0),
    "ties": (2, 256, 256, 128, 5),
    # the tiling's edges: 128 desc1 rows per block (fused_matcher.TILE),
    # 64 desc2 rows per tile (32 above D = 128), D = 136 zero-padded to 144
    "rows127": (2, 127, 200, 128, 7),
    "rows129": (2, 129, 200, 128, 8),
    "cols63": (2, 200, 63, 128, 9),
    "cols65": (2, 200, 65, 128, 10),
    "d136": (2, 129, 33, 136, 11),
    "one_pair": (1, 300, 300, 128, 12),
    # the unified config's two-view chunk: pair_batch_size 64, max_keypoints 2048
    "runner_p64_k2048": (64, 2048, 2048, 128, 13),
}


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(case: str):
    P, K1, K2, D, seed = SHAPES[case]
    rng = np.random.default_rng(seed)
    d1 = _unit(rng.normal(size=(P, K1, D)))
    n_true = min(K1, K2) // 2
    d2 = _unit(rng.normal(size=(P, K2, D)))
    d2[:, :n_true] = _unit(d1[:, :n_true] + 0.05 * rng.normal(size=(P, n_true, D)))
    for p in range(P):
        d2[p] = d2[p][rng.permutation(K2)]
    m1 = rng.random((P, K1)) > 0.1
    m2 = rng.random((P, K2)) > 0.1
    if case == "single":
        m1[:] = True
        m2[:] = True
    elif case == "all_masked":
        m1[1] = False
    elif case == "ties":
        d1[:, 11] = d1[:, 10]
        d2[:, 21] = d2[:, 20]
    return tuple(torch.as_tensor(a, device="cuda") for a in (
        d1.astype(np.float32), d2.astype(np.float32), m1, m2))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    d1, d2, m1, m2 = _inputs(case)
    before = fused_matcher.launch_count
    with precise():
        got = fused_matcher.fused_match_descriptors(d1, d2, m1, m2)
        want = match_descriptors(d1, d2, m1, m2)
    assert fused_matcher.launch_count == before + 1
    # the finish kernel equals its plain version on the tile kernel's outputs
    (fi, fok, fb), rest = fused_matcher.match_tiles(d1.to(torch.bfloat16), d2.to(torch.bfloat16), m1, m2)
    pi, pok, _ = fused_matcher._finish(fb, *rest, m1, 0.8)
    assert torch.equal(fi, pi) and torch.equal(fok, pok)
    gi, gok, gb = got
    assert gi.dtype == torch.int32 and gok.dtype == torch.bool and gb.dtype == torch.float32
    err, n_decisive, n_differ = kernel_agrees(got, want, d1, d2, m1, m2)
    assert err <= KERNEL_TOL_BEST
    assert n_decisive > 0
    assert n_differ == 0
    if case == "all_masked":
        assert not bool(gok[1].any())
    if case == "ties":
        # row 11 duplicates row 10: it never wins the column they tie on
        assert not bool((gok[:, 11] & (gi[:, 11] == gi[:, 10]) & gok[:, 10]).any())
        # columns 20 and 21 are equal: a row whose best is one of them has
        # an equal second best, so the ratio test rejects it
        assert not bool((gok & ((gi == 20) | (gi == 21))).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "ties", "d136", "runner_p64_k2048"])
def test_kernel_is_bitwise_repeatable(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    d1, d2, m1, m2 = _inputs(case)
    first = fused_matcher.fused_match_descriptors(d1, d2, m1, m2)
    again = fused_matcher.fused_match_descriptors(d1, d2, m1, m2)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d1, d2, m1, m2 = _inputs("square")
    with pytest.raises(ValueError):
        fused_matcher.fused_match_descriptors(d1[..., :100], d2[..., :100], m1, m2)
    with pytest.raises(ValueError):
        fused_matcher.fused_match_descriptors(d1, d2.cpu(), m1, m2)


# name: (P, K0, K1, heads, dh)
ATTN_SHAPES = {
    "ragged": (3, 1000, 777, 4, 64),
    "one_pair": (1, 130, 70, 4, 64),
    "narrow16": (2, 200, 96, 2, 16),
    "narrow32": (2, 96, 200, 8, 32),
    "wide128": (2, 300, 257, 2, 128),
    "all_masked": (2, 128, 128, 4, 64),
    # the kernel's tiling edges (128 query rows per block, 128 keys per
    # tile at dh 64); a cross entry also runs the swapped direction
    "keys1": (2, 200, 1, 4, 64),
    "keys129": (2, 300, 129, 4, 64),
    "queries1": (2, 1, 300, 4, 64),
    "queries129": (2, 129, 256, 4, 64),
    "p2_k2048": (2, 2048, 2048, 4, 64),
}
ATTN_ENTRIES = ["fused_attention", "fused_attention_merged", "fused_cross_attention",
                "fused_cross_attention_merged"]


def _attention_inputs(case: str):
    P, K0, K1, heads, dh = ATTN_SHAPES[case]
    rng = np.random.default_rng(sorted(ATTN_SHAPES).index(case))

    def x(K):
        return torch.as_tensor(rng.normal(size=(P, K, heads * dh)).astype(np.float32),
                               device="cuda").to(torch.bfloat16)

    m0 = torch.as_tensor(rng.random((P, K0)) > 0.2, device="cuda")
    m1 = torch.as_tensor(rng.random((P, K1)) > 0.2, device="cuda")
    if case == "all_masked":
        m0[:] = False
        m1[:] = False
    return (x(K0), x(K1), x(K0), x(K1), m0, m1), heads


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ATTN_ENTRIES)
@pytest.mark.parametrize("case", sorted(ATTN_SHAPES))
def test_attention_kernel_matches_plain_version(case, entry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    (q0, q1, v0, v1, m0, m1), heads = _attention_inputs(case)
    name, kern, plain, vs = next(e for e in attention_entries(q0, q1, v0, v1, m0, m1, heads) if e[0] == entry)
    before = fused_attention.launch_count
    with precise():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
    assert fused_attention.launch_count == before + len(got)  # one launch per direction
    for g, w, v in zip(got, want, vs):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err, ratio, finite = attention_agrees(g, w, v)
        assert finite and ratio <= 1.0, (err, ratio)
    if case == "all_masked":  # the -1e9 fill: every row is the mean of v
        o = got[0] if got[0].dim() == 3 else fused_attention.merge_heads(got[0])
        assert attention_agrees(o, v1.float().mean(dim=1, keepdim=True).expand(o.shape), v1)[1] <= 1.0


@pytest.mark.cuda
def test_attention_wrapper_raises_on_what_the_kernel_does_not_take_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (q0, q1, v0, v1, m0, m1), heads = _attention_inputs("one_pair")
    with pytest.raises(TypeError):  # float32 on the card: no silent plain version
        fused_attention.fused_attention_merged(q0.float(), q1.float(), v1.float(), heads, m1)
    with pytest.raises(ValueError):  # head dim 48
        fused_attention.fused_attention_merged(q0[..., :192], q1[..., :192], v1[..., :192], heads, m1)
    with pytest.raises(ValueError):
        fused_attention.fused_attention_merged(q0, q1, v1, heads, m1.cpu())


@pytest.mark.cuda
def test_averaging_is_bitwise_reproducible_on_the_card():
    """Rotation and translation averaging of a noisy 32-camera ring, twice
    each on the card: the results are bit for bit the same (the normal
    matrices are assembled without float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.averaging.rotation.averaging import RotationAveraging
    from gtsfm_tpu_torch.averaging.translation.averaging import TranslationAveraging
    from gtsfm_tpu_torch.geometry import so3
    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses

    n = 32
    edges = np.asarray(sorted({(min(i, (i + k) % n), max(i, (i + k) % n))
                               for i in range(n) for k in (1, 2, 3)}), np.int64)
    gt = spectral_ring_poses(edges, n)
    R, t = gt.R.numpy().astype(np.float64), gt.t.numpy().astype(np.float64)
    rng = np.random.default_rng(0)
    rel = np.einsum("eji,ejk->eik", R[edges[:, 1]], R[edges[:, 0]])
    noise = so3.expmap(torch.as_tensor(rng.normal(0, np.radians(1.0), (len(edges), 3)), dtype=torch.float32))
    i2Ri1 = torch.as_tensor(np.einsum("eij,ejk->eik", noise.numpy(), rel), dtype=torch.float32, device="cuda")
    d = np.einsum("eji,ej->ei", R[edges[:, 1]], t[edges[:, 0]] - t[edges[:, 1]]) + rng.normal(0, 0.05, (len(edges), 3))
    i2Ui1 = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32, device="cuda")
    inliers = rng.integers(50, 200, len(edges))

    wRi = [RotationAveraging().run(n, edges, i2Ri1, num_inliers=inliers)[0] for _ in range(2)]
    assert torch.equal(wRi[0], wRi[1])
    wti = [TranslationAveraging().run(n, edges, i2Ui1, wRi[0])[0] for _ in range(2)]
    assert torch.equal(wti[0], wti[1])
    assert bool(torch.isfinite(wti[0]).all())


# name: (n_tiles, cap, seed)
COMPOSITE_SHAPES = {
    "cap64": (37, 64, 1), "cap512": (23, 512, 0), "saturating": (5, 512, 3), "one_tile": (1, 512, 2),
    # the early stop's edge: saturating tiles with counts 256 (no check after
    # the first batch) and 257 (one check, the 257th slot skipped)
    "stop_edge": (6, 512, 4),
    # indices -1 and G among the live slots: they contribute nothing
    "out_of_range": (9, 512, 5),
    # a cap that is not a multiple of 64: only composited_slots(100) = 64 read
    "cap100": (11, 100, 6),
    # more tiles than the card has SMs, an odd count
    "ragged_133": (133, 128, 7),
}
SATURATING = ("saturating", "stop_edge")


def _composite_card_inputs(case: str):
    """Seeded (packed, gidx, counts, origins) on the card: gaussians spread
    over a 4x4-tile area, ragged counts including empty and full tiles. In
    "saturating" tile 0's first 300 slots are opaque gaussians at its centre
    with a wide footprint, so it (and the tiles that draw them too) stops
    early. In "stop_edge" tiles 0 and 1 (one origin) draw those gaussians
    in their first 256 slots, with counts 256 and 257. In "out_of_range"
    every 7th slot holds -1 and every 11th (from the 4th) G."""
    n_tiles, cap, seed = COMPOSITE_SHAPES[case]
    rng = np.random.default_rng(seed)
    G = 700
    packed = np.stack([
        rng.uniform(0, 64, G), rng.uniform(0, 64, G), rng.uniform(0, 0.9, G),
        rng.uniform(0, 1, G), rng.uniform(0, 1, G), rng.uniform(0, 1, G),
        rng.uniform(0.005, 0.3, G), rng.uniform(-0.004, 0.004, G), rng.uniform(0.005, 0.3, G),
    ], axis=-1).astype(np.float32)
    gidx = rng.integers(0, G, (n_tiles, cap)).astype(np.int32)
    counts = rng.integers(0, cap + 1, n_tiles).astype(np.int32)
    if n_tiles > 2:
        counts[0], counts[1] = 0, cap
    org = (rng.integers(0, 4, (n_tiles, 2)) * 16).astype(np.int32)
    if case == "saturating":
        packed[:300, 0:2] = org[0] + 8.0
        packed[:300, 2] = 0.99
        packed[:300, 6], packed[:300, 7], packed[:300, 8] = 1e-3, 0.0, 1e-3
        gidx[0, :300] = np.arange(300)
        counts[0] = cap
    elif case == "stop_edge":
        org[1] = org[0]
        packed[:256, 0:2] = org[0] + 8.0
        packed[:256, 2] = 0.99
        packed[:256, 6], packed[:256, 7], packed[:256, 8] = 1e-3, 0.0, 1e-3
        gidx[0:2, :256] = np.arange(256)
        counts[0], counts[1] = 256, 257
    elif case == "out_of_range":
        gidx[:, ::7] = -1
        gidx[:, 3::11] = G
    return tuple(torch.as_tensor(a, device="cuda") for a in (packed, gidx, counts, org))


def _plain_composite(packed, gidx, counts, org):
    return rendering.composite_tiles_plain(*rendering._gather_attrs_f32(packed, gidx, counts), org, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(COMPOSITE_SHAPES))
def test_composite_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _composite_card_inputs(case)
    before = rendering.launch_count
    with precise():
        got = rendering.composite_tiles(*args, 16)
        torch.cuda.synchronize()
        want = composite_plain(*args)
    assert rendering.launch_count == before + 1
    saturated = int((want[1].max(dim=1).values <= 1.0 / 255.0).sum())
    assert (saturated > 0) == (case in SATURATING)
    if case == "stop_edge":
        assert bool((want[1][:2].max(dim=1).values <= 1.0 / 255.0).all())
    tol = COMPOSITE_TOL_STOP if saturated else COMPOSITE_TOL
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= tol
    empty = args[2] == 0
    assert bool((got[0][empty] == 0).all()) and bool((got[1][empty] == 1).all())


@pytest.mark.cuda
def test_tiled_composite_gradient_on_the_card_equals_the_plain_path():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    packed, gidx, counts, org = _composite_card_inputs("cap64")
    gen = torch.Generator(device="cuda").manual_seed(0)
    wc = torch.rand((gidx.shape[0], 256, 3), generator=gen, device="cuda")
    wt = torch.rand((gidx.shape[0], 256), generator=gen, device="cuda")
    grads = []
    with precise():
        for fn in (lambda p: rendering.TiledComposite.apply(p, gidx, counts, org, 16),
                   lambda p: _plain_composite(p, gidx, counts, org)):
            p = packed.clone().requires_grad_(True)
            c, T = fn(p)
            ((c * wc).sum() + (T * wt).sum()).backward()
            grads.append(p.grad)
    # same cotangents; only the gather's float-atomic scatter order differs
    assert float((grads[0] - grads[1]).norm()) <= 1e-5 * float(grads[1].norm())


@pytest.mark.cuda
def test_composite_wrapper_raises_on_what_the_kernel_does_not_take_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    packed, gidx, counts, org = _composite_card_inputs("cap64")
    with pytest.raises(ValueError):  # the kernel composites 16x16 tiles only
        rendering.composite_tiles(packed, gidx, counts, org, 8)
    with pytest.raises(ValueError):
        rendering.composite_tiles(packed, gidx, counts.cpu(), org, 16)
    with pytest.raises(TypeError):
        rendering.composite_tiles(packed, gidx.long(), counts, org, 16)


@pytest.mark.cuda
def test_splat_trainer_lowers_l1_on_the_card():
    """20 steps of GaussianSplatting.train on the card, on three views of a
    three-gaussian scene rendered by the port: the L1 of the trained splats
    over the three views is below the initial splats'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.common.sfm_data import SfmData
    from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler
    from gtsfm_tpu_torch.splat.gaussian_splatting import GaussianSplatting, GSTrainOptions
    from gtsfm_tpu_torch.splat.gs_data import GSData

    dev = torch.device("cuda")
    H = W = 48
    f, n = 60.0, 3
    pts = np.asarray([[0, 0, 4], [0.7, 0.3, 4.5], [-0.6, -0.2, 3.5]], np.float32)
    cols = np.zeros((4, 3), np.float32)
    cols[0], cols[1], cols[2] = [4, -4, -4], [-4, 4, -4], [-4, -4, 4]
    scene = GSData.from_points(pts, max_gaussians=4, device=dev).replace(
        colors=torch.as_tensor(cols, device=dev), log_scales=torch.full((4, 3), float(np.log(0.3)), device=dev),
        opacity_logit=torch.full((4,), 3.0, device=dev))
    poses = SE3(R=torch.eye(3, device=dev).expand(n, 3, 3).contiguous(),
                t=torch.tensor([[0, 0, 0], [0.4, 0, 0], [-0.4, 0.1, 0]], device=dev))
    z = torch.zeros(n)
    cal = Cal3Bundler.create(torch.full((n,), f), z, z, torch.full((n,), W / 2), torch.full((n,), H / 2), device=dev)
    Ks = cal.K()
    with torch.no_grad():
        views = torch.stack([rendering.render_tiled(scene, poses[i], Ks[i], H, W)[0] for i in range(n)])
    data = SfmData(poses=poses, cal=cal, pose_mask=torch.ones(n, dtype=torch.bool, device=dev),
                   points=torch.as_tensor(pts, device=dev), track_mask=torch.ones(3, dtype=torch.bool, device=dev),
                   meas_cam=torch.zeros(1, dtype=torch.int64, device=dev),
                   meas_track=torch.zeros(1, dtype=torch.int64, device=dev),
                   meas_uv=torch.zeros((1, 2), device=dev), meas_mask=torch.zeros(1, dtype=torch.bool, device=dev))

    def l1(gs):
        with torch.no_grad():
            return float(np.mean([float((rendering.render_tiled(gs, poses[i], Ks[i], H, W)[0] - views[i]).abs().mean())
                                  for i in range(n)]))

    before = rendering.launch_count
    gs, metrics = GaussianSplatting(GSTrainOptions(iterations=20, densify_every=1000)).train(data, views.cpu().numpy())
    assert rendering.launch_count - before >= 20
    assert l1(gs) < l1(GSData.from_points(pts, max_gaussians=256, device=dev))
    assert bool(torch.isfinite(gs.means).all()) and metrics["num_gaussians"] == 3


def _ring_scene(n):
    from gtsfm_tpu_torch.geometry import Cal3Bundler
    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses

    edges = np.asarray(sorted({(min(i, (i + k) % n), max(i, (i + k) % n))
                               for i in range(n) for k in (1, 2, 3)}), np.int64)
    gt = spectral_ring_poses(edges, n)
    cal = Cal3Bundler.create(torch.full((n,), 300.0), torch.zeros(n), torch.zeros(n),
                             torch.full((n,), 160.0), torch.full((n,), 120.0))
    return edges, gt, cal


@pytest.mark.cuda
def test_direct_branch_on_the_card_gives_the_cpu_runs_index_outputs():
    """The synthetic generator and the two-view batch on its precomputed
    matches, on the card and on the CPU: equal index outputs, and no launch
    of the mutual-NN matcher kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.frontend.synthetic import SyntheticCorrespondenceGenerator, SyntheticOptions
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions

    n = 32
    edges, gt, cal = _ring_scene(n)
    gen = SyntheticCorrespondenceGenerator(SyntheticOptions(num_points=600, noise_px=0.4, outlier_fraction=0.1))
    runs = {}
    for dev in ("cpu", "cuda"):
        syn = gen.generate(gt.map(lambda a: a.to(dev)), cal.map(lambda a: a.to(dev)), edges, [(320, 240)] * n)
        so = SceneOptimizer(SceneOptimizerOptions(device=dev), correspondence=gen)
        fused_matcher.launch_count = 0
        tvr = so._run_two_view(edges, syn["keypoints_xy"], syn["kp_mask"],
                               np.zeros((n, 600, 4), np.float32), cal.map(lambda a: a.to(dev)), (320, 240),
                               (syn["corr_i1"], syn["corr_i2"], syn["corr_mask"]))
        assert fused_matcher.launch_count == 0
        runs[dev] = syn, {k: getattr(tvr, k).cpu().numpy() for k in ("corr_i1", "corr_i2", "num_matches")}
    (syn_c, tv_c), (syn_g, tv_g) = runs["cpu"], runs["cuda"]
    for k in ("corr_i1", "corr_i2", "corr_mask", "kp_mask", "valid", "num_inliers"):
        np.testing.assert_array_equal(syn_g[k], syn_c[k], err_msg=k)
    vis = syn_c["kp_mask"]
    np.testing.assert_allclose(syn_g["keypoints_xy"][vis], syn_c["keypoints_xy"][vis], atol=1e-3)
    for k in tv_c:
        np.testing.assert_array_equal(tv_g[k], tv_c[k], err_msg=k)


@pytest.mark.cuda
def test_run_compact_on_the_card_agrees_with_the_cpu():
    """BundleAdjustment.run_compact on a scene whose cameras and tracks are
    half dead, on the card and on the CPU: rotations within 1e-4 rad,
    centers within 1e-4 x the scene's scale (the dense BA's parity
    tolerance). Two fixed cameras fix the gauge, scale included, so the
    minimum is unique."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment
    from gtsfm_tpu_torch.common.sfm_data import SfmData
    from gtsfm_tpu_torch.geometry import SE3, so3

    n, Tn = 24, 400
    _, gt, cal = _ring_scene(n)
    rng = np.random.default_rng(0)
    R, t = gt.R.numpy(), gt.t.numpy()
    X = rng.uniform(-4, 4, (Tn, 3))
    cams = rng.integers(0, n // 2, (Tn, 4))  # only the first half of the cameras is measured
    pc = np.einsum("tkji,tkj->tki", R[cams], X[:, None] - t[cams])
    uv = 300.0 * pc[..., :2] / pc[..., 2:] + np.array([160.0, 120.0]) + rng.normal(0, 0.3, pc.shape[:2] + (2,))
    R0 = np.einsum("nij,njk->nik", R, so3.expmap(torch.as_tensor(rng.normal(0, 0.004, (n, 3)),
                                                                 dtype=torch.float32)).numpy())
    pose_mask = np.arange(n) < n // 2
    data = SfmData(
        poses=SE3(R=torch.as_tensor(R0, dtype=torch.float32), t=torch.as_tensor(t + rng.normal(0, 0.05, t.shape),
                                                                                dtype=torch.float32)),
        cal=cal, pose_mask=torch.as_tensor(pose_mask),
        points=torch.as_tensor(np.concatenate([X + rng.normal(0, 0.05, X.shape), np.zeros((Tn, 3))]),
                               dtype=torch.float32),
        track_mask=torch.as_tensor(np.arange(2 * Tn) < Tn),
        meas_cam=torch.as_tensor(cams.reshape(-1)), meas_track=torch.as_tensor(np.repeat(np.arange(Tn), 4)),
        meas_uv=torch.as_tensor(uv.reshape(-1, 2), dtype=torch.float32),
        meas_mask=torch.as_tensor(rng.random(Tn * 4) > 0.1),
    )
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[[0, 6]] = True  # two cameras: the gauge's scale is fixed too
    ba = BundleAdjustment(BAOptions(max_iterations=15, layout="dense"))
    out_c, m_c = ba.run_compact(data, fixed_cam=fixed)
    out_g, m_g = ba.run_compact(data.map(lambda a: a.cuda()), fixed_cam=fixed.cuda())
    rel = torch.einsum("nji,njk->nik", out_c.poses.R.double(), out_g.poses.R.cpu().double())
    assert so3.logmap(rel).norm(dim=-1).max() < 1e-4
    t_c = out_c.poses.t
    assert (out_g.poses.t.cpu() - t_c).abs().max() <= 1e-4 * t_c.abs().max()
    assert torch.equal(out_g.poses.R.cpu()[~torch.as_tensor(pose_mask)], data.poses.R[~torch.as_tensor(pose_mask)])
    assert abs(m_g["final_cost"] - m_c["final_cost"]) <= 1e-3 * m_c["final_cost"] < m_c["initial_cost"]


@pytest.mark.cuda
def test_ba_layouts_agree_on_the_card():
    """Entry, scatter and dense on the card on a 24-camera ba_scene (plain
    least squares, cameras 0 and 1 fixed): each runs in its own layout,
    the three final costs agree to 1e-4 relative and the poses to 1e-4
    (the iterative layouts are one PCG solver, dense solves exactly; at
    convergence they meet), and entry on the card equals entry on the CPU
    to the same tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import ba_scene, ba_sfm_data
    from gtsfm_tpu_torch.bundle import ba

    scene = ba_scene(n_cams=24, n_points=600, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        data = ba_sfm_data(scene, dev)
        fixed = torch.arange(24, device=dev) < 2
        for layout in ("entry", "scatter", "dense") if dev == "cuda" else ("entry",):
            ba.layout_counts.clear()
            o, m = ba.BundleAdjustment(ba.BAOptions(robust_huber_px=0.0, layout=layout)).run(data, fixed_cam=fixed)
            assert dict(ba.layout_counts) == {layout: 1}
            out[dev, layout] = (m["final_cost"], o.poses.t.cpu(), m["initial_cost"])
    c_ref, t_ref, c0 = out["cuda", "dense"]
    assert c_ref < 1e-2 * c0
    for key, (c, t, _) in out.items():
        assert abs(c - c_ref) <= 1e-4 * c_ref, key
        assert (t - t_ref).abs().max() <= 1e-4 * t_ref.abs().max(), key


@pytest.mark.cuda
def test_ba_dense_falls_back_to_entry_above_128_on_the_card():
    """A track seen by 140 cameras: layout="dense" runs entry on the card
    instead of raising, with the result of asking for entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import ba_scene, ba_sfm_data
    from gtsfm_tpu_torch.bundle import ba

    data = ba_sfm_data(ba_scene(n_cams=140, n_points=300, long_track=140, seed=2), "cuda")
    fixed = torch.arange(140, device="cuda") < 2
    ba.layout_counts.clear()
    out_d, m_d = ba.BundleAdjustment(ba.BAOptions(max_iterations=5, layout="dense")).run(data, fixed_cam=fixed)
    assert dict(ba.layout_counts) == {"entry": 1}
    out_e, m_e = ba.BundleAdjustment(ba.BAOptions(max_iterations=5, layout="entry")).run(data, fixed_cam=fixed)
    assert m_d["final_cost"] == m_e["final_cost"] < m_d["initial_cost"]
    assert torch.equal(out_d.points, out_e.points)


@pytest.mark.cuda
def test_cal3ds2_calibrate_on_the_card_equals_the_cpu():
    """Cal3DS2.calibrate (10 fixed-point steps) of chip_smoke's OPENCV
    camera over a 480x640 pixel grid: the card within 1e-6 of the CPU in
    normalized coordinates (float32 order only), and both within 1e-5 of
    chip_smoke's float64 Newton inversion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import OPENCV_CAMERA as cam, opencv_undistort
    from gtsfm_tpu_torch.geometry import Cal3DS2

    c = Cal3DS2.create(cam["fx"], cam["fy"], 0.0, cam["cx"], cam["cy"], cam["k1"], cam["k2"], cam["p1"], cam["p2"])
    v, u = np.mgrid[0:480:7, 0:640:7].astype(np.float64)
    uv = torch.as_tensor(np.stack([u, v], -1).reshape(-1, 2), dtype=torch.float32)
    host = c.calibrate(uv)
    card = c.map(lambda a: a.cuda()).calibrate(uv.cuda()).cpu()
    assert (card - host).abs().max() <= 1e-6
    x, y = opencv_undistort((u.reshape(-1) - cam["cx"]) / cam["fx"], (v.reshape(-1) - cam["cy"]) / cam["fy"], cam)
    assert np.abs(host.numpy() - np.stack([x, y], -1)).max() <= 1e-5


@pytest.mark.cuda
def test_dog_sift_stable_topk_on_the_card_equals_the_cpu():
    """torch.sort(stable=True) keeps equal values lowest index first on the
    card too (jax.lax.top_k's order, which DoG-SIFT's selections need)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.frontend.detectors.dog_sift import stable_topk

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, 3, size=(4, 307_200)).astype(np.float32))
    x[:, -1] = -1.0
    for k in (170, 2048):
        vc, ic = stable_topk(x.cuda(), k)
        vh, ih = stable_topk(x, k)
        assert torch.equal(ic.cpu(), ih) and torch.equal(vc.cpu(), vh)


@pytest.mark.cuda
def test_dog_sift_on_the_card_finds_the_cpus_keypoints():
    """A padded batch of two procedural images at 240x320, K=2048: the same
    masked keypoint sets (coordinates and scales) on the card as on the CPU,
    responses to 1e-5 relative + 1e-6, descriptors of the same keypoint to
    1e-4 on at least 99% of them (test_torch_dog_sift.py's tolerances: the
    convolutions and sums run in another order), and nothing run on the CPU
    when the input lies on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import scipy.ndimage as ndi

    from gtsfm_tpu_torch.frontend.detectors import dog_sift

    rng = np.random.default_rng(3)
    batch = np.zeros((2, 240, 320), np.float32)
    for b, (h, w) in enumerate([(240, 320), (200, 280)]):
        img = np.kron(rng.uniform(size=(h // 8, w // 8)), np.ones((8, 8)))
        batch[b, :h, :w] = ndi.gaussian_filter(img, 1.0)
    opts = dog_sift.DoGSiftOptions(max_keypoints=2048, contrast_threshold=0.01)
    dog_sift.calls_by_device.clear()
    card = [a.cpu().numpy() for a in dog_sift.detect_and_describe(torch.as_tensor(batch, device="cuda"), opts)]
    assert dict(dog_sift.calls_by_device) == {"cuda": 1}
    host = [a.numpy() for a in dog_sift.detect_and_describe(torch.as_tensor(batch), opts)]
    for b in range(2):
        (cc, cs, cr, cm, cd), (hc, hs, hr, hm, hd) = ([a[b] for a in card], [a[b] for a in host])
        key_c = {k: i for i, k in enumerate(zip(cc[cm, 0], cc[cm, 1], cs[cm]))}
        key_h = {k: i for i, k in enumerate(zip(hc[hm, 0], hc[hm, 1], hs[hm]))}
        assert key_c.keys() == key_h.keys() and len(key_c) > 100
        ic = np.flatnonzero(cm)[[key_c[k] for k in key_h]]
        ih = np.flatnonzero(hm)[list(key_h.values())]
        np.testing.assert_allclose(cr[ic], hr[ih], rtol=1e-5, atol=1e-6)
        off = np.abs(cd[ic] - hd[ih]).max(axis=-1) > 1e-4
        assert off.mean() <= 0.01, off.mean()


def _two_view_scene(P: int, K: int, seed: int, planar_every: int = 0):
    """P two-view geometries in normalized coordinates (0.5 px noise at
    f = 600), 20% outliers, a ragged mask; every ``planar_every``-th pair
    has its points on one plane. Returns x1, x2 (P, K, 2), mask (P, K),
    the true R (P, 3, 3), t (P, 3) and inlier flags (P, K)."""
    rng = np.random.default_rng(seed)
    x1s, x2s, Rs, ts, outs = [], [], [], [], []
    for p in range(P):
        pts = rng.uniform([-2, -2, 4], [2, 2, 8], (K, 3))
        if planar_every and p % planar_every == 0:
            pts[:, 2] = 6.0
        w = rng.normal(size=3) * 0.15
        th = np.linalg.norm(w)
        Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) + np.sin(th) / th * Wx + (1 - np.cos(th)) / th**2 * Wx @ Wx
        t = np.array([1.0, 0.1, 0.2]) + 0.1 * rng.normal(size=3)
        p2 = pts @ R.T + t
        x1 = pts[:, :2] / pts[:, 2:] + rng.normal(0, 0.5 / 600, (K, 2))
        x2 = p2[:, :2] / p2[:, 2:] + rng.normal(0, 0.5 / 600, (K, 2))
        out = rng.random(K) < 0.2
        x2[out] = rng.uniform(-0.5, 0.5, (out.sum(), 2))
        x1s.append(x1)
        x2s.append(x2)
        Rs.append(R)
        ts.append(t / np.linalg.norm(t))
        outs.append(out)
    mask = rng.random((P, K)) > 0.1
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return f32(x1s), f32(x2s), torch.as_tensor(mask), f32(Rs), f32(ts), torch.as_tensor(mask & ~np.asarray(outs))


@pytest.mark.cuda
def test_homography_ransac_on_the_card_equals_the_cpu():
    """ransac_homography at the runner phase's batch (64 pairs, 128
    hypotheses) on K = 2048 pixel correspondences, a quarter of the pairs
    planar, with the 4-point sets drawn on the card and handed to both: H
    up to scale to 1e-4; inliers equal except points whose transfer error
    lies within 2% of the threshold (an H 1e-4 apart moves a transfer error
    at the threshold by about 2e-4 / sqrt(threshold), near 1% of it here);
    the pairs the H/F rule flags equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.frontend.verifiers.fundamental import (
        _h_transfer_err,
        _hartley_normalize,
        gric_select_model,
        ransac_homography,
        sample_homography_sets,
    )

    x1, x2, mask, _, _, _ = _two_view_scene(64, 2048, seed=3, planar_every=4)
    uv1, uv2 = x1 * 600 + 320, x2 * 600 + 240
    idx = sample_homography_sets(mask.cuda(), 128, seed=0).cpu()
    card = ransac_homography(uv1.cuda(), uv2.cuda(), mask.cuda(), 4.0, 128, sample_idx=idx.cuda())
    host = ransac_homography(uv1, uv2, mask, 4.0, 128, sample_idx=idx)
    Hc, Hh = card["H"].cpu(), host["H"]
    Hc = Hc / torch.linalg.vector_norm(Hc, dim=(-2, -1), keepdim=True)
    Hh = Hh / torch.linalg.vector_norm(Hh, dim=(-2, -1), keepdim=True)
    sign = torch.sign((Hc * Hh).sum((-2, -1)))[:, None, None]
    assert (Hc - sign * Hh).abs().max() <= 1e-4
    maskf = mask.float()
    x1n, T1 = _hartley_normalize(uv1, maskf)
    x2n, T2 = _hartley_normalize(uv2, maskf)
    t2 = ((4.0 * (0.5 * (T1[:, 0, 0] + T2[:, 0, 0]))) ** 2)[:, None]
    off = (_h_transfer_err(Hh, x1n, x2n) - t2).abs() > 2e-2 * t2
    assert not ((card["inliers"].cpu() != host["inliers"]) & off).any()
    # a fifth of the correspondences are outliers: H explains about 0.8 of
    # a planar pair's valid points, few of another's
    planar = torch.arange(64) % 4 == 0
    degen, _ = gric_select_model(mask, host["inliers"], mask, 0.5)
    degen_c, _ = gric_select_model(mask.cuda(), card["inliers"], mask.cuda(), 0.5)
    assert torch.equal(degen_c.cpu(), degen) and torch.equal(degen, planar)


@pytest.mark.cuda
def test_lmeds_votes_and_spectrum_on_the_card_equal_the_cpu():
    """LMedS votes (minus the median Sampson error of 256 scored points, the
    mean of the two middle ones) of 512 hypotheses a pair, each the true E
    of the pair perturbed by 1e-2, at the runner's batch (64 pairs, K =
    2048): to 1e-4 relative plus 1e-10 (float32 cancellation in x2^T E x1,
    whose terms are of unit size, leaves the smallest medians, near 6e-7,
    up to 1.2e-4 apart relative: measured), and the same winner wherever
    the best two votes differ by more than 1e-4 relative; then the
    information spectrum at the true poses with the true inliers (but for
    residuals at the floor, see below): both extreme eigenvalues to 1e-4 of
    the largest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.frontend.verifiers.essential import (
        RansacOptions,
        _sampson_error,
        essential_information_spectrum,
        hypothesis_votes,
    )
    from gtsfm_tpu_torch.geometry import so3

    x1, x2, mask, R, t, inl = _two_view_scene(64, 2048, seed=4)
    g = torch.Generator().manual_seed(0)
    dR = so3.expmap(1e-2 * torch.randn((64, 512, 3), generator=g))
    dt = 1e-2 * torch.randn((64, 512, 3), generator=g)
    E = so3.hat(t[:, None] + dt) @ R[:, None] @ dR
    thresh2 = torch.full((64,), (4.0 / 600) ** 2)
    opts = RansacOptions(scoring="lmeds")
    with precise():
        card = hypothesis_votes(E.cuda(), x1.cuda(), x2.cuda(), mask.cuda(), thresh2.cuda(), opts).cpu()
    host = hypothesis_votes(E, x1, x2, mask, thresh2, opts)
    assert ((card - host).abs() <= 1e-4 * host.abs() + 1e-10).all()
    top2 = host.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]).abs() > 1e-4 * top2[:, 0].abs()
    assert clear.sum() > 32
    assert torch.equal(card.argmax(-1)[clear], host.argmax(-1)[clear])
    # the residual's 1e-9 floor (sqrt(max(err, 1e-18))) zeroes a Jacobian
    # row; a residual within float32 cancellation (about 1e-8 here) of it
    # can sit on one side on the card and on the other on the CPU (measured:
    # one point of 64 x 2048, 1.45e-8 against 1e-9, its row 7e-4 of the
    # largest eigenvalue), so such points are weighted 0
    err = _sampson_error(so3.hat(t) @ R, x1, x2)
    args = (x1, x2, (inl & (err > 1e-12)).float(), R, t)
    mn_c, mx_c = essential_information_spectrum(*(a.cuda() for a in args))
    mn_h, mx_h = essential_information_spectrum(*args)
    assert ((mn_c.cpu() - mn_h).abs() <= 1e-4 * mx_h).all()
    assert ((mx_c.cpu() - mx_h).abs() <= 1e-4 * mx_h).all()


def _smooth_images(n: int, hw: tuple, seed: int) -> np.ndarray:
    x = torch.as_tensor(np.random.default_rng(seed).uniform(0, 1, (n,) + hw).astype(np.float32))
    return torch.nn.functional.avg_pool2d(x[:, None], 5, stride=1, padding=2, count_include_pad=False)[:, 0].numpy()


# D2-Net keeps a pixel whose feature equals both its channel maximum and its
# 3x3 maximum, so float32 order decides ties: the card's order moved 4 of
# the first image's 189 keypoints below (0.9788) in a first run on the card
D2NET_KEYPOINT_SHARE = 0.97


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["superpoint", "d2net", "disk"])
def test_deep_detectors_on_the_card_find_the_cpus_keypoints(name):
    """Each detector through the registry (its seeded init) on two 240x320
    images: on each image at least DEEP_KEYPOINT_SHARE (D2-Net:
    D2NET_KEYPOINT_SHARE) of the valid keypoints found on both devices (NMS
    ties and the top-K cut move with float32 order), their descriptors
    within DEEP_DESC_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.frontend import registry

    det = registry.build_detector({"name": name, "max_keypoints": 1024})
    x = _smooth_images(2, (240, 320), 0)
    card = det.detect_batch(torch.as_tensor(x, device="cuda"))
    host = det.detect_batch(torch.as_tensor(x))
    for b in range(2):
        assert card[1][b].sum() > 0
        share, err = keypoints_agree(*(a[b] for a in card), *(a[b] for a in host))
        bar = D2NET_KEYPOINT_SHARE if name == "d2net" else DEEP_KEYPOINT_SHARE
        assert share >= bar and err <= DEEP_DESC_TOL, (share, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["netvlad", "hloc_netvlad", "megaloc"])
def test_global_descriptors_on_the_card_equal_the_cpu(name):
    """Each global descriptor through the registry (its seeded init, full
    width) on two 240x320 images: unit rows within DEEP_DESC_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.frontend import registry

    desc = registry.build_global_descriptor({"name": name})
    x = _smooth_images(2, (240, 320), 1)
    card = desc.describe_batch(torch.as_tensor(x, device="cuda"))
    host = desc.describe_batch(torch.as_tensor(x))
    assert np.isfinite(card).all() and np.abs(card - host).max() <= DEEP_DESC_TOL


@pytest.mark.cuda
def test_ransac_on_a_one_match_pair_runs_on_the_card():
    """A pair whose minimal sets repeat its one match gives NaN hypotheses:
    numerics.svd / eigh turn them into NaN factors on the card as on the
    CPU, where torch's own would raise; the pair comes out unsuccessful."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gtsfm_tpu_torch.frontend.verifiers.essential import ransac_essential

    rng = np.random.default_rng(0)
    x1 = torch.as_tensor((rng.normal(size=(2, 16, 2)) * 0.3).astype(np.float32))
    x2 = torch.as_tensor((rng.normal(size=(2, 16, 2)) * 0.3).astype(np.float32))
    x1[0, 0] = torch.tensor([-0.2633333206176758, -0.03166666626930237])
    x2[0, 0] = torch.tensor([-0.23666661977767944, -0.11166666448116302])
    mask = torch.zeros((2, 16), dtype=torch.bool)
    mask[0, 0] = True
    idx = torch.arange(8).expand(2, 512, 8)
    out = ransac_essential(x1.cuda(), x2.cuda(), mask.cuda(), torch.full((2,), 0.0067, device="cuda"),
                           sample_idx=idx.cuda())
    assert not out["success"].any() and (out["num_inliers"].cpu() <= mask.sum(-1)).all()
