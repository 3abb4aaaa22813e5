"""The port on a CUDA card: the fused matcher, attention and splat
compositing kernels against their plain PyTorch versions, the splat
trainer, the back end's run-to-run reproducibility, and the card against
the CPU on the synthetic direct branch (equal index outputs, no matcher
launch) and on the merge's compacted BA (``run_compact``).

These tests need a CUDA card (marker ``cuda``) and skip elsewhere. The
file imports no JAX, so it also runs on a card's machine without it; there
run it without tests/conftest.py, which sets JAX up for the reference tests:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Matcher shapes cover what the kernel takes beyond the slice's (P, 1024, 128):
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
    KERNEL_TOL_BEST,
    attention_agrees,
    attention_entries,
    composite_plain,
    kernel_agrees,
)
from gtsfm_tpu_torch.frontend.matchers import fused_attention, fused_matcher
from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
from gtsfm_tpu_torch.splat import rendering
from gtsfm_tpu_torch.utils.numerics import precise

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
@pytest.mark.parametrize("case", ["ragged", "ties", "d136"])
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
    ba = BundleAdjustment(BAOptions(max_iterations=15))
    out_c, m_c = ba.run_compact(data, fixed_cam=fixed)
    out_g, m_g = ba.run_compact(data.map(lambda a: a.cuda()), fixed_cam=fixed.cuda())
    rel = torch.einsum("nji,njk->nik", out_c.poses.R.double(), out_g.poses.R.cpu().double())
    assert so3.logmap(rel).norm(dim=-1).max() < 1e-4
    t_c = out_c.poses.t
    assert (out_g.poses.t.cpu() - t_c).abs().max() <= 1e-4 * t_c.abs().max()
    assert torch.equal(out_g.poses.R.cpu()[~torch.as_tensor(pose_mask)], data.poses.R[~torch.as_tensor(pose_mask)])
    assert abs(m_g["final_cost"] - m_c["final_cost"]) <= 1e-3 * m_c["final_cost"] < m_c["initial_cost"]
