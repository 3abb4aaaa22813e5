"""The port's splat package against the JAX reference, on the CPU.

The same seeded numpy inputs go through both packages. The reference's
Pallas compositing kernel runs in interpret mode, as its own tests run it.

Tolerances, each with its reason:
- projection, brute render, plain compositing against the reference's XLA
  scan, Sim3 transforms: 1e-5 (float32 in another summation order);
- ``render_tiled``: 1e-4 (the reference's sort is not stable, so two
  gaussians whose kept depth bits tie may composite in another order);
- plain compositing against the Pallas kernel: 5e-2, the reference's own
  bound for its bf16-pair attribute packing;
- gradients through ``TiledComposite`` against ``jax.grad``: 1e-4 of the
  gradient's norm (float32 sums of many small terms in another order);
- five trainer steps: 1e-4 for every parameter but the quaternions, which
  get 5 * lr_quats: a rotation does not change an isotropic gaussian, so
  their gradient is rounding noise and Adam's normalized first steps move
  them by up to lr each, in either direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.common.sfm_data import SfmData as JSfmData
from gtsfm_tpu.geometry import SE3 as JSE3, Cal3Bundler as JCal
from gtsfm_tpu.geometry.sim3 import Sim3 as JSim3
from gtsfm_tpu.splat import rendering as jr
from gtsfm_tpu.splat.gaussian_splatting import GaussianSplatting as JTrainer, GSTrainOptions as JTrainOptions
from gtsfm_tpu.splat.gs_data import GSData as JGSData, export_ply as j_export, load_ply as j_load
from gtsfm_tpu.splat.merge import merge_gaussian_splats as j_merge, transform_splats as j_transform
from gtsfm_tpu_torch.geometry import SE3
from gtsfm_tpu_torch.geometry.sim3 import Sim3
from gtsfm_tpu_torch.splat import rendering as tr
from gtsfm_tpu_torch.splat.gaussian_splatting import GaussianSplatting, GSTrainOptions
from gtsfm_tpu_torch.splat.gs_data import GSData, export_ply, load_ply
from gtsfm_tpu_torch.splat.merge import merge_gaussian_splats, transform_splats
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads, threads

cap_threads()

FIELDS = ("means", "log_scales", "quats", "opacity_logit", "colors", "alive")
K_TILED = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields(g) -> dict:
    return {k: np.array(getattr(g, k)) for k in FIELDS}


def _both(fields: dict):
    """numpy GSData fields -> (reference GSData, port GSData)."""
    return JGSData(**{k: jnp.asarray(v) for k, v in fields.items()}), convert.gs_data(fields)


def _tiled_scene(G=400, seed=0) -> dict:
    """The 400-gaussian scene of tests/splat/test_tiled_render.py."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2, 2, (G, 3)).astype(np.float32)
    means[:, 2] += 6
    return dict(
        means=means,
        log_scales=np.log(rng.uniform(0.02, 0.12, (G, 3))).astype(np.float32),
        quats=np.tile([1, 0, 0, 0.0], (G, 1)).astype(np.float32),
        colors=rng.normal(0, 1, (G, 3)).astype(np.float32),
        opacity_logit=rng.normal(0, 1, G).astype(np.float32),
        alive=np.ones(G, np.float32),
    )


def _single_gaussian() -> dict:
    """test_splat.py's single red gaussian (4 slots, 1 alive)."""
    g = _fields(JGSData.from_points(np.asarray([[0.0, 0.0, 4.0]], np.float32), max_gaussians=4))
    c = np.clip(np.asarray([0.9, 0.2, 0.2]), 1e-3, 1 - 1e-3)
    g["colors"] = np.zeros((4, 3), np.float32)
    g["colors"][0] = np.log(c / (1 - c))
    g["log_scales"] = np.full((4, 3), np.log(0.2), np.float32)
    g["opacity_logit"] = np.full(4, np.log(0.9 / 0.1), np.float32)
    return g


def _depth_pair() -> dict:
    """test_splat.py's near red / far green pair on one ray."""
    g = _fields(JGSData.from_points(np.asarray([[0, 0, 3.0], [0, 0, 6.0]], np.float32), max_gaussians=4))
    g["colors"] = np.zeros((4, 3), np.float32)
    g["colors"][0] = [5.0, -5.0, -5.0]
    g["colors"][1] = [-5.0, 5.0, -5.0]
    g["log_scales"] = np.full((4, 3), np.log(0.25), np.float32)
    g["opacity_logit"] = np.full(4, 4.0, np.float32)
    return g


def _rotated(fields: dict, seed=1) -> dict:
    """The scene with random anisotropic scales and orientations and a
    camera-facing offset, so every term of the projection is exercised."""
    rng = np.random.default_rng(seed)
    out = dict(fields)
    G = len(out["means"])
    out["quats"] = rng.normal(size=(G, 4)).astype(np.float32)
    out["log_scales"] = (out["log_scales"] + rng.uniform(-0.5, 0.5, (G, 3))).astype(np.float32)
    return out


def _pose(seed=2):
    """A camera a little off the identity."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, 3)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    return R.astype(np.float32), rng.normal(0, 0.2, 3).astype(np.float32)


CAMERA_64 = np.array([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("scene", ["single", "depth_pair", "tiled_rotated"])
def test_project_and_brute_render_match_reference(scene):
    fields = {"single": _single_gaussian, "depth_pair": _depth_pair,
              "tiled_rotated": lambda: _rotated(_tiled_scene(G=120))}[scene]()
    K = CAMERA_64 if scene != "tiled_rotated" else K_TILED
    H, W = (64, 64) if scene != "tiled_rotated" else (96, 128)
    # test_splat.py's camera at the origin, or one a little off it
    R, t = _pose() if scene == "tiled_rotated" else (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    gj, gt = _both(fields)
    wj, wt = JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), SE3(R=torch.as_tensor(R), t=torch.as_tensor(t))
    for a, b in zip(jr.project_gaussians(gj, wj, jnp.asarray(K)), tr.project_gaussians(gt, wt, torch.as_tensor(K))):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-5, atol=1e-5)
    img_j, am_j = jr.render(gj, wj, jnp.asarray(K), H, W, chunk=64)
    img_t, am_t = tr.render(gt, wt, torch.as_tensor(K), H, W, chunk=64)
    assert float(np.abs(_np(img_t) - np.asarray(img_j)).max()) <= 1e-5
    assert float(np.abs(_np(am_t) - np.asarray(am_j)).max()) <= 1e-5
    if scene == "depth_pair":  # the near red gaussian occludes the far green one
        assert _np(img_t)[32, 32, 0] > 0.8 and _np(img_t)[32, 32, 1] < 0.2


@pytest.mark.parametrize("case", ["240x320", "240x320_dup64", "233x317"])
def test_render_tiled_matches_reference(case):
    H, W = (233, 317) if case == "233x317" else (240, 320)
    kw = {"max_dup": 64} if case.endswith("dup64") else {}
    gj, gt = _both(_tiled_scene(G=200, seed=3) if case == "233x317" else _tiled_scene())
    img_j, am_j = jr.render_tiled(gj, JSE3.identity(()), jnp.asarray(K_TILED), H, W, **kw)
    img_t, am_t = tr.render_tiled(gt, SE3.identity(()), torch.as_tensor(K_TILED), H, W, **kw)
    assert img_t.shape == (H, W, 3) and am_t.shape == (H, W)
    assert float(np.abs(_np(img_t) - np.asarray(img_j)).max()) <= 1e-4
    assert float(np.abs(_np(am_t) - np.asarray(am_j)).max()) <= 1e-4


def _composite_inputs(n_tiles=6, cap=64, G=300, seed=0):
    """test_tiled_render.py::test_pallas_composite_matches_xla's inputs."""
    rng = np.random.default_rng(seed)
    packed = np.stack([
        rng.uniform(0, 64, G), rng.uniform(0, 64, G), rng.uniform(0, 0.9, G),
        rng.uniform(0, 1, G), rng.uniform(0, 1, G), rng.uniform(0, 1, G),
        rng.uniform(0.01, 0.3, G), rng.uniform(-0.05, 0.05, G), rng.uniform(0.01, 0.3, G),
    ], axis=-1).astype(np.float32)
    gidx = rng.integers(0, G, (n_tiles, cap)).astype(np.int32)
    counts = rng.integers(5, cap, n_tiles).astype(np.int32)
    org = (rng.integers(0, 3, (n_tiles, 2)) * 16).astype(np.int32)
    return packed, gidx, counts, org


@pytest.mark.parametrize("cap", [64, 128])
def test_plain_composite_matches_xla_scan_and_pallas_kernel(cap):
    packed, gidx, counts, org = _composite_inputs(cap=cap)
    cj, Tj = jr._composite_tiles_xla(*jr._gather_attrs_f32(jnp.asarray(packed), jnp.asarray(gidx),
                                                            jnp.asarray(counts)), jnp.asarray(org), 16)
    args = [torch.as_tensor(a) for a in (packed, gidx, counts, org)]
    ct, Tt = tr.composite_tiles_plain(*tr._gather_attrs_f32(*args[:3]), args[3], 16)
    assert float(np.abs(_np(ct) - np.asarray(cj)).max()) <= 1e-5
    assert float(np.abs(_np(Tt) - np.asarray(Tj)).max()) <= 1e-5
    # the wrapper on CPU tensors is the plain version
    cw, Tw = tr.composite_tiles(*args, 16)
    assert torch.equal(cw, ct) and torch.equal(Tw, Tt)
    cp, Tp = jr._composite_tiles_pallas(jnp.asarray(packed), jnp.asarray(gidx), jnp.asarray(counts),
                                        jnp.asarray(org), 16, interpret=True)
    assert float(np.abs(_np(ct) - np.asarray(cp)).max()) <= 5e-2
    assert float(np.abs(_np(Tt) - np.asarray(Tp)).max()) <= 5e-2


def test_composite_reference_drops_out_of_range_indices():
    """chip_smoke.composite_plain, what the card holds the kernel to: equal
    to the plain version on in-range indices, and a slot holding -1 or G
    adds nothing, as a slot of alpha 0 at an in-range index does."""
    packed, gidx, counts, org = (torch.as_tensor(a) for a in _composite_inputs())
    want = tr.composite_tiles_plain(*tr._gather_attrs_f32(packed, gidx, counts), org, 16)
    got = chip_smoke.composite_plain(packed, gidx, counts, org)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    G = packed.shape[0]
    bad = gidx.clone()
    bad[:, ::7] = -1
    bad[:, 3::11] = G
    zero = torch.cat([packed, torch.zeros_like(packed[:1])])
    want = tr.composite_tiles_plain(*tr._gather_attrs_f32(zero, torch.where(bad < 0, G, bad), counts), org, 16)
    got = chip_smoke.composite_plain(packed, bad, counts, org)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[1], chip_smoke.composite_plain(packed, gidx, counts, org)[1])


def test_composite_wrapper_rejects_what_it_does_not_take():
    packed, gidx, counts, org = (torch.as_tensor(a) for a in _composite_inputs())
    with pytest.raises(TypeError):
        tr.composite_tiles(packed, gidx.long(), counts, org, 16)
    with pytest.raises(ValueError):
        tr.composite_tiles(packed[:, :8].contiguous(), gidx, counts, org, 16)
    with pytest.raises(ValueError):
        tr.composite_tiles(packed, gidx, counts[:-1], org, 16)
    with pytest.raises(ValueError):
        tr.composite_tiles(packed, gidx.t().contiguous().t(), counts, org, 16)
    assert tr.composited_slots(100) == 64 and tr.composited_slots(512) == 512 and tr.composited_slots(40) == 40


def test_tiled_gradients_match_jax_grad():
    """d sum(img²) / d(means, colors) through TiledComposite, G=128 at 64x64
    (test_tiled_render.py::test_tiled_gradients_finite's setting)."""
    fields = _tiled_scene(G=128)
    gj, gt = _both(fields)
    K = jnp.asarray(K_TILED)

    def loss_j(means, colors):
        img, _ = jr.render_tiled(gj.replace(means=means, colors=colors), JSE3.identity(()), K, 64, 64,
                                 per_tile_cap=128)
        return jnp.sum(img**2)

    gm_j, gc_j = jax.grad(loss_j, argnums=(0, 1))(gj.means, gj.colors)
    means = gt.means.clone().requires_grad_(True)
    colors = gt.colors.clone().requires_grad_(True)
    img, _ = tr.render_tiled(gt.replace(means=means, colors=colors), SE3.identity(()), torch.as_tensor(K_TILED),
                             64, 64, per_tile_cap=128)
    torch.sum(img**2).backward()
    for got, want in ((means.grad, gm_j), (colors.grad, gc_j)):
        want = np.asarray(want)
        assert np.linalg.norm(want) > 0
        assert np.linalg.norm(_np(got) - want) <= 1e-4 * np.linalg.norm(want)


def test_gs_data_ply_and_camera_path_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2500, 3)).astype(np.float32)  # > 2000: the seeded subsample
    cols = rng.uniform(size=2500).astype(np.float32)
    gj = JGSData.from_points(pts, colors=cols, max_gaussians=3000)
    gt = GSData.from_points(pts, colors=cols, max_gaussians=3000)
    for k in FIELDS:
        np.testing.assert_array_equal(_np(getattr(gt, k)), np.asarray(getattr(gj, k)))
    assert gt.max_gaussians == 3000 and gt.num_alive() == 2500

    # PLY written by either package reads back the same in the other
    export_ply(gt, str(tmp_path / "port.ply"))
    j_export(gj, str(tmp_path / "ref.ply"))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()
    back_t, back_j = load_ply(str(tmp_path / "ref.ply")), j_load(str(tmp_path / "port.ply"))
    for k in FIELDS:
        np.testing.assert_array_equal(_np(getattr(back_t, k)), np.asarray(getattr(back_j, k)))
    assert back_t.max_gaussians == 2500

    n = 6
    R = np.stack([_pose(s)[0] for s in range(n)])
    t = np.stack([np.linspace(0, 4, n), np.sin(np.arange(n)), np.zeros(n)], -1).astype(np.float32)
    pj = jr.bspline_camera_path(JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), 23)
    pt = tr.bspline_camera_path(SE3(R=torch.as_tensor(R), t=torch.as_tensor(t)), 23)
    np.testing.assert_allclose(_np(pt.t), np.asarray(pj.t), atol=1e-5)
    np.testing.assert_allclose(_np(pt.R), np.asarray(pj.R), atol=1e-5)


def test_densify_cull_matches_reference():
    rng = np.random.default_rng(4)
    G = 64
    params = {
        "means": rng.normal(size=(G, 3)).astype(np.float32),
        "log_scales": rng.normal(-2, 0.3, (G, 3)).astype(np.float32),
        "quats": rng.normal(size=(G, 4)).astype(np.float32),
        "opacity_logit": rng.normal(0, 3, G).astype(np.float32),
        "colors": rng.normal(size=(G, 3)).astype(np.float32),
    }
    alive = rng.random(G) < 0.7
    grad_avg = rng.uniform(0, 1e-3, G)
    pj, aj = JTrainer()._densify_cull({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive), grad_avg)
    pt, at = GaussianSplatting(device="cpu")._densify_cull(
        {k: torch.as_tensor(v).requires_grad_(True) for k, v in params.items()}, torch.as_tensor(alive), grad_avg)
    np.testing.assert_array_equal(_np(at), np.asarray(aj))
    assert int(_np(at).sum()) != int(alive.sum())  # something was culled or cloned
    for k in params:
        np.testing.assert_array_equal(_np(pt[k]), np.asarray(pj[k]))
        assert pt[k].requires_grad


def _three_gaussian_views():
    """test_splat.py::test_training_improves_l1's scene: three colored
    gaussians seen by three cameras at 48x48 (Cal3Bundler here, the same K
    as its Cal3_S2)."""
    H = W = 48
    f = 60.0
    n = 3
    gt_pts = np.asarray([[0, 0, 4], [0.7, 0.3, 4.5], [-0.6, -0.2, 3.5]], np.float32)
    cols = np.zeros((4, 3), np.float32)
    cols[0], cols[1], cols[2] = [4, -4, -4], [-4, 4, -4], [-4, -4, 4]
    gt = JGSData.from_points(gt_pts, max_gaussians=4).replace(
        colors=jnp.asarray(cols), log_scales=jnp.full((4, 3), np.log(0.3)), opacity_logit=jnp.full(4, 3.0))
    poses = JSE3(R=jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))),
                 t=jnp.asarray(np.asarray([[0, 0, 0], [0.4, 0, 0], [-0.4, 0.1, 0]], np.float32)))
    K = jnp.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], jnp.float32)
    imgs = np.stack([np.asarray(jr.render(gt, JSE3(R=poses.R[i], t=poses.t[i]), K, H, W)[0]) for i in range(n)])
    cal = JCal.create(jnp.full(n, f), jnp.zeros(n), jnp.zeros(n), jnp.full(n, W / 2), jnp.full(n, H / 2))
    data = JSfmData.from_cameras_and_tracks(
        poses, cal, [(p, [(0, np.zeros(2, np.float32)), (1, np.zeros(2, np.float32))]) for p in gt_pts],
        num_cameras=n)
    return data, convert.sfm_data(jax.tree.map(np.asarray, data)), imgs


def test_trainer_steps_match_reference():
    data_j, data_t, imgs = _three_gaussian_views()
    opts = dict(iterations=5, densify_every=1000, chunk=16)
    gj, mj = JTrainer(JTrainOptions(**opts)).train(data_j, imgs)
    gt, mt = GaussianSplatting(GSTrainOptions(**opts), device="cpu").train(data_t, imgs)
    assert abs(mt["final_l1"] - mj["final_l1"]) <= 1e-5
    assert mt["num_gaussians"] == mj["num_gaussians"] == 3 and gt.max_gaussians == 256
    for k in ("means", "log_scales", "opacity_logit", "colors"):
        assert float(np.abs(_np(getattr(gt, k)) - np.asarray(getattr(gj, k))).max()) <= 1e-4, k
    tol_quats = 5 * GSTrainOptions().lr_quats
    assert float(np.abs(_np(gt.quats) - np.asarray(gj.quats)).max()) <= tol_quats


def test_trainer_improves_l1():
    """The reference's bar (test_splat.py::test_training_improves_l1) on the
    port alone: 120 steps, final L1 below 0.7 of the initial."""
    _data_j, data_t, imgs = _three_gaussian_views()
    gs, metrics = GaussianSplatting(GSTrainOptions(iterations=120, densify_every=1000, chunk=16),
                                    device="cpu").train(data_t, imgs)
    assert metrics["final_l1"] < metrics["initial_l1"] * 0.7, metrics
    assert bool(torch.isfinite(gs.means).all())


def test_transform_and_merge_splats_match_reference():
    rng = np.random.default_rng(5)
    a = _rotated(_tiled_scene(G=50, seed=6), seed=7)
    b = _rotated(_tiled_scene(G=40, seed=8), seed=9)
    a["alive"] = (rng.random(50) < 0.8)
    b["alive"] = (rng.random(40) < 0.8)
    R, t = _pose(10)
    s = np.float32(1.3)
    # b's first five are a's moved out by the inverse Sim3: merging brings
    # them back onto a's, where the dedup culls them
    b["means"][:5] = ((a["means"][:5] - t) @ R) / s
    sim_j = JSim3(R=jnp.asarray(R), t=jnp.asarray(t), s=jnp.asarray(s))
    sim_t = Sim3(R=torch.as_tensor(R), t=torch.as_tensor(t), s=torch.as_tensor(s))
    (aj, at), (bj, bt) = _both(a), _both(b)
    tj, tt = j_transform(bj, sim_j), transform_splats(bt, sim_t)
    for k in ("means", "log_scales", "quats"):
        np.testing.assert_allclose(_np(getattr(tt, k)), np.asarray(getattr(tj, k)), atol=1e-5)
    mj, mt = j_merge(aj, bj, sim_j), merge_gaussian_splats(at, bt, sim_t)
    assert mt.max_gaussians == mj.max_gaussians < int(a["alive"].sum() + b["alive"].sum())
    for k in FIELDS:
        np.testing.assert_allclose(_np(getattr(mt, k)), np.asarray(getattr(mj, k)), atol=1e-5)


@threads(4)
def test_scene_optimizer_runs_the_splat_back_end():
    """SceneOptimizer.run(run_gs=True) on the 12-camera ring of
    test_torch_scene.py, on the CPU: the splat metrics group is there,
    before total_summary, and finite."""
    from gtsfm_tpu_torch.geometry import Cal3Bundler
    from gtsfm_tpu_torch.loader.synthetic import SyntheticSceneLoader, spectral_ring_poses
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions

    n, K = 12, 256
    H, W = chip_smoke.IMAGE_HW
    pairs = chip_smoke.ring_pairs(n)
    gt = spectral_ring_poses(pairs, n)
    feed = chip_smoke.descriptor_feed(gt.R.numpy(), gt.t.numpy(), chip_smoke.FOCAL, chip_smoke.IMAGE_HW, K)
    cal = Cal3Bundler.create(torch.full((n,), chip_smoke.FOCAL), torch.zeros(n), torch.zeros(n),
                             torch.full((n,), W / 2.0), torch.full((n,), H / 2.0))
    so = SceneOptimizer(SceneOptimizerOptions(run_gs=True, gs_iterations=10, device="cpu"),
                        retriever=chip_smoke.FixedPairs(pairs), detector=chip_smoke.FeedDetector(*feed))
    data, groups = so.run(SyntheticSceneLoader(gt, cal=cal, image_size=chip_smoke.IMAGE_HW))
    names = [g.name for g in groups]
    assert names.index("gaussian_splatting_metrics") == names.index("total_summary") - 1
    m = {x.name: x.scalar for x in groups[names.index("gaussian_splatting_metrics")].metrics}
    assert set(m) == {"final_l1", "initial_l1", "num_gaussians", "iterations", "gs_sec"}
    assert m["iterations"] == 10 and 0 < m["num_gaussians"] <= 4 * data.number_tracks()
    assert all(np.isfinite(v) for v in m.values())
