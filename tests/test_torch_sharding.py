"""The port's sharded path (parallel/sharding.py, the --distributed_* flags)
on the CPU with Gloo: real worker processes of one torch.distributed job.

- The mesh's shape rule against the reference's ``make_mesh(n)`` for
  n = 1..8 (the conftest gives JAX 8 CPU devices), and the backend rule.
- One 4-rank world (mesh (2, 2)) that runs, in one launch: the port's
  ``_run_two_view`` on a small seeded scene (a chunk split over ``data``,
  desc1's rows over ``model``, and a last chunk that does not divide and
  runs whole) against the single-process port's: match tables, masks and
  counts equal, floats within the reference's own mesh tolerance (1e-5);
  the same with the direct branch's precomputed tables and with a
  learned matcher's slot (a stand-in that matches its data shard with the
  plain matcher); the model-split plain matcher against the unsplit one,
  exactly, at K1 = 300 (not a multiple of 128 x 2); the port's sharded BA
  against the reference's ``BundleAdjustment(opts, mesh=make_mesh(4))`` on
  the scene and options of tests/parallel/test_production_sharding.py
  (final cost rtol 1e-4, positions 1e-4), padded-uneven case included.
- A 2-rank ``gtsfm_tpu_torch.runner.main`` with --distributed_* on 4 of
  test_torch_runner.py's ring views, beside a single-process run, while
  the 4-rank world runs: exit 0, only rank 0 wrote, poses within 1e-4 of
  the single-process run's.

The sharded two-view is not held against the reference: torch cannot
replay JAX's threefry draws. The loop closes through two other holds: the
reference sharded equals the reference unsharded (its own mesh test), and
the port unsharded equals the reference (the two-view parity tests).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.bundle.ba import BAOptions as JBAOptions, BundleAdjustment as JBA
from gtsfm_tpu.parallel.sharding import make_mesh as j_make_mesh
from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses
from gtsfm_tpu_torch.parallel.sharding import backend_for, mesh_shape, shard_range
from gtsfm_tpu_torch.utils import convert
from tests.common.test_sfm_data import make_synthetic_scene
from tests.torch_threads import cap_threads, thread_share, threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds a world may take before its workers are killed
VIEWS = 4  # ring views of the runner case
WORKERS = 7  # processes of the two worlds, which run at once
BA_CASES = {"even": (JBAOptions(max_iterations=5, cg_iterations=10), False),
            "uneven": (JBAOptions(max_iterations=3, cg_iterations=8), True)}

_WORKER = textwrap.dedent(
    """
    import json, os, sys, types
    repo, rank, world, port, inputs, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    from gtsfm_tpu_torch import runner
    assert runner.maybe_init_distributed(types.SimpleNamespace(
        distributed_coordinator=f"127.0.0.1:{port}", distributed_num_processes=world,
        distributed_process_id=rank), device="cpu")
    from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment, layout_counts
    from gtsfm_tpu_torch.frontend.matchers.fused_matcher import fused_match_descriptors
    from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
    from gtsfm_tpu_torch.frontend.two_view import TwoViewOptions
    from gtsfm_tpu_torch.frontend.verifiers.essential import RansacOptions
    from gtsfm_tpu_torch.geometry import Cal3Bundler
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions

    sc = dict(np.load(os.path.join(inputs, "two_view.npz")))
    cal = Cal3Bundler.create(sc["f"], 0.0, 0.0, sc["u0"], sc["v0"])
    args = (sc["pairs"], sc["kp_xy"], sc["kp_mask"], sc["descs"], cal, (640, 480))
    res = {}
    kw_opts = dict(device="cpu", pair_batch_size=sc["batch"].item(),
                   two_view=TwoViewOptions(ransac=RansacOptions(num_hypotheses=64)))
    so = SceneOptimizer(SceneOptimizerOptions(**kw_opts))
    assert so._mesh is not None and so._mesh.shape == {"data": world // 2, "model": 2}
    mesh = so._mesh
    for k, v in vars(so._run_two_view(*args)).items():
        res["tv_" + k] = v.numpy()
    single = SceneOptimizer(SceneOptimizerOptions(use_mesh=False, **kw_opts))
    assert single._mesh is None
    for k, v in vars(single._run_two_view(*args)).items():
        res["tv1_" + k] = v.numpy()
    # the direct branch's precomputed match tables, and a learned matcher's
    # slot (a stand-in that matches its data shard with the plain matcher)
    table = tuple(res["tv1_" + k] for k in ("corr_i1", "corr_i2", "corr_mask"))

    class Matcher:
        def match_batch(self, d1, d2, xy1, xy2, m1, m2, image_size):
            return match_descriptors(d1, d2, m1, m2)

    for which, use_mesh, kw, opt_kw in (("pm", True, dict(pair_matches=table), {}),
                                        ("pm1", False, dict(pair_matches=table), {}),
                                        ("lm", True, {}, dict(matcher=Matcher()))):
        so_k = SceneOptimizer(SceneOptimizerOptions(use_mesh=use_mesh, **kw_opts), **opt_kw)
        for k, v in vars(so_k._run_two_view(*args, **kw)).items():
            res[f"{which}_{k}"] = v.numpy()
    p = sc["pairs"]
    d1, d2 = torch.as_tensor(sc["descs"][p[:, 0]]), torch.as_tensor(sc["descs"][p[:, 1]])
    m1, m2 = torch.as_tensor(sc["kp_mask"][p[:, 0]]), torch.as_tensor(sc["kp_mask"][p[:, 1]])
    for name, got in (("split", fused_match_descriptors(d1, d2, m1, m2, mesh=mesh)),
                      ("whole", match_descriptors(d1, d2, m1, m2))):
        for k, v in zip(("idx", "ok", "best"), got):
            res[f"match_{name}_{k}"] = v.numpy()
    for case in ("even", "uneven"):
        data = torch.load(os.path.join(inputs, f"ba_{case}.pt"), weights_only=False)
        opts = BAOptions(**json.loads(open(os.path.join(inputs, f"ba_{case}.json")).read()))
        fixed = torch.arange(data.max_cameras) == 0
        layout_counts.clear()
        out_d, m = BundleAdjustment(opts, mesh=mesh).run(data, fixed_cam=fixed)
        res[f"ba_{case}_layouts"] = np.array(sorted(layout_counts.items()), dtype=object)
        res[f"ba_{case}_cost"] = np.float64(m["final_cost"])
        res[f"ba_{case}_t"] = out_d.poses.t.numpy()
        res[f"ba_{case}_points"] = out_d.points.numpy()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    """
)

_RUNNER_WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, sys.argv[1])
    from gtsfm_tpu_torch import runner
    sys.exit(runner.main(sys.argv[2:]))
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argvs: list) -> list:
    """Start one worker process per argv (``python -c`` code and its
    arguments), each with its share of this process's threads among the
    WORKERS; returns the processes."""
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, thread_share() // WORKERS)), PYTHONPATH=REPO)
    return [subprocess.Popen([sys.executable, "-c", *argv], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env, cwd=REPO) for argv in argvs]


def _wait(procs: list) -> list:
    """Wait for the workers; returns their outputs. Every worker is killed
    at the time limit, and a failed one fails the test."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return outs


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == object:
        return a.tolist() == b.tolist()
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _two_view_scene(n=6, T=400, K=300, D=128, seed=0) -> dict:
    """n ring cameras (f = 500, 640x480) looking at T points in [-1, 1]^3;
    each image keeps K of the points as keypoints (0.5 px noise) with the
    point's descriptor plus noise, a few keypoints masked; all pairs."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 0.5 * np.pi, n)
    centers = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0.2 * rng.normal(size=n)], 1)
    X = rng.uniform(-1, 1, (T, 3))
    base = rng.normal(size=(T, D))
    kp_xy, kp_mask, descs = np.zeros((n, K, 2), np.float32), np.ones((n, K), bool), np.zeros((n, K, D), np.float32)
    for i, c in enumerate(centers):
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], 1)
        sel = rng.choice(T, K, replace=False)
        pc = (X[sel] - c) @ R
        kp_xy[i] = 500 * pc[:, :2] / pc[:, 2:] + [320, 240] + rng.normal(0, 0.5, (K, 2))
        d = base[sel] + 0.3 * rng.normal(size=(K, D))
        descs[i] = d / np.linalg.norm(d, axis=1, keepdims=True)
        kp_mask[i, rng.choice(K, 8, replace=False)] = False
    pairs = np.array([(a, b) for a in range(n) for b in range(a + 1, n)], np.int64)
    return dict(kp_xy=kp_xy, kp_mask=kp_mask, descs=descs, pairs=pairs, f=np.full(n, 500.0, np.float32),
                u0=np.full(n, 320.0, np.float32), v0=np.full(n, 240.0, np.float32), batch=np.int64(8))


def _ba_scene(drop_last: bool):
    """The scene of the reference's mesh BA test, one measurement dropped in
    the uneven case (so M does not divide by the data axis)."""
    data = make_synthetic_scene(n_cams=4, n_tracks=30, noise=0.5)
    if drop_last:
        keep = jnp.arange(data.meas_cam.shape[0]) < data.meas_cam.shape[0] - 1
        data = data.replace(meas_cam=data.meas_cam[keep], meas_track=data.meas_track[keep],
                            meas_uv=data.meas_uv[keep], meas_mask=data.meas_mask[keep])
    return data


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_is_the_reference_rule(n, devices8):
    assert mesh_shape(n) == j_make_mesh(n).devices.shape
    assert mesh_shape(n, data_model_split=False) == j_make_mesh(n, data_model_split=False).devices.shape


def test_backend_rule():
    assert backend_for("cuda", 1, 1) == "nccl"
    assert backend_for("cuda", 4, 8) == "nccl"
    assert backend_for("cuda", 4, 1) == "gloo"  # NCCL refuses two ranks on one card
    assert backend_for("cuda", 2, 0) == "gloo"
    assert backend_for("cpu", 4, 8) == "gloo"
    # whole 128-row tiles over the model ranks, the first ranks taking the extra tile
    assert [shard_range(300, 2, i, 128) for i in range(2)] == [(0, 256), (256, 300)]
    assert [shard_range(100, 2, i, 128) for i in range(2)] == [(0, 100), (100, 100)]
    assert [shard_range(2048, 2, i, 128) for i in range(2)] == [(0, 1024), (1024, 2048)]


def test_four_rank_world_matches_the_single_process_port_and_the_reference_mesh(tmp_path, devices8, runner_world):
    inputs, out = tmp_path / "in", tmp_path / "out"
    inputs.mkdir()
    out.mkdir()
    sc = _two_view_scene()
    np.savez(inputs / "two_view.npz", **sc)
    scenes = {case: _ba_scene(drop) for case, (_opts, drop) in BA_CASES.items()}
    for case, (opts, _drop) in BA_CASES.items():
        torch.save(convert.sfm_data(scenes[case]), inputs / f"ba_{case}.pt")
        (inputs / f"ba_{case}.json").write_text(json.dumps(
            {k: getattr(opts, k) for k in ("max_iterations", "cg_iterations")}))
    port = _free_port()
    procs = _launch([[_WORKER, REPO, str(r), "4", str(port), str(inputs), str(out)] for r in range(4)])
    want = {}  # the reference's mesh BA, while the workers run
    for case, (opts, _drop) in BA_CASES.items():
        data_j = scenes[case]
        fixed = jnp.zeros(4, bool).at[0].set(True)
        mesh = j_make_mesh(4)
        assert mesh.devices.shape == (2, 2)
        if case == "uneven":
            assert data_j.meas_cam.shape[0] % mesh.shape["data"] != 0
        out_j, m_j = JBA(opts, mesh=mesh).run(data_j, fixed_cam=fixed)
        want[case] = (m_j["final_cost"], np.asarray(out_j.poses.t), np.asarray(out_j.points))
    _wait(procs)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
    for r, res in enumerate(ranks):
        # every rank holds the same bits
        for k, v in res.items():
            assert _same_bits(v, ranks[0][k]), (r, k)
    res = ranks[0]
    # the mutual-NN kernel's path, precomputed tables, and a learned
    # matcher's slot whose stand-in makes the unsharded path's own matches
    for got, ref in (("tv", "tv1"), ("pm", "pm1"), ("lm", "tv1")):
        for k in ("corr_i1", "corr_i2", "corr_mask", "num_matches", "num_inliers", "valid"):
            assert np.array_equal(res[f"{got}_{k}"], res[f"{ref}_{k}"]), (got, k)
        assert res[f"{got}_valid"].sum() >= 10 and res[f"{got}_num_matches"].min() > 20, got
        for k in ("i2Ri1", "i2Ui1", "inlier_ratio", "hf_ratio", "eig_ratio"):
            np.testing.assert_allclose(res[f"{got}_{k}"], res[f"{ref}_{k}"], atol=1e-5, err_msg=f"{got} {k}")
    for k in ("idx", "ok", "best"):
        assert np.array_equal(res[f"match_split_{k}"], res[f"match_whole_{k}"]), k
    assert res["match_split_ok"].sum() > 1000
    for case, (cost, t, points) in want.items():
        assert dict(res[f"ba_{case}_layouts"].tolist()) == {"scatter": 1}
        np.testing.assert_allclose(res[f"ba_{case}_cost"], cost, rtol=1e-4)
        np.testing.assert_allclose(res[f"ba_{case}_t"], t, atol=1e-4)
        np.testing.assert_allclose(res[f"ba_{case}_points"], points, atol=1e-4)


@pytest.fixture(scope="module")
def runner_world(tmp_path_factory) -> tuple:
    """The runner case's processes, started on an Olsson folder of the first
    VIEWS views of test_torch_runner.py's ring_folder (chip_smoke's
    runner_scene at 480x640, f = 600, 256 slots a tile): 2 ranks of one
    job, each with its own --output_root, and a single process. The 4-rank
    test asks for this fixture too, so that the two worlds run at once.
    Returns (the processes, the output directory)."""
    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)[:VIEWS]
    with threads(8):
        views = chip_smoke.ring_views(R, t, torch.device("cpu"), chip_smoke.runner_scene(t.mean(axis=0)),
                                      indices=order, per_tile_cap=256)
    root = tmp_path_factory.mktemp("runner")
    data = str(root / "data")
    chip_smoke.write_olsson(data, views, R[order], t[order], chip_smoke.SPLAT_FOCAL)
    base = ["--config_name", "unified", "--loader", "olsson", "--dataset_dirpath", data]
    over = ["detector.max_keypoints=512", "scene_optimizer.device=cpu",
            "scene_optimizer.two_view.ransac.num_hypotheses=64"]
    dist = ["--distributed_coordinator", f"127.0.0.1:{_free_port()}", "--distributed_num_processes", "2"]
    procs = _launch([[_RUNNER_WORKER, REPO, *base, *dist, "--distributed_process_id", str(r), "--output_root",
                      str(root / f"rank{r}"), *over] for r in range(2)]
                    + [[_RUNNER_WORKER, REPO, *base, "--output_root", str(root / "single"), *over]])
    yield procs, root
    _wait(procs)  # a test that failed before waiting still reaps them


def test_two_rank_runner_writes_once_and_matches_the_single_process_run(runner_world):
    from gtsfm_tpu_torch.io import colmap

    procs, root = runner_world
    outs = _wait(procs)
    assert "backend gloo" in outs[0] and "backend gloo" in outs[1]
    assert not (root / "rank1").exists()  # only rank 0 writes
    got = colmap.read_scene(str(root / "rank0" / "results" / "ba_output"))
    want = colmap.read_scene(str(root / "single" / "results" / "ba_output"))
    assert got.number_images() == want.number_images() == VIEWS
    np.testing.assert_allclose(got.poses.t.numpy(), want.poses.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.poses.R.numpy(), want.poses.R.numpy(), atol=1e-4)
