"""The port's LightGlue matcher against the reference, and the LightGlue
slice end to end.

- ``LightGlueNet``: the port against the reference's ``LightGlueNet.apply``
  at dim 256, 4 heads, 2 layers, K0 != K1 with masks, weights carried
  across by ``convert.lightglue_state_dict``. Float32 to float32 round-off
  (rtol 1e-5, atol 2e-4 on log-assignments up to ~50). In bf16 both
  packages round at their own places, so each is held to the float32
  forward: the port's bf16 error may be at most twice the reference's own
  (and the two bf16 forwards at most that far apart). One case has 8 heads
  of 32, where ``_merged_heads_ok`` fails and the split route runs.
- The official layout: the torch model of tests/frontend/test_lightglue_exact.py
  (loaded by path) gives its state_dict to the port's ``load_state_dict``;
  the port's forward agrees with that model's and with the reference's
  (2e-4, the reference's own tolerance: the torch model's LayerNorm epsilon
  is 1e-5, the reference's 1e-6). ``load_torch_weights`` reads the options
  back from a saved checkpoint.
- The matcher contract: ``match_batch`` against the reference matcher's
  ``_postprocess`` on the same log-assignment, and whole ``match_batch``
  runs of both matchers on the glue fixture (float32): identical matches.
- The registry's ``build_matcher``.
- The slice: a 12-camera ring with the descriptor feed at D=256 and the
  glue fixture (2 layers, K=256, float32) through both packages'
  ``SceneOptimizer.run`` with the LightGlue matcher. Matching is
  deterministic, so per-pair match counts must be equal; RANSAC and the
  back end draw from different random streams, so the reconstructions are
  held to the accuracy bar: both register 12/12 and the port's pose AUC@5
  is within 0.02 of the reference's.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.frontend.matchers.lightglue import (
    LightGlueMatcher as JMatcher,
    LightGlueNet as JNet,
    LightGlueOptions as JOptions,
    convert_torch_state_dict,
)
from gtsfm_tpu.geometry import Cal3Bundler as JCal
from gtsfm_tpu.loader.synthetic import SyntheticSceneLoader as JLoader, spectral_ring_poses as j_ring
from gtsfm_tpu.scene.scene_optimizer import SceneOptimizer as JSceneOptimizer, SceneOptimizerOptions as JSO
from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa
from gtsfm_tpu_torch.frontend.matchers.lightglue import (
    LightGlueMatcher,
    LightGlueNet,
    LightGlueOptions,
    load_torch_weights,
    options_from_state_dict,
)
from gtsfm_tpu_torch.frontend.registry import build_matcher
from gtsfm_tpu_torch.geometry import Cal3Bundler
from gtsfm_tpu_torch.loader.synthetic import SyntheticSceneLoader
from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions
from gtsfm_tpu_torch.utils import convert
from tests.torch_threads import cap_threads, threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.as_tensor


def _net_inputs(K0, K1, D, seed=0):
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(K0, D)).astype(np.float32)
    d1 = rng.normal(size=(K1, D)).astype(np.float32)
    c0 = rng.uniform(-1, 1, (K0, 2)).astype(np.float32)
    c1 = rng.uniform(-1, 1, (K1, 2)).astype(np.float32)
    m0 = rng.random(K0) > 0.2
    m1 = rng.random(K1) > 0.2
    return d0, d1, c0, c1, m0, m1


def _port_net(opts, state_dict, inputs, masks=True):
    net = LightGlueNet(opts)
    net.load_state_dict(state_dict)
    d0, d1, c0, c1, m0, m1 = (T(a)[None] for a in inputs)
    with torch.no_grad():
        return net(d0, d1, c0, c1, m0 if masks else None, m1 if masks else None)[0][0].numpy()


def _valid(m0, m1):
    """Entries of a log-assignment (K0+1, K1+1) the masks leave in play."""
    return np.pad(m0, (0, 1), constant_values=True)[:, None] & np.pad(m1, (0, 1), constant_values=True)[None, :]


@pytest.mark.parametrize("heads", [4, 8])
def test_net_matches_reference(heads):
    D, L = 256, 2
    inputs = _net_inputs(40, 33, D)
    z = {}
    for mp in (False, True):
        jnet = JNet(JOptions(dim=D, num_layers=L, num_heads=heads, input_dim=D, mixed_precision=mp))
        params = jax.jit(jnet.init)(jax.random.PRNGKey(1), *inputs)["params"]
        z["jax", mp] = np.asarray(jax.jit(jnet.apply)({"params": params}, *inputs)[0])
        sd = convert.lightglue_state_dict(jax.tree.map(np.asarray, params))
        opts = LightGlueOptions(dim=D, num_layers=L, num_heads=heads, input_dim=D, mixed_precision=mp)
        z["port", mp] = _port_net(opts, sd, inputs)
    valid = _valid(inputs[4], inputs[5])
    np.testing.assert_allclose(z["port", False][valid], z["jax", False][valid], rtol=1e-5, atol=2e-4)
    ref = z["jax", False][valid]
    jax_bf16 = np.abs(z["jax", True][valid] - ref).max()
    assert 0 < jax_bf16 < 1.0
    assert np.abs(z["port", True][valid] - ref).max() <= 2 * jax_bf16
    assert np.abs(z["port", True][valid] - z["jax", True][valid]).max() <= 2 * jax_bf16


def _official_model():
    """TorchLightGlue, the official architecture, from the reference's test
    (loaded by path: tests/frontend is not a package)."""
    path = os.path.join(REPO, "tests", "frontend", "test_lightglue_exact.py")
    spec = importlib.util.spec_from_file_location("lightglue_exact_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TorchLightGlue


@pytest.mark.parametrize("dim,heads", [(64, 4), (256, 4)])
def test_official_layout_loads_and_matches(dim, heads):
    torch.manual_seed(0)
    tmodel = _official_model()(dim, dim, heads, 2).eval()
    sd = tmodel.state_dict()
    opts = options_from_state_dict(sd, LightGlueOptions(mixed_precision=False))
    assert (opts.dim, opts.num_heads, opts.num_layers, opts.input_dim) == (dim, heads, 2, dim)
    inputs = _net_inputs(24, 24, dim, seed=dim)
    got = _port_net(opts, sd, inputs, masks=False)
    d0, d1, c0, c1 = (T(a)[None] for a in inputs[:4])
    with torch.no_grad():
        want = tmodel(d0, d1, c0, c1)[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    jm = JMatcher(JOptions(dim=dim, num_layers=2, num_heads=heads, input_dim=dim, mixed_precision=False),
                  params=convert_torch_state_dict(sd, JOptions(num_layers=2)))
    z_j = np.asarray(jm._fwd(jm.params, *(jnp.asarray(a) for a in inputs[:4]), None, None)[0])
    np.testing.assert_allclose(got, z_j, atol=2e-4, rtol=2e-4)


def test_load_torch_weights_drops_early_exit_heads_and_infers_options(tmp_path):
    sd = chip_smoke.glue_fixture(3, dim=64, num_layers=2, num_heads=2, input_dim=64)
    ckpt = {k: T(v) for k, v in sd.items()}
    ckpt["token_confidence.0.token.0.weight"] = torch.zeros(1, 64)
    ckpt["token_confidence.0.token.0.bias"] = torch.zeros(1)
    path = tmp_path / "lightglue.pth"
    torch.save(ckpt, str(path))
    loaded, opts = load_torch_weights(str(path))
    assert (opts.dim, opts.num_heads, opts.num_layers, opts.input_dim) == (64, 2, 2, 64)
    assert not any(k.startswith("token_confidence.") for k in loaded)
    LightGlueNet(opts).load_state_dict(loaded)  # strict


def _glue_matchers(num_layers, K, P, seed=0):
    """Both packages' matchers on the glue fixture (float32) and P pairs of
    the 12-camera descriptor feed at D=256."""
    sd = chip_smoke.glue_fixture(seed, num_layers=num_layers)
    jopts = JOptions(num_layers=num_layers, mixed_precision=False)
    jm = JMatcher(jopts, params=convert_torch_state_dict(sd, jopts))
    pm = LightGlueMatcher(LightGlueOptions(num_layers=num_layers, mixed_precision=False), state_dict=sd)
    pairs = chip_smoke.ring_pairs(12)
    gt = j_ring(pairs, 12)
    xy, mask, desc = chip_smoke.descriptor_feed(np.array(gt.R), np.array(gt.t), chip_smoke.FOCAL,
                                                chip_smoke.IMAGE_HW, K, dim=chip_smoke.GLUE_DESC_DIM,
                                                desc_sigma=chip_smoke.GLUE_SIGMA)
    i1, i2 = pairs[:P, 0], pairs[:P, 1]
    return jm, pm, (desc[i1], desc[i2], xy[i1], xy[i2], mask[i1], mask[i2])


def test_match_batch_matches_reference():
    jm, pm, args = _glue_matchers(num_layers=2, K=128, P=3)
    wh = (chip_smoke.IMAGE_HW[1], chip_smoke.IMAGE_HW[0])
    want = [np.asarray(a) for a in jm.match_batch(*(jnp.asarray(a) for a in args), image_size=wh)]
    got = [a.numpy() for a in pm.match_batch(*(T(a) for a in args), image_size=wh)]
    assert got[0].dtype == np.int32 and got[1].dtype == bool and got[2].dtype == np.float32
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2][want[1]], want[2][want[1]], rtol=1e-4)
    assert want[1].sum(1).min() > 5

    # the postprocess alone, on one log-assignment with ties and masks
    rng = np.random.default_rng(5)
    z = rng.normal(size=(2, 33, 41)).astype(np.float32)
    z[:, 3, 7] = z[:, 4, 7] = 9.0  # a column tie: the first row wins
    m0, m1 = rng.random((2, 32)) > 0.2, rng.random((2, 40)) > 0.2
    m0[:, 3:5], m1[:, 7] = True, True
    want = [np.asarray(a) for a in jax.vmap(jm._postprocess)(jnp.asarray(z), jnp.asarray(m0), jnp.asarray(m1))]
    got = [a.numpy() for a in pm._postprocess(T(z), T(m0), T(m1))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)  # exp of the same max, float32
    assert got[1][:, 3].all() and not got[1][:, 4].any()  # the column tie goes to the first row


def test_build_matcher(tmp_path):
    assert build_matcher(None) is None
    assert build_matcher({"name": "mutual_nn"}) is None
    m = build_matcher({"name": "lightglue", "descriptor_dim": 128, "num_layers": 1})
    assert isinstance(m, LightGlueMatcher) and m.options.input_dim == 128 and m.options.num_layers == 1
    path = tmp_path / "lg.pth"
    torch.save({k: T(v) for k, v in chip_smoke.glue_fixture(1, dim=64, num_layers=2, num_heads=2,
                                                             input_dim=64).items()}, str(path))
    m = build_matcher({"name": "lightglue", "weights_path": str(path)})
    assert (m.options.dim, m.options.num_heads, m.options.num_layers) == (64, 2, 2)
    with pytest.raises(ValueError):
        build_matcher({"name": "superglue"})


def _scalars(groups):
    return {(g.name, m.name): m.scalar for g in groups for m in g.metrics if m.dist is None}


@threads(4)
def test_lightglue_slice_matches_reference_end_to_end():
    N, K, L = 12, 256, 2
    H, W = chip_smoke.IMAGE_HW
    pairs = chip_smoke.ring_pairs(N)
    gt = j_ring(pairs, N)
    R, t = np.array(gt.R), np.array(gt.t)
    feed = chip_smoke.descriptor_feed(R, t, chip_smoke.FOCAL, chip_smoke.IMAGE_HW, K,
                                      dim=chip_smoke.GLUE_DESC_DIM, desc_sigma=chip_smoke.GLUE_SIGMA)
    sd = chip_smoke.glue_fixture(0, num_layers=L)

    # reference
    jopts = JOptions(num_layers=L, mixed_precision=False)
    cal_j = JCal.create(jnp.full(N, chip_smoke.FOCAL), jnp.zeros(N), jnp.zeros(N),
                        jnp.full(N, W / 2.0), jnp.full(N, H / 2.0))
    so_j = JSceneOptimizer(
        JSO(use_mesh=False, save_colmap=False, reconnect_bridges=False),
        retriever=chip_smoke.FixedPairs(pairs), detector=chip_smoke.FeedDetector(*feed),
        matcher=JMatcher(jopts, params=convert_torch_state_dict(sd, jopts)),
    )
    two_view_j = {}
    run_two_view = so_j._run_two_view

    def recording(*args, **kwargs):
        out = run_two_view(*args, **kwargs)
        two_view_j.update(out)
        return out

    so_j._run_two_view = recording
    data_j, groups_j = so_j.run(JLoader(gt, cal=cal_j, image_size=chip_smoke.IMAGE_HW))

    # port
    cal_t = Cal3Bundler.create(torch.full((N,), chip_smoke.FOCAL), torch.zeros(N), torch.zeros(N),
                               torch.full((N,), W / 2.0), torch.full((N,), H / 2.0))
    so_t = SceneOptimizer(SceneOptimizerOptions(device="cpu"), retriever=chip_smoke.FixedPairs(pairs),
                          detector=chip_smoke.FeedDetector(*feed),
                          matcher=LightGlueMatcher(LightGlueOptions(num_layers=L, mixed_precision=False),
                                                   state_dict=sd))
    before = fa.launch_count
    data_t, groups_t = so_t.run(SyntheticSceneLoader(convert.se3({"R": R, "t": t}), cal=cal_t,
                                                     image_size=chip_smoke.IMAGE_HW))
    assert fa.launch_count == before  # CPU tensors: the plain attention

    matches_t = {m.name: m.dist for g in groups_t for m in g.metrics}["num_matches_per_pair"]
    np.testing.assert_array_equal(matches_t, two_view_j["num_matches"])
    assert matches_t.min() > 15
    assert int(np.asarray(data_j.pose_mask).sum()) == N
    assert data_t.number_images() == N
    auc_j = _scalars(groups_j)[("ba_pose_metrics", "pose_auc_@5.0_deg")]
    auc_t = _scalars(groups_t)[("ba_pose_metrics", "pose_auc_@5.0_deg")]
    assert auc_t >= auc_j - 0.02, (auc_t, auc_j)
    assert bool(torch.isfinite(data_t.points[data_t.track_mask]).all())
