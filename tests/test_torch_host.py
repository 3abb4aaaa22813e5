"""The port's own copies of the reference's host modules, and its device
default.

The port carries copies of tracks/dsf.py, utils/graph.py,
view_graph/cycle_consistency.py and the g++-built native libraries, so it
imports nothing of the JAX package. Here each copy runs against the
reference module on the same seeded inputs and must give identical results;
the copies' native libraries build into build/torch_native/, outside the
reference package. Also here: the entry points run on the card by default
and raise, rather than run on the CPU, when there is none.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from gtsfm_tpu.tracks import dsf as j_dsf
from gtsfm_tpu.utils import graph as j_graph
from gtsfm_tpu.view_graph import cycle_consistency as j_cc
from gtsfm_tpu_torch.native import build as native_build
from gtsfm_tpu_torch.tracks import dsf
from gtsfm_tpu_torch.utils import graph
from gtsfm_tpu_torch.view_graph import cycle_consistency as cc
from tests.torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_graph(n=20, extra=25, seed=0):
    rng = np.random.default_rng(seed)
    edges = {(i, i + 1) for i in range(0, n // 2 - 1)} | {(i, i + 1) for i in range(n // 2, n - 2)}
    while len(edges) < n + extra:
        a, b = sorted(rng.choice(n, 2, replace=False))
        if a < n // 2 <= b:  # keep two components plus an isolated node
            continue
        edges.add((int(a), int(b)))
    return np.asarray(sorted(edges), np.int64)


def test_graph_utilities_match_reference():
    edges = _random_graph()
    n = 21
    np.testing.assert_array_equal(graph.connected_components(n, edges), j_graph.connected_components(n, edges))
    np.testing.assert_array_equal(graph.largest_connected_component(n, edges),
                                  j_graph.largest_connected_component(n, edges))
    np.testing.assert_array_equal(graph.extract_triplets(edges), j_graph.extract_triplets(edges))
    assert graph.edge_index_map(edges) == j_graph.edge_index_map(edges)
    assert graph.largest_connected_component(n, edges[:0]).sum() == 0


def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


@pytest.mark.parametrize("aggregation", ["MIN", "MEDIAN"])
def test_cycle_consistency_matches_reference(aggregation):
    edges = _random_graph(seed=1)
    wRi = _rotations(21, seed=2)
    rel = np.einsum("eji,ejk->eik", wRi[edges[:, 1]], wRi[edges[:, 0]])  # i2Ri1 = wRi2^T wRi1
    rng = np.random.default_rng(3)
    bad = rng.random(len(edges)) < 0.15  # outlier edges: a random rotation
    rel[bad] = _rotations(int(bad.sum()), seed=4)
    i2Ri1 = (rel + rng.normal(0, 0.01, rel.shape)).astype(np.float32)
    mask = rng.random(len(edges)) < 0.9
    opts = dict(max_cycle_error_deg=7.0)
    got = cc.CycleConsistencyFilter(cc.ViewGraphOptions(aggregation=cc.EdgeErrorAggregation[aggregation], **opts))
    want = j_cc.CycleConsistencyFilter(
        j_cc.ViewGraphOptions(aggregation=j_cc.EdgeErrorAggregation[aggregation], **opts))
    m_t, e_t = got.run(edges, i2Ri1, mask)
    m_j, e_j = want.run(edges, i2Ri1, mask)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(e_t, e_j)
    assert 0 < m_t.sum() < mask.sum()
    tri = graph.extract_triplets(edges)
    np.testing.assert_array_equal(cc.cycle_errors(edges, i2Ri1, tri), j_cc.cycle_errors(edges, i2Ri1, tri))


@pytest.mark.parametrize("native", [True, False])
def test_dsf_tracks_match_reference(native, monkeypatch):
    """tracks_from_matches on seeded matches over a 12-camera ring, through
    the native union-find and through the numpy fallback in both packages."""
    n, K = 12, 64
    pairs = chip_smoke.ring_pairs(n)
    rng = np.random.default_rng(5)
    kp_xy = rng.uniform(0, 300, (n, K, 2)).astype(np.float32)
    M = 48
    corr_i1 = np.stack([rng.permutation(K)[:M] for _ in pairs]).astype(np.int32)
    corr_i2 = np.where(rng.random((len(pairs), M)) < 0.97, corr_i1, rng.integers(0, K, (len(pairs), M))).astype(np.int32)
    corr_mask = rng.random((len(pairs), M)) < 0.85
    if not native:  # both packages on their numpy union-find
        monkeypatch.setattr(dsf, "_LIB", False)
        monkeypatch.setattr(j_dsf, "_LIB", False)
    else:
        assert dsf._native_lib(), "the port's libdsf.so did not build"
    got = dsf.tracks_from_matches(pairs, corr_i1, corr_i2, corr_mask, kp_xy, min_track_len=2, max_track_len=6)
    want = j_dsf.tracks_from_matches(pairs, corr_i1, corr_i2, corr_mask, kp_xy, min_track_len=2, max_track_len=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[3].any(axis=1).sum() > 10


def test_native_libraries_build_outside_the_reference_package():
    ref_native = os.path.join(REPO, "gtsfm_tpu", "native")
    for name in ("libdsf.so", "libmfas.so", "libmetis_lite.so"):
        path = native_build.ensure_built(name)
        assert path is not None and os.path.exists(path), name
        assert os.path.dirname(path) == native_build.BUILD_DIR == os.path.join(REPO, "build", "torch_native")
        assert not os.path.commonpath([path, ref_native]) == ref_native
    from gtsfm_tpu_torch.averaging.translation import averaging

    assert averaging._native_mfas(), "the port's libmfas.so did not load"


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions
    from gtsfm_tpu_torch.splat.gaussian_splatting import GaussianSplatting
    from gtsfm_tpu_torch.utils.numerics import resolve_device

    assert SceneOptimizerOptions().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stub = dict(retriever=chip_smoke.FixedPairs(np.zeros((0, 2))), detector=object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SceneOptimizer(SceneOptimizerOptions(), **stub)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GaussianSplatting()
    assert SceneOptimizer(SceneOptimizerOptions(device="cpu"), **stub).device == torch.device("cpu")
    assert GaussianSplatting(device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")


def _feedforward_entry(name):
    """(constructor taking ``device=``, the module its parameters live in)
    for each feed-forward, VGGT and PatchmatchNet entry point, at reduced
    widths."""
    from gtsfm_tpu_torch.densify import patchmatchnet
    from gtsfm_tpu_torch.frontend.feedforward import FeedforwardOptions, FeedforwardReconstruction
    from gtsfm_tpu_torch.frontend.vggt import VGGTModel, VGGTOptions
    from gtsfm_tpu_torch.scene import cluster_feedforward as cf

    small = FeedforwardOptions(dim=64, depth=1, num_heads=2)
    return {
        "ClusterFeedforward": (lambda **kw: cf.ClusterFeedforward(**kw), None),
        "ClusterFastFeedforward": (lambda **kw: cf.ClusterFastFeedforward(**kw), None),
        "FeedforwardReconstruction": (lambda **kw: FeedforwardReconstruction(small, example_hw=(32, 32), **kw),
                                      lambda m: m.net),
        "VGGTModel": (lambda **kw: VGGTModel(VGGTOptions(**cf.REDUCED_VGGT), **kw), lambda m: m.net),
        "build_net": (lambda **kw: patchmatchnet.build_net(chip_smoke.pmnet_fixture(0), **kw), lambda m: m),
        "_resolve_model": (lambda **kw: cf._resolve_model(cf.ClusterFeedforwardOptions(model=small), (32, 32), **kw),
                           lambda m: m.net),
    }[name]


@pytest.mark.parametrize("name", ["ClusterFeedforward", "ClusterFastFeedforward", "FeedforwardReconstruction",
                                  "VGGTModel", "build_net", "_resolve_model"])
def test_feedforward_vggt_and_patchmatchnet_default_to_the_card(name, monkeypatch):
    from gtsfm_tpu_torch.scene import cluster_feedforward as cf

    make, module = _feedforward_entry(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cf, "_MODEL_CACHE", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    built = make(device="cpu")
    if module is None:
        assert built.device == torch.device("cpu")
    else:
        devices = {p.device for p in module(built).parameters()}
        assert devices == {torch.device("cpu")}
