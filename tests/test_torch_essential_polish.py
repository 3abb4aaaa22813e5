"""The essential polish's dispatch and constants on the CPU.

- The constants that ``_constant`` builds once per device and dtype give
  ``_tangent_basis``, ``_perturb``, ``recover_pose_from_essential`` and
  ``_project_essential`` the bits that building them anew at each call
  gave.
- ``_refine_essential`` on a CPU tensor runs the loop eagerly, captures
  nothing, and equals the benchmark's frozen plain reference bit for bit.
- The graph cache's key and its least-recently-used bound, with the
  capture replaced by a stub (the capture itself needs a card:
  tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from gtsfm_tpu_torch.frontend.verifiers import essential
from gtsfm_tpu_torch.geometry import so3
from perfbench.reference import verifier as reference
from tests.torch_threads import cap_threads

cap_threads()


def _batch(P: int, K: int, seed: int):
    """Noisy correspondences of P random relative poses, a fifth of them
    outliers, a ragged inlier weight, the start pose a perturbed truth and
    the pairs' thresholds: the polish's inputs (x1, x2, w, R0, t0, thresh)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (P, K, 3))
    R = so3.expmap(torch.as_tensor(rng.normal(size=(P, 3)) * 0.15, dtype=torch.float32))
    t = torch.as_tensor(np.array([1.0, 0.1, 0.2]) + 0.1 * rng.normal(size=(P, 3)), dtype=torch.float32)
    p1 = torch.as_tensor(pts, dtype=torch.float32)
    p2 = torch.einsum("pij,pkj->pki", R, p1) + t[:, None]
    x1 = p1[..., :2] / p1[..., 2:] + torch.as_tensor(rng.normal(0, 1e-3, (P, K, 2)), dtype=torch.float32)
    x2 = p2[..., :2] / p2[..., 2:] + torch.as_tensor(rng.normal(0, 1e-3, (P, K, 2)), dtype=torch.float32)
    out = torch.as_tensor(rng.random((P, K)) < 0.2)
    x2 = torch.where(out[..., None], torch.as_tensor(rng.uniform(-0.5, 0.5, (P, K, 2)), dtype=torch.float32), x2)
    w = (torch.as_tensor(rng.random((P, K)) > 0.1) & ~out).float()
    R0 = R @ so3.expmap(torch.as_tensor(rng.normal(size=(P, 3)) * 0.02, dtype=torch.float32))
    t0 = t + torch.as_tensor(rng.normal(size=(P, 3)) * 0.05, dtype=torch.float32)
    t0 = t0 / torch.linalg.vector_norm(t0, dim=-1, keepdim=True)
    return x1, x2, w, R0, t0, torch.full((P,), 4.0 / 600)


def _fresh(values, like):
    """The old construction: a new tensor from host values at every call."""
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _run(name, batch):
    x1, x2, w, R0, t0, _ = batch
    E = so3.hat(t0) @ R0
    params = torch.as_tensor(np.random.default_rng(1).normal(size=(x1.shape[0], 5)) * 0.01, dtype=torch.float32)
    if name == "tangent_basis":
        return (essential._tangent_basis(t0),)
    if name == "perturb":
        return essential._perturb(params, R0, t0)
    if name == "recover_pose":
        return essential.recover_pose_from_essential(E, x1, x2, w)
    return (essential._project_essential(E + 0.01),)


@pytest.mark.parametrize("name", ["tangent_basis", "perturb", "recover_pose", "project_essential"])
def test_cached_constants_give_the_bits_of_the_old_construction(name, monkeypatch):
    batch = _batch(6, 64, 0)
    cached = _run(name, batch)
    n_constants = len(essential._CONSTANTS)
    again = _run(name, batch)
    assert len(essential._CONSTANTS) == n_constants  # the second call built none
    monkeypatch.setattr(essential, "_constant", _fresh)
    old = _run(name, batch)
    for a, b, c in zip(cached, again, old):
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.parametrize("iters", [8, 6])
def test_refine_on_the_cpu_runs_eagerly_and_equals_the_reference(iters):
    batch = _batch(5, 300, 2)
    captures, replays, eager = (essential.POLISH_GRAPH_CAPTURES, essential.POLISH_GRAPH_REPLAYS,
                                essential.POLISH_EAGER_CALLS)
    R, t = essential._refine_essential(*batch[:5], iters, 2.0, batch[5])
    assert essential.POLISH_EAGER_CALLS == eager + 1
    assert (essential.POLISH_GRAPH_CAPTURES, essential.POLISH_GRAPH_REPLAYS) == (captures, replays)
    R_ref, t_ref = reference._refine(*batch[:5], iters, 2.0, batch[5])
    assert torch.equal(R, R_ref) and torch.equal(t, t_ref)
    assert not torch.equal(R, batch[3])  # the loop moved the pose


def test_polish_key_tells_apart_what_a_captured_loop_depends_on():
    x1, x2, w, R0, t0, thresh = _batch(4, 32, 3)
    args = (x1, x2, w, R0, t0, thresh)
    key = essential._polish_key(args, 8, 2.0)
    assert essential._polish_key(tuple(a + 1 for a in args), 8, 2.0) == key  # values are not part of it
    others = [
        essential._polish_key(tuple(a[:3] for a in args), 8, 2.0),  # P
        essential._polish_key((x1[:, :16], x2[:, :16], w[:, :16], R0, t0, thresh), 8, 2.0),  # K
        essential._polish_key(args, 6, 2.0),
        essential._polish_key(args, 8, 3.0),
        essential._polish_key(tuple(a.double() for a in args), 8, 2.0),
    ]
    assert len({key, *others}) == 1 + len(others)


def test_graph_cache_drops_the_least_recently_used_key():
    cache = essential._GraphCache(max_keys=2)
    built = []

    def build(key):
        return lambda: built.append(key) or f"graph {key}"

    assert cache.get("a", build("a")) == "graph a"
    assert cache.get("b", build("b")) == "graph b"
    assert cache.get("a", build("a")) == "graph a"  # a hit, and now the most recent
    assert cache.get("c", build("c")) == "graph c"  # drops b
    assert list(cache.entries) == ["a", "c"]
    assert cache.get("b", build("b")) == "graph b"  # built again; drops a
    assert built == ["a", "b", "c", "b"] and list(cache.entries) == ["c", "b"]
