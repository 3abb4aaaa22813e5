"""Graph partitioners: scene decomposition into a cluster tree.

Port of gtsfm_tpu/partitioner/partitioners.py: ``SinglePartitioner``,
``BinaryTreePartitioner`` (recursive balanced spectral splits),
``metis_bisect`` (the native multilevel bisection of the port's copy of
``native/metis.cpp``) and ``MetisPartitioner`` (recursive METIS-class
bisection). Host numpy and scipy, as in the reference; the edge routing is
vectorized. Edges cut by a split become the parent's local edges, which is
what the hierarchical Sim3 merge consumes.

``MetisPartitioner`` falls back to the spectral splitter when the native
library cannot be built, as the reference does; ``MetisPartitioner.ran``
names the partitioner of the last run (``"metis"`` or ``"spectral"``) so
that the fallback shows in the metrics.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import scipy.sparse
import scipy.sparse.linalg

from gtsfm_tpu_torch.products.types import ClusterTree, VisibilityGraph


class SinglePartitioner:
    """Whole graph = one leaf."""

    def run(self, graph: VisibilityGraph) -> ClusterTree:
        return ClusterTree(value=np.asarray(graph, np.int32).reshape(-1, 2))


def _fiedler_split(nodes: np.ndarray, edges: np.ndarray, weights: np.ndarray):
    """2-way balanced spectral split of the subgraph on ``nodes``.

    Returns (mask_a over nodes, ok); ok is False when the graph is too small
    or the eigensolve fails (the caller then does not split)."""
    n = len(nodes)
    if n < 4:
        return None, False
    r = np.searchsorted(nodes, edges[:, 0])
    c = np.searchsorted(nodes, edges[:, 1])
    w = np.asarray(weights, np.float64)
    A = scipy.sparse.coo_matrix((np.concatenate([w, w]), (np.concatenate([r, c]), np.concatenate([c, r]))),
                                shape=(n, n)).tocsr()
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    L = scipy.sparse.diags(d) - A
    try:
        # smallest two eigenpairs; Fiedler = second
        vals, vecs = scipy.sparse.linalg.eigsh(L, k=2, sigma=-1e-6, which="LM")
        fiedler = vecs[:, np.argsort(vals)[1]]
    except (ArithmeticError, RuntimeError, ValueError):  # ArpackError is a RuntimeError
        return None, False
    order = np.argsort(fiedler)
    mask = np.zeros(n, bool)
    mask[order[: n // 2]] = True  # balanced split at the median
    return mask, True


def _route(edges: np.ndarray, nodes: np.ndarray, side_a: np.ndarray):
    """(in_a, in_b, cut) edge masks for the node split ``side_a`` (bool
    over the sorted ``nodes``)."""
    a0 = side_a[np.searchsorted(nodes, edges[:, 0])]
    a1 = side_a[np.searchsorted(nodes, edges[:, 1])]
    in_a = a0 & a1
    in_b = ~a0 & ~a1
    return in_a, in_b, ~(in_a | in_b)


class BinaryTreePartitioner:
    """Recursive balanced 2-way spectral splits. Stops when a cluster has
    <= max_cluster_size cameras or the depth is reached. Cut edges live at
    the parent (the merge overlap)."""

    def __init__(self, max_depth: int = 4, max_cluster_size: int = 40):
        self.max_depth = max_depth
        self.max_cluster_size = max_cluster_size

    def run(self, graph: VisibilityGraph, edge_weights: Optional[np.ndarray] = None) -> ClusterTree:
        edges = np.asarray(graph, np.int32).reshape(-1, 2)
        if edge_weights is None:
            edge_weights = np.ones(len(edges), np.float64)
        return self._split(edges, np.asarray(edge_weights, np.float64), depth=0)

    def _split(self, edges: np.ndarray, weights: np.ndarray, depth: int) -> ClusterTree:
        nodes = np.unique(edges.reshape(-1))
        if depth >= self.max_depth or len(nodes) <= self.max_cluster_size or len(edges) < 4:
            return ClusterTree(value=edges)
        mask, ok = _fiedler_split(nodes, edges, weights)
        if not ok:
            return ClusterTree(value=edges)
        in_a, in_b, cut = _route(edges, nodes, mask)
        if in_a.sum() < 2 or in_b.sum() < 2:
            return ClusterTree(value=edges)
        return ClusterTree(value=edges[cut], children=[
            self._split(edges[in_a], weights[in_a], depth + 1),
            self._split(edges[in_b], weights[in_b], depth + 1),
        ])


# ---- native multilevel (METIS-class) partitioner ---------------------------

_METIS_LIB = None


def _load_metis():
    """ctypes binding of the port's libmetis_lite.so, built on first use.
    Raises OSError when it cannot be built or loaded."""
    global _METIS_LIB
    if _METIS_LIB is None:
        from gtsfm_tpu_torch.native.build import ensure_built

        so = ensure_built("libmetis_lite.so")
        if so is None:
            raise OSError("libmetis_lite.so missing and no C++ toolchain to build it")
        lib = ctypes.CDLL(so)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.metis_bisect.argtypes = [i64p, i64p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_double, ctypes.POINTER(ctypes.c_int8)]
        lib.metis_bisect.restype = None
        _METIS_LIB = lib
    return _METIS_LIB


def metis_bisect(num_nodes: int, edges: np.ndarray, weights: Optional[np.ndarray] = None,
                 balance_tol: float = 0.1) -> np.ndarray:
    """Balanced 2-way cut of an undirected graph on nodes 0..num_nodes-1
    through the native multilevel partitioner (heavy-edge-matching
    coarsening, greedy growing, FM refinement). Returns int8[num_nodes] side
    labels (0/1). Deterministic."""
    lib = _load_metis()
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    if len(edges) and (edges.min() < 0 or edges.max() >= num_nodes):
        raise ValueError(f"edge endpoints must lie in [0, {num_nodes})")
    u = np.ascontiguousarray(edges[:, 0])
    v = np.ascontiguousarray(edges[:, 1])
    if weights is None:
        wp = ctypes.POINTER(ctypes.c_double)()
    else:
        weights = np.ascontiguousarray(np.asarray(weights, np.float64))
        if weights.shape != (len(edges),):
            raise ValueError("one weight per edge")
        wp = weights.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    out = np.zeros(num_nodes, np.int8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.metis_bisect(u.ctypes.data_as(i64p), v.ctypes.data_as(i64p), wp, ctypes.c_int64(len(edges)),
                     ctypes.c_int64(num_nodes), ctypes.c_double(balance_tol),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out


class MetisPartitioner:
    """Recursive multilevel bisection into a cluster tree: cut edges become
    the parent's local edges (the merge overlap). Falls back to spectral
    splits if the native library is unavailable; ``ran`` records which
    partitioner built the last tree."""

    def __init__(self, max_depth: int = 6, max_cluster_size: int = 40, balance_tol: float = 0.1):
        self.max_depth = max_depth
        self.max_cluster_size = max_cluster_size
        self.balance_tol = balance_tol
        self.ran: Optional[str] = None

    def run(self, graph: VisibilityGraph, edge_weights: Optional[np.ndarray] = None) -> ClusterTree:
        edges = np.asarray(graph, np.int32).reshape(-1, 2)
        if edge_weights is None:
            edge_weights = np.ones(len(edges), np.float64)
        try:
            _load_metis()
        except OSError:
            self.ran = "spectral"
            return BinaryTreePartitioner(self.max_depth, self.max_cluster_size).run(graph, edge_weights)
        self.ran = "metis"
        return self._split(edges, np.asarray(edge_weights, np.float64), depth=0)

    def _split(self, edges: np.ndarray, weights: np.ndarray, depth: int) -> ClusterTree:
        nodes = np.unique(edges.reshape(-1))
        if depth >= self.max_depth or len(nodes) <= self.max_cluster_size or len(edges) < 4:
            return ClusterTree(value=edges)
        local = np.searchsorted(nodes, edges).astype(np.int64)
        side = metis_bisect(len(nodes), local, weights, self.balance_tol)
        in_a, in_b, cut = _route(edges, nodes, side == 0)
        if in_a.sum() < 2 or in_b.sum() < 2:
            return ClusterTree(value=edges)
        return ClusterTree(value=edges[cut], children=[
            self._split(edges[in_a], weights[in_a], depth + 1),
            self._split(edges[in_b], weights[in_b], depth + 1),
        ])
