"""Graph utilities: connected components, triplet extraction, pruning.

The port's copy of gtsfm_tpu/utils/graph.py, unchanged in arithmetic.

Parity: GTSfM's gtsfm/utils/graph.py (largest-CC pruning :50,
triplet extraction :114). Host-side numpy — these are O(E) index
manipulations feeding device stages.
"""

from __future__ import annotations

import numpy as np


def connected_components(num_nodes: int, edges: np.ndarray) -> np.ndarray:
    """Label per node (-1 for isolated... no: own label). edges (E, 2)."""
    parent = np.arange(num_nodes)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in np.asarray(edges):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    return np.array([find(i) for i in range(num_nodes)])


def largest_connected_component(num_nodes: int, edges: np.ndarray) -> np.ndarray:
    """Bool mask of nodes in the largest CC (by node count, only counting
    nodes that appear in edges). Parity: prune_to_largest_connected_component."""
    edges = np.asarray(edges)
    if len(edges) == 0:
        return np.zeros(num_nodes, bool)
    labels = connected_components(num_nodes, edges)
    in_graph = np.zeros(num_nodes, bool)
    in_graph[edges.reshape(-1)] = True
    counts = np.bincount(labels[in_graph], minlength=num_nodes)
    best = np.argmax(counts)
    return (labels == best) & in_graph


def extract_triplets(edges: np.ndarray) -> np.ndarray:
    """All triangles (i < j < k with all three edges present) -> (T, 3).

    Parity: utils/graph.py:114. Vectorized via adjacency-set intersection.
    """
    edges = np.asarray(edges)
    if len(edges) == 0:
        return np.zeros((0, 3), np.int64)
    n = int(edges.max()) + 1
    adj = [set() for _ in range(n)]
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    triplets = []
    for a, b in edges:
        i, j = (a, b) if a < b else (b, a)
        for k in adj[i] & adj[j]:
            if k > j:
                triplets.append((i, j, k))
    return np.array(sorted(set(triplets)), np.int64).reshape(-1, 3)


def edge_index_map(edges: np.ndarray) -> dict:
    """{(i, j): edge_idx} with i < j."""
    return {(int(min(a, b)), int(max(a, b))): e for e, (a, b) in enumerate(np.asarray(edges))}
