"""View-graph bridge reconnection.

Port of gtsfm_tpu/retriever/bridge.py (host numpy, unchanged): when the
valid two-view graph splits into several connected components, the
highest-similarity cross-component pairs become bridge pairs, so that the
scene stays one reconstruction.
"""

from __future__ import annotations

import numpy as np

from gtsfm_tpu_torch.utils.graph import connected_components


def find_bridge_pairs(
    num_images: int,
    valid_pairs: np.ndarray,  # (E, 2) pairs that passed verification
    similarity_matrix: np.ndarray,  # (N, N)
    max_bridges_per_component_pair: int = 2,
    min_score: float = 0.0,
) -> np.ndarray:
    """-> (B, 2) new cross-component pairs to run through two-view
    estimation (highest similarity first)."""
    valid_pairs = np.asarray(valid_pairs).reshape(-1, 2)
    if len(valid_pairs) == 0:
        return np.zeros((0, 2), np.int32)
    labels = connected_components(num_images, valid_pairs)
    in_graph = np.zeros(num_images, bool)
    in_graph[valid_pairs.reshape(-1)] = True
    comp_ids = np.unique(labels[in_graph])
    if len(comp_ids) <= 1:
        return np.zeros((0, 2), np.int32)

    bridges = []
    for a_i in range(len(comp_ids)):
        for b_i in range(a_i + 1, len(comp_ids)):
            nodes_a = np.nonzero(in_graph & (labels == comp_ids[a_i]))[0]
            nodes_b = np.nonzero(in_graph & (labels == comp_ids[b_i]))[0]
            sub = similarity_matrix[np.ix_(nodes_a, nodes_b)]
            flat = np.argsort(-sub.reshape(-1))[:max_bridges_per_component_pair]
            for f in flat:
                i = nodes_a[f // len(nodes_b)]
                j = nodes_b[f % len(nodes_b)]
                if sub.reshape(-1)[f] >= min_score:
                    bridges.append((min(i, j), max(i, j)))
    return np.asarray(sorted(set(bridges)), np.int32).reshape(-1, 2)
