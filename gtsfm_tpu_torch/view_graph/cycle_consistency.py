"""View-graph estimation via rotation cycle consistency.

The port's copy of gtsfm_tpu/view_graph/cycle_consistency.py, unchanged in
arithmetic.

Parity: GTSfM's gtsfm/view_graph_estimator/cycle_consistent_rotation_estimator.py
(CycleConsistentRotationViewGraphEstimator: compose i2Ri1 around all
3-cycles, aggregate per-edge cycle error with MIN or MEDIAN, reject edges
with error > 7 deg; run twice — MIN then MEDIAN — per
multi_view_optimizer.py:82-84,130-164).

Runs entirely on the HOST: triplets are sparse set math, and the 3x3
cycle compositions are a few thousand tiny matmuls, cheaper in numpy than
as a string of small device launches.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np

from gtsfm_tpu_torch.utils.graph import edge_index_map, extract_triplets


class EdgeErrorAggregation(enum.Enum):
    MIN = 0
    MEDIAN = 1


class ViewGraphOptions(NamedTuple):
    max_cycle_error_deg: float = 7.0  # cycle_consistent_rotation_estimator.py:29
    aggregation: EdgeErrorAggregation = EdgeErrorAggregation.MIN


def cycle_errors(
    edges: np.ndarray, i2Ri1: np.ndarray, triplets: np.ndarray
) -> np.ndarray:
    """Angle (deg) of the composed rotation around each triplet (T,).

    For triplet (i, j, k) with i<j<k: error = angle( kRi^T * kRj * jRi )
    where xRy denotes the relative rotation mapping frame y to frame x.
    """
    if len(triplets) == 0:
        return np.zeros(0, np.float32)
    emap = edge_index_map(edges)
    e_ij = np.array([emap[(i, j)] for i, j, k in triplets])
    e_jk = np.array([emap[(j, k)] for i, j, k in triplets])
    e_ik = np.array([emap[(i, k)] for i, j, k in triplets])
    R = np.asarray(i2Ri1, np.float64)
    jRi = R[e_ij]  # edge (i, j) stores jRi
    kRj = R[e_jk]
    kRi = R[e_ik]
    comp = np.einsum("tij,tjk->tik", np.swapaxes(kRi, -1, -2), kRj)
    comp = np.einsum("tij,tjk->tik", comp, jRi)
    cos = (np.trace(comp, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))).astype(np.float32)


class CycleConsistencyFilter:
    """run(edges, i2Ri1, edge_mask) -> (new_edge_mask, per_edge_error_deg).

    Edges not in any triplet are REJECTED (the reference keeps only
    cycle-supported edges). Two-pass usage (MIN then MEDIAN) mirrors the
    reference's MVO wiring.
    """

    def __init__(self, options: ViewGraphOptions = ViewGraphOptions()):
        self.options = options

    def run(self, edges: np.ndarray, i2Ri1: np.ndarray, edge_mask=None):
        edges = np.asarray(edges)
        E = len(edges)
        if edge_mask is None:
            edge_mask = np.ones(E, bool)
        kept = np.nonzero(edge_mask)[0]
        sub_edges = edges[kept]
        triplets = extract_triplets(sub_edges)
        errors = np.full(E, np.inf, np.float32)
        if len(triplets) == 0:
            return np.zeros(E, bool), errors

        emap = edge_index_map(sub_edges)
        tri_err = cycle_errors(sub_edges, np.asarray(i2Ri1)[kept], triplets)

        per_edge: dict = {}
        for t_idx, (i, j, k) in enumerate(triplets):
            for key in [(i, j), (j, k), (i, k)]:
                per_edge.setdefault(key, []).append(tri_err[t_idx])

        agg = self.options.aggregation
        for key, errs in per_edge.items():
            e_global = kept[emap[key]]
            errors[e_global] = (
                np.min(errs) if agg == EdgeErrorAggregation.MIN else np.median(errs)
            )

        new_mask = edge_mask & (errors <= self.options.max_cycle_error_deg)
        return new_mask, errors
