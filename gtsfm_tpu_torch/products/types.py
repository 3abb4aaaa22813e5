"""Pipeline product types: the visibility graph and the cluster tree.

Port of gtsfm_tpu/products/types.py (``make_visibility_graph``,
``graph_keys``, ``ClusterTree``): host numpy, a copy, so that the port does
not import the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# VisibilityGraph: (E, 2) int array of (i, j) pairs with i < j.
VisibilityGraph = np.ndarray


def make_visibility_graph(pairs: Sequence[Tuple[int, int]]) -> VisibilityGraph:
    """Canonicalize pairs to i < j, dedup, sort."""
    canon = {(min(i, j), max(i, j)) for i, j in pairs if i != j}
    return np.array(sorted(canon), np.int32).reshape(-1, 2)


def graph_keys(graph: VisibilityGraph) -> np.ndarray:
    """Unique node ids appearing in the graph."""
    return np.unique(np.asarray(graph).reshape(-1))


@dataclasses.dataclass
class ClusterTree:
    """Hierarchical scene decomposition: each node holds the visibility
    sub-graph of edges *local* to it (not in any child); children partition
    deeper."""

    value: VisibilityGraph
    children: List["ClusterTree"] = dataclasses.field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def local_keys(self) -> np.ndarray:
        return graph_keys(self.value)

    def all_edges(self) -> VisibilityGraph:
        edges = [np.asarray(e).reshape(-1, 2) for e in [self.value] + [c.all_edges() for c in self.children]]
        edges = [e for e in edges if len(e)]
        if not edges:
            return np.zeros((0, 2), np.int32)
        return make_visibility_graph([tuple(e) for e in np.concatenate(edges, axis=0)])

    def all_keys(self) -> np.ndarray:
        return graph_keys(self.all_edges())

    def leaves(self) -> List["ClusterTree"]:
        if self.is_leaf:
            return [self]
        return [leaf for c in self.children for leaf in c.leaves()]

    def num_nodes(self) -> int:
        return 1 + sum(c.num_nodes() for c in self.children)

    def map_postorder(self, fn):
        """Bottom-up fold: fn(node, child_results) -> result."""
        return fn(self, [c.map_postorder(fn) for c in self.children])


@dataclasses.dataclass(frozen=True)
class OneViewData:
    """Frozen per-view record: the view's index, file name, intrinsics,
    absolute pose prior and ground-truth camera and pose."""

    index: int
    fname: Optional[str] = None
    intrinsics: Optional[object] = None
    absolute_pose_prior: Optional[object] = None
    gt_camera: Optional[object] = None
    gt_pose: Optional[object] = None
