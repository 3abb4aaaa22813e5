"""Retrieval quality metrics.

Port of gtsfm_tpu/evaluation/retrieval_metrics.py: per retrieved pair, the
similarity score and the GT relative rotation angle, and how well the
scores follow viewpoint proximity; and the merge of same-named metrics
over several groups (runs or clusters). Host numpy, with the angle through
the port's ``so3.angle_rad``.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch.evaluation.metrics import Metric, MetricsGroup
from gtsfm_tpu_torch.geometry import SE3, so3


def retrieval_metrics(pairs: np.ndarray, similarity_matrix: np.ndarray, gt_poses: SE3) -> MetricsGroup:
    """Per retrieved pair: the similarity score and the GT relative
    rotation angle (degrees); with more than two pairs, the correlation of
    the scores with minus the angles."""
    R = gt_poses.R.cpu().numpy()
    i1, i2 = pairs[:, 0], pairs[:, 1]
    rel = np.einsum("eji,ejk->eik", R[i2], R[i1])
    angles = so3.angle_rad(torch.as_tensor(rel)).numpy() * 180 / np.pi
    scores = similarity_matrix[i1, i2]
    g = MetricsGroup("retrieval_metrics")
    g.add(Metric("num_retrieved_pairs", len(pairs)))
    g.add(Metric("similarity_scores", scores))
    g.add(Metric("gt_relative_rotation_deg", angles))
    if len(scores) > 2:
        g.add(Metric("score_vs_proximity_correlation", float(np.corrcoef(scores, -angles)[0, 1])))
    return g


def merge_metrics_groups(groups: list, name: str) -> MetricsGroup:
    """One group named ``name``: each metric's distributions concatenated
    over the groups, or, for scalars, their mean."""
    merged = MetricsGroup(name)
    by_metric: dict = {}
    for g in groups:
        for m in g.metrics:
            by_metric.setdefault(m.name, []).append(m)
    for mname, ms in by_metric.items():
        dists = [m.dist for m in ms if m.dist is not None]
        if dists:
            merged.add(Metric(mname, np.concatenate(dists)))
        else:
            merged.add(Metric(mname, float(np.mean([m.scalar for m in ms if m.scalar is not None]))))
    return merged
