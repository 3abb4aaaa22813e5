"""Compare two reconstructions.

Port of gtsfm_tpu/evaluation/compare.py, ``match_cameras_by_name`` and
``compare_reconstructions``: align the estimate onto the reference with a
robust Sim3 over the cameras matched by image name and report per-camera
errors, the relative pair errors with their pose AUC, the structure
difference and track statistics. The COLMAP-directory helpers and the
``output_dir`` artifacts wait for the port of ``io/colmap.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.evaluation.metrics import (
    Metric,
    MetricsGroup,
    pose_auc,
    relative_rotation_angular_errors,
    translation_direction_errors_deg,
)
from gtsfm_tpu_torch.geometry import so3
from gtsfm_tpu_torch.geometry.sim3 import align_poses_sim3_robust
from gtsfm_tpu_torch.utils.numerics import precise


def match_cameras_by_name(a: SfmData, b: SfmData):
    """-> (idx_a, idx_b) arrays of the registered cameras matched by image
    file name."""
    names_a = (a.meta.image_names if a.meta else None) or []
    names_b = (b.meta.image_names if b.meta else None) or []
    lut = {n: i for i, n in enumerate(names_b)}
    mask_a = a.pose_mask.cpu().numpy()
    mask_b = b.pose_mask.cpu().numpy()
    ia, ib = [], []
    for i, n in enumerate(names_a):
        j = lut.get(n)
        if j is not None and i < len(mask_a) and mask_a[i] and mask_b[j]:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def compare_reconstructions(est: SfmData, ref: SfmData) -> MetricsGroup:
    """Align ``est`` onto ``ref`` (robust Sim3 over the matched cameras) and
    report:

    - absolute per-camera rotation angle, translation distance and
      translation direction-angle errors after the alignment;
    - relative rotation and translation-direction errors over all matched
      camera pairs, and the pose AUC @ 1/2.5/5/10/20 deg of their maximum;
    - the nearest-reference-point distances of the estimated landmarks after
      the same Sim3, also relative to the reference's extent;
    - track counts and lengths."""
    ia, ib = match_cameras_by_name(est, ref)
    if len(ia) == 0:
        # positional matching over the jointly valid slots
        both = est.pose_mask.cpu().numpy() & ref.pose_mask.cpu().numpy()[: est.max_cameras]
        ia = ib = np.nonzero(both)[0]
    g = MetricsGroup("reconstruction_comparison")
    g.metrics += [
        Metric("num_matched_cameras", len(ia)),
        Metric("num_est_cameras", est.number_images()),
        Metric("num_ref_cameras", ref.number_images()),
    ]
    if len(ia) < 3:
        return g
    dev = est.poses.t.device
    Pa = est.poses.map(lambda x: x[torch.as_tensor(ia, device=dev)])
    Pb = ref.poses.map(lambda x: x[torch.as_tensor(ib, device=ref.poses.t.device)].to(dev))
    with precise():
        sim = align_poses_sim3_robust(Pa, Pb)
        aligned = sim.transform_pose(Pa)
        rot_err = so3.relative_angle_deg(aligned.R, Pb.R).cpu().numpy()
    ta = aligned.t.cpu().numpy()
    tb = Pb.t.cpu().numpy()
    t_err = np.linalg.norm(ta - tb, axis=-1)
    num = np.abs(np.sum(ta * tb, axis=-1))
    den = np.linalg.norm(ta, axis=-1) * np.linalg.norm(tb, axis=-1)
    t_angle = np.degrees(np.arccos(np.clip(num / np.maximum(den, 1e-12), -1, 1)))
    g.metrics += [
        Metric("rotation_error_deg", rot_err),
        Metric("translation_error", t_err),
        Metric("translation_angle_error_deg", t_angle),
    ]

    # relative (alignment-free) pair errors -> the pose AUC; relative
    # translation directions are frame-dependent, so they use the aligned
    # poses
    pi, pj = np.triu_indices(len(ia), k=1)
    pairs = np.stack([pi, pj], axis=1).astype(np.int64)
    if len(pairs) > 0:
        Ra = aligned.R.cpu().numpy()
        Rb = Pb.R.cpu().numpy()
        rel_rot = relative_rotation_angular_errors(Ra, Rb, pairs)
        rel_dir = translation_direction_errors_deg(ta, tb, Rb, pairs)
        g.metrics += [
            Metric("relative_rotation_error_deg", rel_rot),
            Metric("relative_translation_angle_error_deg", rel_dir),
        ]
        pose_err = np.maximum(np.nan_to_num(rel_rot, nan=np.inf), np.nan_to_num(rel_dir, nan=np.inf))
        g.metrics += [Metric(k, v) for k, v in pose_auc(pose_err).items()]

    # structure: est landmarks against the nearest reference landmark after
    # the same Sim3, normalized by the reference's extent
    pa = est.points[est.track_mask]
    pb = ref.points[ref.track_mask].cpu().numpy()
    if len(pa) > 0 and len(pb) > 0:
        with precise():
            pa_t = sim.transform(pa).cpu().numpy()
        sub = pa_t[:: max(1, len(pa_t) // 4096)][:4096]
        d2 = np.sum(sub**2, axis=1)[:, None] + np.sum(pb**2, axis=1)[None, :] - 2.0 * sub @ pb.T
        nn_dist = np.sqrt(np.maximum(d2.min(axis=1), 0.0))
        extent = np.linalg.norm(pb.std(axis=0)) + 1e-12
        g.metrics += [Metric("point_nn_dist", nn_dist), Metric("point_nn_dist_rel_extent", nn_dist / extent)]

    mean_a, _ = est.track_length_stats()
    mean_b, _ = ref.track_length_stats()
    g.metrics += [
        Metric("est_num_tracks", est.number_tracks()),
        Metric("ref_num_tracks", ref.number_tracks()),
        Metric("est_mean_track_length", mean_a),
        Metric("ref_mean_track_length", mean_b),
    ]
    return g
