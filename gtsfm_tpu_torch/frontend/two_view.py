"""Two-view estimation batched over pairs: fused mutual-NN matching (or
precomputed matches), essential RANSAC, the 2-view Gauss-Newton polish,
the inlier-support filter and the optional degeneracy checks.

Port of gtsfm_tpu/frontend/two_view.py (``run_two_view_batch`` and every
``TwoViewOptions`` field). The pair axis is explicit instead of vmapped.
Without precomputed matches, matching goes through
``fused_match_descriptors``: on a CUDA tensor that is always the
hand-written kernel, whatever ``use_pallas_matcher`` says (the field is
accepted so that the reference's configs load), on a CPU tensor its plain
version. A learned matcher (LightGlue) hands its matches in through
``match_idx`` / ``match_mask`` / ``match_score``, and the mutual-NN kernel
is skipped.

``pair_ids`` keeps the reference's contract: each pair's random streams
(the essential minimal sets, and the homography's, a stream of their own as
the reference's ``fold_in(k, 1)``) are keyed by its global pair index, so
results do not depend on how a scene's pairs are chunked into batches.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gtsfm_tpu_torch.frontend.matchers.fused_matcher import fused_match_descriptors
from gtsfm_tpu_torch.frontend.verifiers.essential import (
    RansacOptions,
    _refine_essential,
    _sampson_error,
    essential_information_spectrum,
    ransac_essential,
    recover_pose_from_essential,
    sample_minimal_sets,
)
from gtsfm_tpu_torch.frontend.verifiers.fundamental import (
    gric_select_model,
    ransac_homography,
    sample_homography_sets,
)
from gtsfm_tpu_torch.geometry import so3
from gtsfm_tpu_torch.utils.numerics import TensorStruct, mm, precise


class TwoViewOptions(NamedTuple):
    ransac: RansacOptions = RansacOptions()
    threshold_px: float = 4.0
    matching_ratio: float = 0.8
    # accepted for the reference's configs: on the card the matcher kernel
    # runs whatever its value
    use_pallas_matcher: bool = False
    # re-run the essential-manifold polish on the final inlier set
    run_two_view_ba: bool = True
    ba_iterations: int = 6
    ba_huber: float = 2.0
    min_num_inliers: int = 15
    min_inlier_ratio: float = 0.1
    # reject a pair whose homography explains >= this share of the
    # essential inliers (0 disables)
    homography_degeneracy_ratio: float = 0.0
    homography_hypotheses: int = 128
    # reject a pair whose 5-dof pose information has min / max eigenvalue
    # below this (0 disables)
    indeterminacy_eig_ratio: float = 0.0


@dataclasses.dataclass(frozen=True)
class TwoViewResult(TensorStruct):
    """Batched over pairs [P, ...]."""

    i2Ri1: torch.Tensor  # (P, 3, 3)
    i2Ui1: torch.Tensor  # (P, 3)
    corr_i1: torch.Tensor  # i32 (P, K)
    corr_i2: torch.Tensor  # i32 (P, K)
    corr_mask: torch.Tensor  # bool (P, K) verified inliers
    num_matches: torch.Tensor  # i32 (P,)
    num_inliers: torch.Tensor  # i32 (P,)
    inlier_ratio: torch.Tensor  # f32 (P,)
    valid: torch.Tensor  # bool (P,)
    # the degeneracy checks' decisive ratios (NaN where a check is off):
    # homography over essential inliers, min over max eigenvalue
    hf_ratio: torch.Tensor  # f32 (P,)
    eig_ratio: torch.Tensor  # f32 (P,)


def draw_samples(match_mask, match_score, pair_mask, opts: TwoViewOptions = TwoViewOptions(), seed: int = 0,
                 pair_ids: torch.Tensor | None = None) -> tuple:
    """The random draws of ``run_two_view_batch`` for these matches: the
    essential minimal sets (P, H, 8), weighted by match similarity, and,
    with the homography check on, the homography's 4-point sets (P, Hh, 4)
    (else None). Passing them back in as ``sample_idx`` /
    ``h_sample_idx`` gives the same result; drawn on one device, they
    make two devices' runs comparable."""
    if pair_ids is None:
        pair_ids = torch.arange(match_mask.shape[0], device=match_mask.device)
    cmask = match_mask & pair_mask[:, None]
    sw = torch.clamp((match_score + 1.0) * 0.5, 1e-3, 1.0) ** 4
    sample_idx = sample_minimal_sets(cmask, sw, opts.ransac.num_hypotheses, seed, pair_ids)
    h_sample_idx = None
    if opts.homography_degeneracy_ratio > 0:
        h_sample_idx = sample_homography_sets(cmask, opts.homography_hypotheses, seed, pair_ids)
    return sample_idx, h_sample_idx


def run_two_view_batch(
    kp_xy1: torch.Tensor,  # (P, K, 2)
    kp_xy2: torch.Tensor,
    desc1: torch.Tensor,  # (P, K, D)
    desc2: torch.Tensor,
    kp_mask1: torch.Tensor,  # (P, K)
    kp_mask2: torch.Tensor,
    cal1,  # calibrations batched (P,)
    cal2,
    pair_mask: torch.Tensor,  # (P,)
    seed: int = 0,
    opts: TwoViewOptions = TwoViewOptions(),
    pair_ids: torch.Tensor | None = None,  # (P,) global pair indices
    sample_idx: torch.Tensor | None = None,  # (P, H, 8) replayed RANSAC draws
    h_sample_idx: torch.Tensor | None = None,  # (P, Hh, 4) replayed homography draws
    match_idx: torch.Tensor | None = None,  # i32 (P, K) precomputed matches
    match_mask: torch.Tensor | None = None,  # bool (P, K)
    match_score: torch.Tensor | None = None,  # f32 (P, K)
    mesh=None,  # parallel.sharding.Mesh: the matcher splits desc1's rows over "model"
) -> TwoViewResult:
    """When (match_idx, match_mask, match_score) are given, as a learned
    matcher produces them, verification runs on them and the mutual-NN
    matching is skipped; the scores weight RANSAC's sampling as the
    descriptor similarities otherwise do. Draws not passed in come from
    ``draw_samples``. With ``mesh``, every rank of this rank's model group
    makes the same call (fused_matcher's row split)."""
    with precise():
        P, K, _ = kp_xy1.shape
        dev = kp_xy1.device
        if pair_ids is None:
            pair_ids = torch.arange(P, device=dev)
        if match_idx is not None:
            midx, mmask, mscore = match_idx, match_mask, match_score
        else:
            midx, mmask, mscore = fused_match_descriptors(
                desc1, desc2, kp_mask1, kp_mask2, ratio=opts.matching_ratio, mesh=mesh
            )
        corr_i1 = torch.arange(K, dtype=torch.int32, device=dev).expand(P, K)
        corr_i2 = torch.where(mmask, midx, 0)
        uv2 = torch.gather(kp_xy2, 1, corr_i2.to(torch.int64)[..., None].expand(P, K, 2))
        cmask = mmask & pair_mask[:, None]

        c1 = cal1.map(lambda a: a[:, None])
        c2 = cal2.map(lambda a: a[:, None])
        x1 = c1.calibrate(kp_xy1)
        x2 = c2.calibrate(uv2)
        f_mean = 0.5 * (cal1.fx + cal2.fx)
        thresh = opts.threshold_px / torch.clamp(f_mean, min=1e-6)  # (P,)

        if sample_idx is None or (h_sample_idx is None and opts.homography_degeneracy_ratio > 0):
            drawn = draw_samples(mmask, mscore, pair_mask, opts, seed, pair_ids)
            sample_idx = drawn[0] if sample_idx is None else sample_idx
            h_sample_idx = drawn[1] if h_sample_idx is None else h_sample_idx
        out = ransac_essential(x1, x2, cmask, thresh, opts=opts.ransac, sample_idx=sample_idx)
        R, t, inl = out["i2Ri1"], out["i2Ui1"], out["inliers"]

        if opts.run_two_view_ba:
            # keep-best guard: never let the refinement reduce MSAC quality
            def quality(R_, t_):
                err_ = _sampson_error(mm(so3.hat(t_), R_), x1, x2)
                gain = torch.clamp(thresh[:, None] ** 2 - err_, min=0.0)
                return torch.sum(torch.where(cmask, gain, torch.zeros_like(gain)), dim=-1)

            q_pre, R_pre, t_pre, inl_pre = quality(R, t), R, t, inl
            R, t = _refine_essential(
                x1, x2, inl.to(x1.dtype), R, t, opts.ba_iterations, opts.ba_huber, thresh
            )
            E = mm(so3.hat(t), R)
            inl = cmask & (_sampson_error(E, x1, x2) < thresh[:, None] ** 2)
            R, t = recover_pose_from_essential(E, x1, x2, inl.to(x1.dtype))
            worse = quality(R, t) < q_pre
            R = torch.where(worse[:, None, None], R_pre, R)
            t = torch.where(worse[:, None], t_pre, t)
            inl = torch.where(worse[:, None], inl_pre, inl)

        n_match = cmask.sum(-1)
        n_inl = inl.sum(-1)
        ratio = n_inl / torch.clamp(n_match, min=1)
        valid = (
            out["success"]
            & pair_mask
            & (n_inl >= opts.min_num_inliers)
            & (ratio >= opts.min_inlier_ratio)
        )
        nan = torch.full((P,), float("nan"), device=dev)
        eig_ratio, hf_ratio = nan, nan
        if opts.indeterminacy_eig_ratio > 0:
            min_eig, max_eig = essential_information_spectrum(x1, x2, inl.to(x1.dtype), R, t)
            max_eig = torch.clamp(max_eig, min=1e-12)
            valid = valid & (min_eig > opts.indeterminacy_eig_ratio * max_eig)
            eig_ratio = min_eig / max_eig
        if opts.homography_degeneracy_ratio > 0:
            h_out = ransac_homography(
                kp_xy1, uv2, cmask, threshold_px=opts.threshold_px, num_hypotheses=opts.homography_hypotheses,
                sample_idx=h_sample_idx,
            )
            degenerate, hf_ratio = gric_select_model(inl, h_out["inliers"], cmask,
                                                     h_f_inlier_ratio_threshold=opts.homography_degeneracy_ratio)
            valid = valid & ~degenerate
        return TwoViewResult(
            i2Ri1=R, i2Ui1=t, corr_i1=corr_i1, corr_i2=corr_i2.to(torch.int32),
            corr_mask=inl & valid[:, None], num_matches=n_match.to(torch.int32),
            num_inliers=n_inl.to(torch.int32), inlier_ratio=ratio.to(torch.float32), valid=valid,
            hf_ratio=hf_ratio.to(torch.float32), eig_ratio=eig_ratio.to(torch.float32),
        )
