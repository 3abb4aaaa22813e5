"""Two-view estimation batched over pairs: fused mutual-NN matching (or
precomputed matches), essential RANSAC, the 2-view Gauss-Newton polish and
the inlier-support filter.

Port of gtsfm_tpu/frontend/two_view.py (``run_two_view_batch`` with the
default options). The pair axis is explicit instead of vmapped. Without
precomputed matches, matching goes through ``fused_match_descriptors``: on
a CUDA tensor that is always the hand-written kernel (the reference's
``use_pallas_matcher`` switch is not carried over), on a CPU tensor its
plain version. A learned matcher (LightGlue) hands its matches in through
``match_idx`` / ``match_mask`` / ``match_score``, and the mutual-NN kernel
is skipped.

``pair_ids`` keeps the reference's contract: each pair's random stream is
keyed by its global pair index, so results do not depend on how a scene's
pairs are chunked into batches.
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
    ransac_essential,
    recover_pose_from_essential,
)
from gtsfm_tpu_torch.geometry import so3
from gtsfm_tpu_torch.utils.numerics import TensorStruct, mm, precise


class TwoViewOptions(NamedTuple):
    ransac: RansacOptions = RansacOptions()
    threshold_px: float = 4.0
    matching_ratio: float = 0.8
    ba_iterations: int = 6
    ba_huber: float = 2.0
    min_num_inliers: int = 15
    min_inlier_ratio: float = 0.1


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
    match_idx: torch.Tensor | None = None,  # i32 (P, K) precomputed matches
    match_mask: torch.Tensor | None = None,  # bool (P, K)
    match_score: torch.Tensor | None = None,  # f32 (P, K)
) -> TwoViewResult:
    """When (match_idx, match_mask, match_score) are given, as a learned
    matcher produces them, verification runs on them and the mutual-NN
    matching is skipped; the scores weight RANSAC's sampling as the
    descriptor similarities otherwise do."""
    with precise():
        P, K, _ = kp_xy1.shape
        dev = kp_xy1.device
        if pair_ids is None:
            pair_ids = torch.arange(P, device=dev)
        if match_idx is not None:
            midx, mmask, mscore = match_idx, match_mask, match_score
        else:
            midx, mmask, mscore = fused_match_descriptors(
                desc1, desc2, kp_mask1, kp_mask2, ratio=opts.matching_ratio
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

        sw = torch.clamp((mscore + 1.0) * 0.5, 1e-3, 1.0) ** 4
        out = ransac_essential(
            x1, x2, cmask, thresh, opts=opts.ransac, sample_weights=sw,
            sample_idx=sample_idx, seed=seed, stream_ids=pair_ids,
        )
        R, t, inl = out["i2Ri1"], out["i2Ui1"], out["inliers"]

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
        return TwoViewResult(
            i2Ri1=R, i2Ui1=t, corr_i1=corr_i1, corr_i2=corr_i2.to(torch.int32),
            corr_mask=inl & valid[:, None], num_matches=n_match.to(torch.int32),
            num_inliers=n_inl.to(torch.int32), inlier_ratio=ratio.to(torch.float32), valid=valid,
        )
