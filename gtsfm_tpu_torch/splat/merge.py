"""Gaussian splat merging across clusters.

Port of gtsfm_tpu/splat/merge.py: move one cluster's splats by the merge
Sim3 (means by the full Sim3, orientations by R, scales by s) and
concatenate them with another cluster's, culling near-duplicates on the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import so3
from gtsfm_tpu_torch.geometry.sim3 import Sim3
from gtsfm_tpu_torch.splat.gs_data import GSData


def transform_splats(gs: GSData, sim: Sim3) -> GSData:
    """Apply a Sim3 to splats: means via the full Sim3, orientation by R,
    scales multiplied by s."""
    new_R = torch.einsum("ij,gjk->gik", sim.R, so3.from_quat(gs.quats))
    return gs.replace(means=sim.transform(gs.means), quats=so3.to_quat(new_R),
                      log_scales=gs.log_scales + torch.log(sim.s))


def merge_gaussian_splats(gs_a: GSData, gs_b: GSData, sim_ab: Sim3, dedup_radius_factor: float = 0.5) -> GSData:
    """Merge cluster b's splats into a's frame. b's splats landing within
    dedup_radius_factor times their own mean scale of an alive splat of a
    are culled; the result holds only alive splats."""
    b_moved = transform_splats(gs_b, sim_ab)
    a_alive = gs_a.alive.cpu().numpy().astype(bool)
    b_alive = b_moved.alive.cpu().numpy().astype(bool)
    pa = gs_a.means.detach().cpu().numpy()[a_alive]
    pb = b_moved.means.detach().cpu().numpy()[b_alive]
    keep_b = np.ones(len(pb), bool)
    if len(pa) and len(pb):
        scale_b = np.exp(b_moved.log_scales.detach().cpu().numpy()[b_alive]).mean(axis=1)
        for s in range(0, len(pb), 2048):  # chunked nearest-neighbor distance
            chunk = pb[s : s + 2048]
            d2 = ((chunk[:, None] - pa[None]) ** 2).sum(-1)
            keep_b[s : s + 2048] = np.sqrt(d2.min(axis=1)) > dedup_radius_factor * scale_b[s : s + 2048]

    def cat(name):
        fa = getattr(gs_a, name).detach().cpu().numpy()[a_alive]
        fb = getattr(b_moved, name).detach().cpu().numpy()[b_alive][keep_b]
        return torch.as_tensor(np.concatenate([fa, fb]), device=gs_a.means.device)

    n_total = int(a_alive.sum() + keep_b.sum())
    return GSData(
        means=cat("means"), log_scales=cat("log_scales"), quats=cat("quats"),
        opacity_logit=cat("opacity_logit"), colors=cat("colors"),
        alive=torch.ones(n_total, dtype=torch.bool, device=gs_a.means.device),
    )
