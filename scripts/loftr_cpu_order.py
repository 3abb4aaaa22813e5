#!/usr/bin/env python3
"""How far float32 order alone moves LoFTR's refined coordinates at the
published widths: the port's LoFTR (LoFTROptions(), chip_smoke.loftr_fixture's
seeded outdoor_ds weights) on the CPU, on the correspondence phase's first
held pair, against the JAX package's output on the same weights and views
(scripts/correspondence_reference.npz). Prints the share of identical
matches and the largest distance between the refined coordinates of the
common ones: the reason chip_smoke.CORR_FINE_TOL_PX sits above the CPU
tests' 1e-3 px, which hold at reduced widths.

    python3 scripts/loftr_cpu_order.py [--threads 4]

The port only, on the CPU: no JAX and no card. About 10 s on 4 cores.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gtsfm_tpu_torch.frontend.matchers.loftr import LoFTRMatcher  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    npz = np.load(os.path.join(root, chip_smoke.CORR_REFERENCE_NPZ))
    gray = chip_smoke.corr_hold_gray(npz["views_rgb"])
    matcher = LoFTRMatcher(state_dict=chip_smoke.loftr_fixture(0))
    a, b = chip_smoke.CORR_HOLD_PAIRS[0]
    t0 = time.perf_counter()
    uv1, uv2, _scores, mask = (x.numpy() for x in matcher.match_images(torch.as_tensor(gray[a]),
                                                                        torch.as_tensor(gray[b])))
    sec = time.perf_counter() - t0
    held = chip_smoke.corr_share("loftr", (uv1[mask], uv2[mask]), (npz["loftr_uv1_0"], npz["loftr_uv2_0"]))
    print(f"loftr on the CPU ({args.threads} threads), pair {(a, b)} at {gray.shape[1:]}: {held['n_port']} matches, "
          f"the reference's {held['n_ref']}, {held['common']} identical (share {held['share']:.4f}); refined "
          f"coordinates of the common ones at most {held['fine_err']:.3g} px from the reference's "
          f"(bar on the card {chip_smoke.CORR_FINE_TOL_PX} px); {sec:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
