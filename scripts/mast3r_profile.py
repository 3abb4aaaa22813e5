#!/usr/bin/env python3
"""Where a MASt3R pair's time goes on the card: one ``symmetric_inference``
at the published widths (chip_smoke.mast3r_fixture's seeded weights, the
correspondence phase's first held pair at 384x512) under torch.profiler
(CPU and CUDA activity), printing the operators by device time and the
CPU and device totals, then the wall time of 5 synchronized calls, the
split of a pair (one image's encoder, the decoders and heads on encoded
tokens, the four reciprocal walks), the generator's seconds a pair on
the 4 held pairs (each image encoded once a call) and the float32 rate of
one encoder-sized GEMM (768 x 1024 x 4096) for scale.

    python3 scripts/mast3r_profile.py

Run on a CUDA machine from the root of a checkout (it reads
scripts/correspondence_reference.npz). It prints the card's name and power
limit. The port only: no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from gtsfm_tpu_torch.frontend.mast3r import PATCH, Mast3rCorrespondenceGenerator, reciprocal_nn  # noqa: E402
from gtsfm_tpu_torch.utils.numerics import precise  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    npz = np.load(os.path.join(root, chip_smoke.CORR_REFERENCE_NPZ))
    gray = chip_smoke.corr_hold_gray(npz["views_rgb"])
    gen = Mast3rCorrespondenceGenerator(state_dict=chip_smoke.mast3r_fixture(0), device="cuda")
    a, b = chip_smoke.CORR_HOLD_PAIRS[0]
    with torch.no_grad(), precise():
        x1, x2 = gen._preprocess(gray[a])[0], gen._preprocess(gray[b])[0]
        for _ in range(3):
            gen.net.symmetric_inference(x1, x2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            gen.net.symmetric_inference(x1, x2)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), flush=True)
        wall = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.net.symmetric_inference(x1, x2)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        o = gen.options
        grid = (x1.shape[-2] // PATCH, x1.shape[-1] // PATCH)
        split = {"encode one image": [], "decode both directions": [], "reciprocal_nn x4": []}
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e1 = gen.net.encode(x1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            e2 = gen.net.encode(x2)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            descs, _confs = gen.net.symmetric_decode(e1, e2, *grid)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            d11, d21, d22, d12 = (d[0] for d in descs)
            for a, b in ((d11, d21), (d21, d11), (d12, d22), (d22, d12)):
                reciprocal_nn(a, b, o.subsample, o.nn_iterations)
            torch.cuda.synchronize()
            split["encode one image"] += [t1 - t0, t2 - t1]
            split["decode both directions"].append(t3 - t2)
            split["reciprocal_nn x4"].append(time.perf_counter() - t3)
        hold = np.asarray(chip_smoke.CORR_HOLD_PAIRS)
        gen.generate(list(gray), hold)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.generate(list(gray), hold)
        torch.cuda.synchronize()
        per_pair = (time.perf_counter() - t0) / len(hold)
        x = torch.randn(768, 1024, device="cuda")
        w = torch.randn(4096, 1024, device="cuda")
        for _ in range(3):
            torch.nn.functional.linear(x, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            torch.nn.functional.linear(x, w)
        torch.cuda.synchronize()
        gemm = (time.perf_counter() - t0) / 20
    calls = sum(e.count for e in prof.key_averages())
    print(f"symmetric_inference at {tuple(x1.shape[-2:])}: {calls} operator calls, wall "
          f"{[round(t, 4) for t in wall]} s (median {float(np.median(wall)):.4f}); float32 GEMM 768x1024x4096 "
          f"{gemm * 1e3:.3f} ms, {2 * 768 * 1024 * 4096 / gemm / 1e12:.1f} TFLOP/s | {smi}", flush=True)
    print("a pair's split (wall, s): " + ", ".join(
        f"{k} median {float(np.median(v)):.4f} {[round(t, 4) for t in v]}" for k, v in split.items())
        + f"; the generator on the {len(hold)} held pairs {per_pair:.4f} s a pair | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
