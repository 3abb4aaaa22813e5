#!/usr/bin/env python3
"""Where a step of the PyTorch port's splat trainer spends its time on a card.

    python3 scripts/profile_torch_splat.py [--steps 30]

Run from the root of a checkout on a machine with a CUDA card. It builds the
trainer phase of chip_smoke.py (the 50,000-gaussian splat scene's 32 ring
views at 480x640, 12,500 SfM points, so 50,000 slots), trains 10 warm-up
steps, then ``--steps`` steps unprofiled and ``--steps`` more under
``torch.profiler``, and prints:
- the host-clock milliseconds per step, unprofiled and profiled;
- device time by kernel (the profiler's CUDA kernel events), largest first;
- the device's busy share: kernel time per step over the unprofiled step
  time (one stream, so kernels barely overlap).
The card's name and power limit come first, from nvidia-smi.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as cs
    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses
    from gtsfm_tpu_torch.splat.gaussian_splatting import GaussianSplatting, GSTrainOptions

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_splat: no CUDA device found")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    n = cs.NUM_CAMERAS
    gt = spectral_ring_poses(cs.ring_pairs(n), n)
    data, views = cs.splat_trainer_inputs(gt.R.numpy(), gt.t.numpy())
    GaussianSplatting(GSTrainOptions(iterations=10)).train(data, views)  # warm-up: builds and first calls
    trainer = GaussianSplatting(GSTrainOptions(iterations=args.steps, densify_every=10**9))

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(data, views)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / args.steps * 1e3

    plain_ms = run()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_ms = run()
    # kernels and copies only: a user annotation (Optimizer.step#Adam.step)
    # also carries device time, which overlaps its own kernels
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    events.sort(key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in events)
    step_us = device_us / args.steps
    print(f"{args.steps} steps: {plain_ms:.2f} ms/step unprofiled, {prof_ms:.2f} ms/step profiled (host clock); "
          f"device kernel time {step_us / 1e3:.2f} ms/step; busy share {step_us / 1e3 / plain_ms:.3f}", flush=True)
    for e in events[:25]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  {100 * e.self_device_time_total / device_us:5.1f}%  "
              f"{e.count:6d} calls  {e.key[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
