"""Warm-up of the standard shape set before the first scene.

Port of gtsfm_tpu/utils/prewarm.py. The reference compiles its jit
programs ahead of time into XLA's persistent cache; the port has no jit
programs, and its one-time costs are the build of the hand-written CUDA
kernels (``utils/cuda_build.py``, whose build directory is the
counterpart of the reference's compile cache, ``utils/compile_cache.py``)
and the first call of each stage: CUDA context, cuDNN and cuBLAS
handles, allocator pools, and the ``torch._dynamo`` import that
forward-mode AD sets off on the card's PyTorch. ``prewarm_standard_shapes``
builds the kernels and runs one call of the two-view batch, bundle
adjustment (with a forward-mode Jacobian) and the detector at the
reference's standard shapes on the run's device, and returns the seconds
of each under the reference's names (and ``cuda_kernels`` for the build on
a CUDA device).

The two-view warm-up verifies given matches, so it launches no matcher
kernel: the matcher's one-time cost is its build.

Only the kernel build outlives the process. The warm-up calls warm the
process they run in: ``runner --prewarm`` pays the one-time costs before
the pipeline, out of ``total_runtime_sec`` but not out of the process's
wall time (``scripts/prewarm_wall.py`` measures both in fresh processes),
and the standalone module leaves the built kernels behind and nothing
else.

Usage:  python -m gtsfm_tpu_torch.utils.prewarm     # build the kernels (and warm this process), on the card
        runner --prewarm                           # before the pipeline
        prewarm_standard_shapes(pair_batches=(64,), device="cpu")
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from gtsfm_tpu_torch.utils.numerics import resolve_device


def _warm_two_view(pair_batch: int, max_keypoints: int, desc_dim: int, hypotheses: int, dev) -> None:
    from gtsfm_tpu_torch.frontend.two_view import TwoViewOptions, run_two_view_batch
    from gtsfm_tpu_torch.frontend.verifiers.essential import RansacOptions
    from gtsfm_tpu_torch.geometry import Cal3Bundler

    P, K, D = pair_batch, max_keypoints, desc_dim
    g = torch.Generator().manual_seed(0)
    cal = Cal3Bundler.create(torch.full((P,), 500.0), 0.0, 0.0, 320.0, 240.0, device=dev)
    xy1, xy2 = (torch.rand((P, K, 2), generator=g) * torch.tensor([640.0, 480.0]) for _ in range(2))
    desc = torch.randn((P, K, D), generator=g)
    ones = torch.ones((P, K), dtype=torch.bool, device=dev)
    run_two_view_batch(
        xy1.to(dev), xy2.to(dev), desc.to(dev), desc.to(dev), ones, ones, cal, cal,
        torch.ones(P, dtype=torch.bool, device=dev),
        opts=TwoViewOptions(ransac=RansacOptions(num_hypotheses=hypotheses)),
        match_idx=torch.arange(K, dtype=torch.int32, device=dev).expand(P, K).contiguous(),
        match_mask=ones, match_score=ones.to(torch.float32),
    )


def _warm_ba(n_cam: int, n_track: int, n_meas: int, dev) -> None:
    """Bundle adjustment on a seeded ring of n_cam cameras around n_track
    points, n_meas measurements (each track in n_meas / n_track views),
    then one forward-mode Jacobian."""
    from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment
    from gtsfm_tpu_torch.common.sfm_data import SfmData
    from gtsfm_tpu_torch.geometry import SE3, Cal3Bundler, PinholeCamera
    from gtsfm_tpu_torch.utils.numerics import jacobian_fwd

    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, n_cam, endpoint=False)
    c = np.stack([5 * np.cos(ang), 0.3 * np.sin(3 * ang), 5 * np.sin(ang)], axis=1)
    z = -c / np.linalg.norm(c, axis=1, keepdims=True)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], axis=2)
    poses = SE3(R=torch.as_tensor(R, dtype=torch.float32, device=dev),
                t=torch.as_tensor(c, dtype=torch.float32, device=dev))
    cal = Cal3Bundler.create(torch.full((n_cam,), 500.0), 0.0, 0.0, 320.0, 240.0, device=dev)
    points = torch.as_tensor(rng.uniform(-1, 1, (n_track, 3)), dtype=torch.float32, device=dev)
    meas_track = torch.as_tensor(np.arange(n_meas) % n_track, device=dev)
    meas_cam = torch.as_tensor((np.arange(n_meas) // n_track * 7 + np.arange(n_meas)) % n_cam, device=dev)
    cams = PinholeCamera(pose=poses.map(lambda a: a[meas_cam]), cal=cal.map(lambda a: a[meas_cam]))
    uv, _ = cams.project(points[meas_track])
    data = SfmData(poses=poses, pose_mask=torch.ones(n_cam, dtype=torch.bool, device=dev), cal=cal,
                   points=points, track_mask=torch.ones(n_track, dtype=torch.bool, device=dev),
                   meas_cam=meas_cam, meas_track=meas_track,
                   meas_uv=uv + torch.as_tensor(rng.normal(0, 0.5, (n_meas, 2)), dtype=torch.float32, device=dev),
                   meas_mask=torch.ones(n_meas, dtype=torch.bool, device=dev))
    fixed = np.zeros(n_cam, bool)
    fixed[0] = True
    BundleAdjustment(BAOptions()).run(data, fixed_cam=fixed)
    jacobian_fwd(torch.sin, torch.ones((2, 3), device=dev))


def _warm_detector(image_batch: int, hw: tuple, max_keypoints: int, dev) -> None:
    from gtsfm_tpu_torch.frontend.detectors.dog_sift import DoGSift, DoGSiftOptions

    images = torch.rand((image_batch,) + tuple(hw), generator=torch.Generator().manual_seed(0))
    DoGSift(DoGSiftOptions(max_keypoints=max_keypoints)).detect_batch(images.to(dev))


def prewarm_standard_shapes(
    pair_batches: Sequence[int] = (64,),
    max_keypoints: int = 1024,
    desc_dim: int = 128,
    hypotheses: int = 512,
    ba_shapes: Sequence[tuple] = ((64, 4096, 24576),),
    detector_hw: tuple = (480, 640),
    image_batch: int = 4,
    device="cuda",
) -> dict:
    """Build the kernels (on a CUDA device) and warm the standard shape set
    on ``device``; returns {name: seconds}."""
    dev = resolve_device(device)
    timings = {}

    def warm_one(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings[name] = round(time.perf_counter() - t0, 2)

    if dev.type == "cuda":
        from gtsfm_tpu_torch.utils import cuda_build

        warm_one("cuda_kernels", cuda_build.build)
    for P in pair_batches:
        warm_one(f"two_view_P{P}_K{max_keypoints}", _warm_two_view, P, max_keypoints, desc_dim, hypotheses, dev)
    for (nc, nt, nm) in ba_shapes:
        warm_one(f"ba_{nc}c_{nt}t_{nm}m", _warm_ba, nc, nt, nm, dev)
    warm_one(f"detector_B{image_batch}_{detector_hw[0]}x{detector_hw[1]}", _warm_detector, image_batch,
             detector_hw, max_keypoints, dev)
    return timings


def main():
    timings = prewarm_standard_shapes()
    for k, v in timings.items():
        print(f"{k}: {v}s")
    print(f"prewarm complete: {len(timings)} steps, {sum(timings.values()):.1f}s total")


if __name__ == "__main__":
    main()
