#!/usr/bin/env python3
"""The JAX package's dense back ends on the CPU: the reference numbers for
chip_smoke.py's ``mvs`` phase.

    JAX_PLATFORMS=cpu python3 scripts/mvs_reference.py [--port] \\
        [--out scripts/mvs_reference.npz]

On the inputs chip_smoke.py gives the port: the first
``chip_smoke.FF_VIEWS`` ring views made by ``chip_smoke.feedforward_views``
at 480x640, f=600 (gray), their GT poses and ``chip_smoke.mvs_tracks``
(MVS_TRACKS seeded points on the scene's two spheres): the reference's
``select_source_views``, ``_depth_range_per_view``, ``PlaneSweepMVS`` at
``MVSOptions()``, and ``PatchmatchNetMVS`` on ``chip_smoke.pmnet_fixture``
(through its ``convert_torch_state_dict``) with the stage-3 random draw
the port makes (one ``torch.rand`` of a ``torch.Generator`` seeded with
MVS_SEED, reused for every view) put in place of ``jax.random.uniform``'s.
It writes each backend's ``chip_smoke.mvs_record`` (depth and confidence
every MVS_DEPTH_STEP pixels, the dense point count and centroid, the median
relative error against the analytic depth on every pixel and on the
confident ones), the source views and the depth
ranges to ``--out`` (about 0.5 MB). ``--port`` also runs the port on the
CPU on the same inputs and holds it as the mvs phase holds the card
(``chip_smoke._hold_mvs``). This script imports JAX; the port never does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402


def _inputs():
    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses

    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)[: chip_smoke.FF_VIEWS]
    return R, t, order


def _jax_data(R, t, order):
    from gtsfm_tpu.common.sfm_data import SfmData
    from gtsfm_tpu.geometry import SE3, Cal3Bundler

    n, (h, w) = len(order), chip_smoke.SPLAT_HW
    cal = Cal3Bundler.create(jnp.full(n, chip_smoke.SPLAT_FOCAL), jnp.zeros(n), jnp.zeros(n), jnp.full(n, w / 2.0),
                             jnp.full(n, h / 2.0))
    poses = SE3(R=jnp.asarray(R[order], jnp.float32), t=jnp.asarray(t[order], jnp.float32))
    return SfmData.from_cameras_and_tracks(poses, cal, chip_smoke.mvs_tracks(R, t, order), num_cameras=n)


def port_draw(hw: tuple) -> np.ndarray:
    """The port's stage-3 draw for images of ``hw``."""
    from gtsfm_tpu_torch.densify.patchmatchnet import RANDOM_INIT_SAMPLES

    gen = torch.Generator().manual_seed(chip_smoke.MVS_SEED)
    return torch.rand((RANDOM_INIT_SAMPLES, hw[0] // 8, hw[1] // 8), generator=gen).numpy()


def run_reference(views, data, truth) -> dict:
    from gtsfm_tpu.densify import mvs as j_mvs
    from gtsfm_tpu.densify import patchmatchnet as j_pm

    opts = j_mvs.MVSOptions()
    out = {"source_views": j_mvs.select_source_views(data, opts),
           "depth_ranges": j_mvs._depth_range_per_view(data, opts.depth_margin)}
    u = jnp.asarray(port_draw(views.shape[1:]))
    d = j_pm.RANDOM_INIT_SAMPLES
    j_pm._depth_init_random = lambda key, dmin, dmax, h, w: 1.0 / (
        1.0 / dmax + (u + jnp.arange(d, dtype=jnp.float32)[:, None, None]) / d * (1.0 / dmin - 1.0 / dmax))
    params = j_pm.convert_torch_state_dict(chip_smoke.pmnet_fixture(chip_smoke.MVS_SEED))
    for name, mvs in (("plane_sweep", j_mvs.PlaneSweepMVS(opts)),
                      ("patchmatchnet", j_pm.PatchmatchNetMVS(opts, params=params, seed=chip_smoke.MVS_SEED))):
        t0 = time.perf_counter()
        depths, confs = mvs.compute_depths(data, views)
        points, _colors, metrics = j_mvs.fuse_depth_maps(depths, confs, data, views, opts)
        rec = chip_smoke.mvs_record(depths, confs, points, truth)
        print(f"reference {name}: {metrics}, {time.perf_counter() - t0:.1f} s, median relative error against the "
              f"analytic depth {float(rec['truth_median']):.4f}", flush=True)
        out["views"] = rec.pop("views")
        out.update({f"{name}_{k}": v for k, v in rec.items()})
    return out


def run_port(views, R, t, order, truth, ref: dict) -> None:
    """The port on the CPU, held as the mvs phase holds it on the card."""
    from gtsfm_tpu_torch.densify import mvs
    from gtsfm_tpu_torch.densify import patchmatchnet as pm

    data = chip_smoke.mvs_sfm_data(R, t, order, torch.device("cpu"))
    opts = mvs.MVSOptions()
    src = mvs.select_source_views(data, opts)
    ranges = mvs._depth_range_per_view(data, opts.depth_margin)
    print(f"port: source views equal {np.array_equal(src, ref['source_views'])}, depth ranges' largest relative "
          f"distance {np.max(np.abs(ranges - ref['depth_ranges']) / ref['depth_ranges']):.3g}", flush=True)
    sd = chip_smoke.pmnet_fixture(chip_smoke.MVS_SEED)
    for name, backend in (("plane_sweep", mvs.PlaneSweepMVS(opts, device="cpu")),
                          ("patchmatchnet", pm.PatchmatchNetMVS(opts, state_dict=sd, seed=chip_smoke.MVS_SEED,
                                                                device="cpu"))):
        depths, confs = backend.compute_depths(data, views)
        points, _c, _m = mvs.fuse_depth_maps(depths, confs, data, views, opts)
        try:
            chip_smoke._hold_mvs(name, chip_smoke.mvs_record(depths, confs, points, truth), ref)
        except AssertionError as e:
            print(f"port {name}: outside the mvs phase's bars: {e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "mvs_reference.npz"))
    ap.add_argument("--port", action="store_true", help="also run the port on the CPU and print its distance")
    args = ap.parse_args()
    R, t, order = _inputs()
    views, truth = chip_smoke.mvs_views(R, t, order), chip_smoke.feedforward_depths(R, t, order)
    ref = run_reference(views, _jax_data(R, t, order), truth)
    np.savez_compressed(args.out, **ref)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)", flush=True)
    if args.port:
        run_port(views, R, t, order, truth, ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
