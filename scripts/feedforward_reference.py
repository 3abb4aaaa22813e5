#!/usr/bin/env python3
"""The JAX package's feed-forward cluster slots on the CPU: the reference
numbers for chip_smoke.py's ``feedforward`` and ``vggt_full`` phases.

    JAX_PLATFORMS=cpu python3 scripts/feedforward_reference.py [--port] \\
        [--out scripts/feedforward_reference.json]

Two parts, on the inputs chip_smoke.py gives the port:

- ``runs``: ``python -m gtsfm_tpu.runner --loader olsson`` with
  ``--config_name vggt``, ``fastvggt`` and ``anysplat --run_gs``
  (``scene_optimizer.gs_iterations=FF_GS_STEPS``) on an Olsson folder of
  the first ``chip_smoke.FF_VIEWS`` ring views made by
  ``chip_smoke.feedforward_views`` at 480x640, f=600, with the compact
  model's seeded weights (``chip_smoke.feedforward_fixture``, its
  FastVGGT blocks for fastvggt) placed in the reference's model cache
  through ``_resolve_model(opts, hw, params)``. Each run's forward is
  recorded (``chip_smoke.ff_forward_record``) with its feed-forward track
  count, registered cameras, pose AUC@5, the post-BA costs and, for
  anysplat, the initial gaussians and the trainer's L1.
- ``vggt_check``: ``VGGTModel.run`` and ``track`` of the JAX package on
  ``chip_smoke.vggt_check_inputs`` (2 views at 392x518, 64 query points)
  with ``chip_smoke.vggt_fixture`` at ``chip_smoke.vggt_check_options()``:
  VGGT-1B's widths (1024-d, 16 heads, DPT 256 / (256, 512, 1024, 1024),
  the track head at TrackOptions()) with the depth cut to 2 layer pairs, 2
  DINO blocks, 1 camera-trunk block and 2 track blocks, so that the JAX
  forward fits this CPU's memory (the public layout read by the
  reference's converter; the unused first residual unit of each
  refinenet4, which the public layout lacks, given zeros).

``--port`` also runs the port on the CPU on the same inputs and prints its
distance from the reference (the float32 order alone). It prints one JSON
line per part and writes both to ``--out``. This script imports JAX; the
port never does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

SLOTS = ("vggt", "fastvggt", "anysplat")


def _read_metrics(output_root: str) -> dict:
    from gtsfm_tpu.evaluation.metrics import MetricsGroup

    mdir = os.path.join(output_root, "results", "metrics")
    out = {}
    for name in sorted(os.listdir(mdir)):
        g = MetricsGroup.from_json(os.path.join(mdir, name))
        out[g.name] = {m.name: (m.scalar if m.dist is None else m.dist) for m in g.metrics}
    return out


def _lists(record: dict) -> dict:
    return {k: np.asarray(v).tolist() for k, v in record.items()}


def slot_argv(slot: str, data_dir: str, out_dir: str, gs_steps: int) -> list:
    argv = ["--config_name", slot, "--loader", "olsson", "--dataset_dirpath", data_dir, "--output_root", out_dir]
    return argv + (["--run_gs", f"scene_optimizer.gs_iterations={gs_steps}"] if slot == "anysplat" else [])


def jax_runs(data_dir: str, work: str) -> list:
    """The reference runner's three slots with the seeded compact weights."""
    from gtsfm_tpu import runner
    from gtsfm_tpu.frontend import feedforward as j_ff
    from gtsfm_tpu.scene import cluster_feedforward as j_cf

    runs = []
    for slot in SLOTS:
        stride = 4 if slot == "fastvggt" else 1
        params = chip_smoke.feedforward_fixture(chip_smoke.FF_SEED, chip_smoke.SPLAT_HW, stride)
        j_cf._MODEL_CACHE.clear()
        j_cf._resolve_model(j_cf.ClusterFeedforwardOptions(model=j_ff.FeedforwardOptions(global_kv_stride=stride)),
                            chip_smoke.SPLAT_HW, params)
        seen = {}
        run, run_raw = j_ff.FeedforwardReconstruction.run, j_cf.ClusterFeedforward.run_raw

        def fwd(self, images):
            out = run(self, images)
            seen["forward"] = (out, self.last_track_feat)
            return out

        def raw(self, *args):
            out = run_raw(self, *args)
            seen["metrics"] = out[1]
            return out

        j_ff.FeedforwardReconstruction.run, j_cf.ClusterFeedforward.run_raw = fwd, raw
        out_dir = os.path.join(work, slot)
        t0 = time.perf_counter()
        try:
            rc = runner.main(slot_argv(slot, data_dir, out_dir, chip_smoke.FF_GS_STEPS))
        finally:
            j_ff.FeedforwardReconstruction.run, j_cf.ClusterFeedforward.run_raw = run, run_raw
        wall = time.perf_counter() - t0
        (poses, depth, conf, focal), feat = seen["forward"]
        m = _read_metrics(out_dir)
        pose = m["ba_pose_metrics"]
        post = seen["metrics"].get("post_ba")
        rec = {"slot": slot, "rc": rc, "wall_sec": wall,
               "forward": _lists(chip_smoke.ff_forward_record(*(np.asarray(a) for a in (
                   poses.R, poses.t, focal, depth, conf, feat)))),
               "num_tracks_ff": int(m["feedforward_metrics"]["num_tracks_ff"]),
               "registered": int(len(pose["rotation_error_deg"])),
               "pose_auc_@5.0_deg": float(pose["pose_auc_@5.0_deg"]),
               "post_ba": None if post is None else {"initial_cost": post["initial_cost"],
                                                     "final_cost": post["final_cost"]}}
        if slot == "anysplat":
            from gtsfm_tpu.io.ply import read_ply

            gs = m["gaussian_splatting_metrics"]
            rec["gs"] = {"initial_l1": gs["initial_l1"], "final_l1": gs["final_l1"],
                         "num_gaussians": int(gs["num_gaussians"]),
                         "gaussian_points": int(len(read_ply(os.path.join(out_dir, "results",
                                                                          "gaussian_points.ply"))[0]))}
            with open(os.path.join(out_dir, "results", "splats.ply"), "rb") as f:
                rec["gs"]["splats"] = int(next(ln for ln in f if ln.startswith(b"element vertex")).split()[-1])
        runs.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "forward"}), flush=True)
    return runs


def jax_vggt_check(R, t) -> dict:
    from gtsfm_tpu.frontend import vggt as j_vggt
    from gtsfm_tpu.frontend import vggt_track as j_track

    vo, to = chip_smoke.vggt_check_options()
    sd = chip_smoke.vggt_fixture(chip_smoke.VGGT_SEED, vo, to)
    full = dict(sd)
    for head, F in (("depth_head", vo.dpt_features), ("point_head", vo.dpt_features),
                    ("track_head.feature_extractor", to.dpt_features)):
        for c in ("conv1", "conv2"):
            full[f"{head}.scratch.refinenet4.resConfUnit1.{c}.weight"] = np.zeros((F, F, 3, 3), np.float32)
            full[f"{head}.scratch.refinenet4.resConfUnit1.{c}.bias"] = np.zeros(F, np.float32)
    jo = j_vggt.VGGTOptions(**{f: getattr(vo, f) for f in j_vggt.VGGTOptions._fields})
    params, jo = j_vggt.convert_torch_state_dict(full, opts=jo)
    images, qp = chip_smoke.vggt_check_inputs(R, t)
    model = j_vggt.VGGTModel(jo, params=params)
    t0 = time.perf_counter()
    run = {k: np.asarray(v) for k, v in model.run(jnp.asarray(images)).items()}
    track = {k: np.asarray(v) for k, v in model.track(jnp.asarray(images), jnp.asarray(qp)).items()}
    outputs, ps = j_vggt.aggregator_forward(params["aggregator"], jnp.asarray(images), jo)
    coords, vis, conf = j_track.track_head_forward(params["track_head"], outputs, ps, chip_smoke.VGGT_CHECK_HW,
                                                   jnp.asarray(qp), jo,
                                                   j_track.track_options_from_params(params["track_head"]), iters=1)
    track_1 = {"tracks": np.asarray(coords[-1]), "vis": np.asarray(vis), "conf": np.asarray(conf)}
    sec = time.perf_counter() - t0
    sumsq = float(sum(np.square(v, dtype=np.float64).sum() for v in sd.values()))
    rec = chip_smoke.vggt_check_record(run, track_1, track)
    return {"options": {k: list(v) if isinstance(v, tuple) else v for k, v in vo._asdict().items()},
            "track_depth": to.depth, "views": chip_smoke.VGGT_CHECK_VIEWS, "image_hw": list(chip_smoke.VGGT_CHECK_HW),
            "queries": chip_smoke.VGGT_CHECK_QUERIES, "weights_sumsq": sumsq, "sec": sec, "record": _lists(rec)}


def port_vggt_check(R, t, ref: dict) -> dict:
    """The port on the CPU on the check's inputs: its largest distances
    from the reference."""
    from gtsfm_tpu_torch.frontend.vggt import VGGTModel

    vo, to = chip_smoke.vggt_check_options()
    model = VGGTModel(vo, state_dict=chip_smoke.vggt_fixture(chip_smoke.VGGT_SEED, vo, to), device="cpu")
    images, qp = chip_smoke.vggt_check_inputs(R, t)
    run = {k: v.numpy() for k, v in model.run(images).items()}
    track = {k: v.numpy() for k, v in model.track(images, qp).items()}
    mine = chip_smoke.vggt_check_record(run, chip_smoke.vggt_track_iters(model, images, qp, 1), track)
    return {k: float(np.max(np.abs(np.asarray(ref[k]) - v) / np.maximum(np.abs(np.asarray(ref[k])), 1.0)))
            for k, v in mine.items()} | {"max_abs_" + k: float(np.max(np.abs(np.asarray(ref[k]) - mine[k])))
                                         for k in ("tracks_1", "tracks")}


def port_runs(data_dir: str, work: str, ref_runs: list) -> list:
    """The port's runner on the CPU with the same weights: each run's
    largest forward distances from the reference and its counts."""
    from gtsfm_tpu_torch import runner
    from gtsfm_tpu_torch.frontend import feedforward as ff
    from gtsfm_tpu_torch.scene import cluster_feedforward as cf
    from gtsfm_tpu_torch.utils import convert

    out = []
    for slot, ref in zip(SLOTS, ref_runs):
        stride = 4 if slot == "fastvggt" else 1
        params = chip_smoke.feedforward_fixture(chip_smoke.FF_SEED, chip_smoke.SPLAT_HW, stride)
        cf._MODEL_CACHE.clear()
        cf._resolve_model(cf.ClusterFeedforwardOptions(model=ff.FeedforwardOptions(global_kv_stride=stride)),
                          chip_smoke.SPLAT_HW, convert.feedforward_state_dict(params), "cpu")
        seen = {}
        run, run_raw = ff.FeedforwardReconstruction.run, cf.ClusterFeedforward.run_raw

        def fwd(self, images):
            o = run(self, images)
            seen["forward"] = (o, self.last_track_feat)
            return o

        def raw(self, *args):
            o = run_raw(self, *args)
            seen["metrics"] = o[1]
            return o

        ff.FeedforwardReconstruction.run, cf.ClusterFeedforward.run_raw = fwd, raw
        out_dir = os.path.join(work, "port_" + slot)
        try:
            runner.main(slot_argv(slot, data_dir, out_dir, chip_smoke.FF_GS_STEPS) + ["scene_optimizer.device=cpu"])
        finally:
            ff.FeedforwardReconstruction.run, cf.ClusterFeedforward.run_raw = run, run_raw
        (poses, depth, conf, focal), feat = seen["forward"]
        mine = chip_smoke.ff_forward_record(*(a.cpu().numpy() for a in (poses.R, poses.t, focal, depth, conf, feat)))
        m = _read_metrics(out_dir)
        post = seen["metrics"].get("post_ba")
        rec = {"slot": slot, "forward_max_abs": {k: float(np.max(np.abs(np.asarray(ref["forward"][k]) - v)))
                                                 for k, v in mine.items()},
               "num_tracks_ff": int(m["feedforward_metrics"]["num_tracks_ff"]),
               "registered": int(len(m["ba_pose_metrics"]["rotation_error_deg"])),
               "pose_auc_@5.0_deg": float(m["ba_pose_metrics"]["pose_auc_@5.0_deg"]),
               "post_ba": None if post is None else {"initial_cost": post["initial_cost"],
                                                     "final_cost": post["final_cost"]}}
        if slot == "anysplat":
            gs = m["gaussian_splatting_metrics"]
            rec["gs"] = {k: gs[k] for k in ("initial_l1", "final_l1", "num_gaussians")}
        out.append(rec)
        print("port", json.dumps(rec), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--port", action="store_true", help="also run the port on the CPU and print its distances")
    ap.add_argument("--parts", default="runs,vggt_check")
    args = ap.parse_args()
    parts = args.parts.split(",")

    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses

    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    out = {"jax": jax.__version__, "device": "cpu"}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            out.update({k: v for k, v in json.load(f).items() if k in ("runs", "vggt_check")})
    if "runs" in parts:
        order = chip_smoke.ring_order(t)[: chip_smoke.FF_VIEWS]
        views = chip_smoke.feedforward_views(R, t, order)
        with tempfile.TemporaryDirectory() as work:
            data_dir = os.path.join(work, "data")
            chip_smoke.write_olsson(data_dir, views, R[order], t[order], chip_smoke.SPLAT_FOCAL)
            out["runs"] = jax_runs(data_dir, work)
            if args.port:
                port_runs(data_dir, work, out["runs"])
    if "vggt_check" in parts:
        out["vggt_check"] = jax_vggt_check(R, t)
        print(json.dumps({k: v for k, v in out["vggt_check"].items() if k != "record"}), flush=True)
        if args.port:
            print("port vggt_check", json.dumps(port_vggt_check(R, t, out["vggt_check"]["record"])), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
