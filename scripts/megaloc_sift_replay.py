#!/usr/bin/env python3
"""Which stage sets the megaloc_sift runner's pose AUC@5: each package's
back end on each package's two-view results, at one RANSAC seed.

    python3 scripts/megaloc_sift_replay.py dump --out port_two_view.npz [--seeds 0-14]
    JAX_PLATFORMS=cpu python3 scripts/megaloc_sift_replay.py replay port_two_view.npz

``dump`` needs a CUDA card and no JAX: it renders chip_smoke.py's runner
folder (the 32 ring views of ``runner_scene`` at 480x640) on the card,
writes the seeded megaloc.torch (``chip_smoke.megaloc_fixture``) and runs
``gtsfm_tpu_torch.runner.main`` with ``megaloc_sift_frontend`` on the
card once for each of ``--seeds`` (``scene_optimizer.seed``; by default
0), as chip_smoke.py's megaloc_sift phase does, printing each run's
registered count, AUC@5 and valid pairs; it saves the first run's
keypoints, pairs and two-view results with its registered count and
AUC@5.

``replay`` runs on the CPU and imports JAX: it renders the same folder on
the CPU and runs, at the dump's seed, (1) the JAX runner as is, keeping its
keypoints and two-view results, (2) the JAX runner with its detector's
output and two-view results replaced by the dump's, (3) the port's runner
with them replaced by run 1's, (4) the port's runner with the dump's. The
retrieval runs in each (both packages retrieve from their own MegaLoc on
the same weights): a run whose pairs are not the injected results' pairs
stops. It prints one JSON line per run (registered, AUC@5, valid pairs)
and the four AUC@5 as a table: two-view results by row, back end by
column. Equal rows say the back ends agree and the two-view results set
the AUC@5.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

from gtsfm_tpu_torch.frontend.two_view import TwoViewResult  # noqa: E402
from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses  # noqa: E402

CONFIG = "megaloc_sift_frontend"
TWO_VIEW_KEYS = ("i2Ri1", "i2Ui1", "corr_i1", "corr_i2", "corr_mask", "num_matches", "num_inliers",
                 "inlier_ratio", "valid")


def write_folder(work: str, dev: torch.device) -> str:
    """chip_smoke.py's runner folder under ``work``, rendered on ``dev``."""
    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)
    views = chip_smoke.ring_views(R, t, dev, chip_smoke.runner_scene(t.mean(axis=0)), indices=order)
    data_dir = os.path.join(work, "data")
    chip_smoke.write_olsson(data_dir, views, R[order], t[order], chip_smoke.SPLAT_FOCAL)
    return data_dir


def inject(cls, replay: dict | None, keep: dict, to_result):
    """Wrap ``cls``'s ``_detect_batch`` and ``_run_two_view``: keep what
    they return in ``keep`` (numpy); with ``replay``, return its keypoints
    and, for its pairs, its two-view results (``to_result`` turns them into
    the package's type) instead. Returns the function that restores them."""
    detect, two_view = cls._detect_batch, cls._run_two_view

    def detect_batch(self, images, sizes):
        if replay is not None:
            kp_xy, kp_mask = replay["kp_xy"], replay["kp_mask"]
            descs = np.zeros(kp_xy.shape[:2] + (1,), np.float32)
        else:
            kp_xy, kp_mask, descs = detect(self, images, sizes)
        keep["kp_xy"], keep["kp_mask"] = np.asarray(kp_xy), np.asarray(kp_mask)
        return kp_xy, kp_mask, descs

    def run_two_view(self, pairs, *args, **kwargs):
        pairs = np.asarray(pairs).astype(np.int64)
        if "pairs" in keep:
            raise AssertionError("a second two-view call (bridge pairs): the results cannot be replayed")
        if replay is not None:
            if not np.array_equal(pairs, replay["pairs"]):
                raise AssertionError(f"retrieved {len(pairs)} pairs, not the replayed {len(replay['pairs'])}")
            out = to_result({k: replay[k] for k in TWO_VIEW_KEYS})
        else:
            out = two_view(self, pairs, *args, **kwargs)
        keep["pairs"] = pairs
        for k in TWO_VIEW_KEYS:
            v = out[k] if isinstance(out, dict) else getattr(out, k)
            keep[k] = np.asarray(v.cpu() if torch.is_tensor(v) else v)
        return out

    cls._detect_batch, cls._run_two_view = detect_batch, run_two_view

    def restore():
        cls._detect_batch, cls._run_two_view = detect, two_view

    return restore


def port_result(d: dict) -> TwoViewResult:
    """Two-view results (numpy) -> the port's TwoViewResult on the CPU."""
    nan = torch.full((len(d["valid"]),), float("nan"))
    return TwoViewResult(**{k: torch.as_tensor(d[k]) for k in TWO_VIEW_KEYS}, hf_ratio=nan, eig_ratio=nan.clone())


def port_run(argv: list, out: str, replay: dict | None, keep: dict) -> dict:
    """The port's runner with ``argv``, optionally on replayed results."""
    from gtsfm_tpu_torch import runner
    from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup
    from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer

    restore = inject(SceneOptimizer, replay, keep, port_result)
    try:
        rc = runner.main(argv + ["--output_root", out])
    finally:
        restore()
    mdir = os.path.join(out, "results", "metrics")
    groups = {g.name: {m.name: m for m in g.metrics}
              for g in (MetricsGroup.from_json(os.path.join(mdir, f)) for f in sorted(os.listdir(mdir)))}
    pose = groups.get("ba_pose_metrics", {})
    return {"rc": rc, "registered": len(pose["rotation_error_deg"].dist) if pose else 0,
            "auc5": pose["pose_auc_@5.0_deg"].scalar if pose else 0.0,
            "valid": int(groups["frontend_summary"]["num_valid_pairs"].scalar)}


def dump(args) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dump runs the port on a CUDA card")
    chip_smoke.phase_build()
    with tempfile.TemporaryDirectory() as work:
        data_dir = write_folder(work, torch.device("cuda"))
        weights = chip_smoke.write_deep_weights(work, ("megaloc",))
        for i, seed in enumerate(parse_seeds(args.seeds)):
            argv = ["--config_name", CONFIG, "--loader", "olsson", "--dataset_dirpath", data_dir,
                    f"scene_optimizer.seed={seed}"] + chip_smoke.deep_overrides(CONFIG, weights)
            keep = {}
            res = port_run(argv, os.path.join(work, f"out{seed}"), None, keep)
            print(json.dumps({"run": "port on the card", "seed": seed, **res}), flush=True)
            if i == 0:
                np.savez_compressed(args.out, seed=seed, registered=res["registered"], auc5=res["auc5"], **keep)
    return 0


def parse_seeds(text: str) -> tuple:
    """'0-14' or '0,2,5' -> a tuple of ints."""
    if "-" in text:
        lo, hi = text.split("-")
        return tuple(range(int(lo), int(hi) + 1))
    return tuple(int(x) for x in text.split(","))


def replay(args) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import deep_front_end_reference as ref
    from gtsfm_tpu import runner as j_runner
    from gtsfm_tpu.scene.scene_optimizer import SceneOptimizer as JaxSceneOptimizer

    port = dict(np.load(args.dump))
    seed = int(port["seed"])
    print(json.dumps({"run": "port on the card (the dump)", "seed": seed, "registered": int(port["registered"]),
                      "auc5": float(port["auc5"]), "valid": int(port["valid"].sum())}), flush=True)
    results = {}
    with tempfile.TemporaryDirectory() as work:
        data_dir = write_folder(work, torch.device("cpu"))
        weights = chip_smoke.write_deep_weights(work, ("megaloc",))
        argv = ["--config_name", CONFIG, "--loader", "olsson", "--dataset_dirpath", data_dir,
                f"scene_optimizer.seed={seed}"] + chip_smoke.deep_overrides(CONFIG, weights)

        def jax_run(out, replayed, keep):
            restore = inject(JaxSceneOptimizer, replayed, keep, lambda d: d)
            try:
                rc = j_runner.main(argv + [f"scene_optimizer.pair_batch_size={ref.REFERENCE_PAIR_BATCH}",
                                           "--output_root", out])
            finally:
                restore()
            metrics = ref.read_metrics(out)
            pose = metrics.get("ba_pose_metrics", {})
            return {"rc": rc, "registered": int(len(pose.get("rotation_error_deg", []))),
                    "auc5": float(pose.get("pose_auc_@5.0_deg", 0.0)),
                    "valid": int(metrics["frontend_summary"]["num_valid_pairs"])}

        cpu = argv + ["scene_optimizer.device=cpu"]
        jax_keep = {}
        for tag, fn in (("jax two-view, jax back end", lambda: jax_run(os.path.join(work, "jj"), None, jax_keep)),
                        ("port two-view, jax back end", lambda: jax_run(os.path.join(work, "pj"), port, {})),
                        ("jax two-view, port back end", lambda: port_run(cpu, os.path.join(work, "jp"), jax_keep, {})),
                        ("port two-view, port back end", lambda: port_run(cpu, os.path.join(work, "pp"), port, {}))):
            results[tag] = fn()
            print(json.dumps({"run": tag, "seed": seed, **results[tag]}), flush=True)
    print(f"AUC@5 at seed {seed}, two-view results by row, back end by column:")
    print(f"{'':16s} {'jax':>8s} {'port':>8s}")
    for rows in ("jax", "port"):
        print(f"{rows + ' two-view':16s} " + " ".join(
            f"{results[f'{rows} two-view, {col} back end']['auc5']:8.4f}" for col in ("jax", "port")))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--out", required=True)
    d.add_argument("--seeds", default="0", help="e.g. 0-14 or 0,2; the first one's results are saved")
    r = sub.add_parser("replay")
    r.add_argument("dump")
    args = ap.parse_args()
    return dump(args) if args.cmd == "dump" else replay(args)


if __name__ == "__main__":
    raise SystemExit(main())
