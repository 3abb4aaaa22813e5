#!/usr/bin/env python3
"""The JAX package's deep front ends on rendered views, on the CPU: the
reference numbers for chip_smoke.py's ``deep_front_end`` and
``megaloc_sift`` phases.

    JAX_PLATFORMS=cpu python3 scripts/deep_front_end_reference.py \
        [--configs deep_front_end,megaloc_sift_frontend] \
        [--out scripts/deep_front_end_reference.json]

The input is the one chip_smoke.py gives the port: the 32 ring views of its
``runner_scene`` rendered by the port on the CPU at 480x640, f=600, written
as an Olsson folder, and the same seeded weights, written to a temporary
directory and passed by override: SuperPoint in the MagicLeap layout
(``chip_smoke.superpoint_fixture(0)``), LightGlue in the official layout
(``chip_smoke.glue_fixture(0)``) and MegaLoc in the megaloc.torch layout
(``chip_smoke.megaloc_fixture(0)``). The reference's registry drops
``weights_path`` for ``netvlad``, so its NetVLAD is given the port's seeded
init through ``netvlad_params`` (the port's state_dict -> flax params).

It runs ``python -m gtsfm_tpu.runner --loader olsson`` with
``--config_name deep_front_end`` and then ``megaloc_sift_frontend`` in
this process, once for each seed of ``REFERENCE_SEEDS``
(``scene_optimizer.seed``: both runners' pose AUC@5 and registered count
move with RANSAC's draws), with
``scene_optimizer.pair_batch_size=16``: the reference's XLA
attention and similarity on the CPU hold a (P, 4, K, K) and a (P, K, K)
float32 tensor, 17 GB and 26 GB at the default 256. With a matcher the
reference keys each chunk's RANSAC by the chunk's first pair, so this
changes its draws, not its method (the mutual-NN path keys each pair by
its global index: chunking leaves its draws alone). LightGlue's matches
do not depend on the seed: they are computed in the first run and
replayed in the later ones. It prints one JSON line per run: the
registered cameras, the pose AUC@5, the pair counts and the stage
seconds; ``--out`` also gets, for each run, every pair with its
LightGlue or mutual-NN match count and whether it was valid, and a
checksum of each net's weights, which chip_smoke.py prints too. The runs
of configs not run again are kept in ``--out``.
``scripts/deep_front_end_reference.json``, which chip_smoke.py reads for
its bars, is the two configs' runs at ``REFERENCE_SEEDS`` (JAX 0.9.0).
On an 8-core CPU: the render 78-102 s, the first ``deep_front_end``
run about 14 minutes (LightGlue), each later seed 25-31 s, each
``megaloc_sift_frontend`` run 60-76 s. This script imports JAX; the port
never does.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

from gtsfm_tpu import runner  # noqa: E402
from gtsfm_tpu.frontend.global_descriptors import descriptors as j_descriptors  # noqa: E402
from gtsfm_tpu.frontend.matchers.lightglue import LightGlueMatcher  # noqa: E402
from gtsfm_tpu.scene.scene_optimizer import SceneOptimizer  # noqa: E402
from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import NetVLADDescriptor  # noqa: E402
from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses  # noqa: E402

REFERENCE_PAIR_BATCH = 16
# the seeds (scene_optimizer.seed) of scripts/deep_front_end_reference.json:
# chip_smoke.py's bars are the medians over them
REFERENCE_SEEDS = {"deep_front_end": tuple(range(5)), "megaloc_sift_frontend": tuple(range(15))}
REFERENCE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "deep_front_end_reference.json")


def netvlad_params(state_dict) -> dict:
    """The port's ``NetVLADNet`` state_dict -> the reference ``NetVLADNet``'s
    flax params (numpy): convs (O, I, kh, kw) -> (kh, kw, I, O), linears
    (out, in) -> (in, out)."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v, np.float32) for k, v in state_dict.items()}
    params = {f"conv{i}": {"kernel": sd[f"conv{i}.weight"].transpose(2, 3, 1, 0), "bias": sd[f"conv{i}.bias"]}
              for i in range(1, 5)}
    params["centers"] = sd["centers"]
    for name in ("assign", "proj"):
        params[name] = {"kernel": sd[f"{name}.weight"].T, "bias": sd[f"{name}.bias"]}
    return params


def use_port_netvlad(state_dict) -> None:
    """Make the reference registry's ``netvlad`` build its descriptor with
    the port's weights (it drops ``weights_path``)."""
    params = netvlad_params(state_dict)
    base = j_descriptors.NetVLADDescriptor

    class PortWeightsNetVLAD(base):
        def __init__(self, options=j_descriptors.NetVLADOptions(), params_=None):
            super().__init__(options, params=params)

    j_descriptors.NetVLADDescriptor = PortWeightsNetVLAD


def record_two_view(store: dict) -> None:
    """Keep each run's pairs, per-pair match counts and valid flags
    (``SceneOptimizer._run_two_view``'s result) in ``store``, and replay
    LightGlue's matches for inputs it has seen (they do not depend on the
    seed)."""
    run_two_view = SceneOptimizer._run_two_view
    match_batch = LightGlueMatcher.match_batch
    memo = {}

    def two_view(self, pairs, *args, **kwargs):
        out = run_two_view(self, pairs, *args, **kwargs)
        store.setdefault("pairs", []).extend(np.asarray(pairs).tolist())
        store.setdefault("num_matches", []).extend(np.asarray(out["num_matches"]).tolist())
        store.setdefault("valid", []).extend(np.asarray(out["valid"]).astype(int).tolist())
        return out

    def replayed(self, *args, **kwargs):
        key = tuple(float(np.asarray(a, np.float64).sum()) for a in args) + (str(kwargs),)
        if key not in memo:
            memo[key] = jax.device_get(match_batch(self, *args, **kwargs))
        return memo[key]

    SceneOptimizer._run_two_view = two_view
    LightGlueMatcher.match_batch = replayed


def weight_sumsq(sd) -> float:
    """A checksum of a state_dict: the sum of the squares of its values, in
    float64 (chip_smoke.py prints the same)."""
    return float(sum(np.square(np.asarray(v, np.float64)).sum() for v in sd.values()))


def read_metrics(output_root: str) -> dict:
    from gtsfm_tpu.evaluation.metrics import MetricsGroup

    mdir = os.path.join(output_root, "results", "metrics")
    out = {}
    for name in sorted(os.listdir(mdir)):
        g = MetricsGroup.from_json(os.path.join(mdir, name))
        out[g.name] = {m.name: (m.scalar if m.dist is None else m.dist) for m in g.metrics}
    return out


def run_config(name: str, data_dir: str, out_dir: str, overrides: list, store: dict) -> dict:
    store.clear()
    t0 = time.perf_counter()
    rc = runner.main(["--config_name", name, "--loader", "olsson", "--dataset_dirpath", data_dir,
                      "--output_root", out_dir] + overrides)
    wall = time.perf_counter() - t0
    metrics = read_metrics(out_dir)
    fe = metrics["frontend_summary"]
    pose = metrics.get("ba_pose_metrics", {})  # absent when the back end failed
    return {
        "config": name,
        "overrides": overrides,
        "registered": int(len(pose.get("rotation_error_deg", []))),
        "pose_auc_@5.0_deg": float(pose.get("pose_auc_@5.0_deg", 0.0)),
        "num_pairs": int(fe["num_pairs"]),
        "num_valid_pairs": int(fe["num_valid_pairs"]),
        "detect_describe_sec": fe["detect_describe_sec"],
        "two_view_sec": fe["two_view_sec"],
        "backend_sec": metrics["multiview_optimizer_metrics"]["backend_sec"],
        "total_runtime_sec": metrics["total_summary"]["total_runtime_sec"],
        "wall_sec": wall,
        "rc": rc,
        "pairs": store["pairs"],
        "num_matches_per_pair": store["num_matches"],
        "valid_per_pair": store["valid"],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=chip_smoke.NUM_CAMERAS)
    ap.add_argument("--configs", default="deep_front_end,megaloc_sift_frontend")
    ap.add_argument("--out", default=None, help="merged into: the runs of the configs not run here are kept")
    args = ap.parse_args()

    n = chip_smoke.NUM_CAMERAS
    gt = spectral_ring_poses(chip_smoke.ring_pairs(n), n)
    R, t = gt.R.numpy(), gt.t.numpy()
    order = chip_smoke.ring_order(t)[: args.views]
    t0 = time.perf_counter()
    views = chip_smoke.ring_views(R, t, torch.device("cpu"), chip_smoke.runner_scene(t.mean(axis=0)), indices=order)
    render_sec = time.perf_counter() - t0
    netvlad_sd = NetVLADDescriptor().net.state_dict()
    use_port_netvlad(netvlad_sd)
    store = {}
    record_two_view(store)
    out = {"views": len(order), "image_hw": list(chip_smoke.SPLAT_HW), "render_sec": render_sec,
           "pair_batch_size": REFERENCE_PAIR_BATCH, "jax": jax.__version__, "device": "cpu", "runs": []}
    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "data")
        chip_smoke.write_olsson(data_dir, views, R[order], t[order], chip_smoke.SPLAT_FOCAL)
        weights = chip_smoke.write_deep_weights(work)
        out["weight_sumsq"] = dict(weights["sumsq"], netvlad=weight_sumsq(netvlad_sd))
        for name in args.configs.split(","):
            seeds = REFERENCE_SEEDS[name]
            runs = []
            for seed in seeds:
                overrides = chip_smoke.deep_overrides(name, weights) + [
                    f"scene_optimizer.pair_batch_size={REFERENCE_PAIR_BATCH}", f"scene_optimizer.seed={seed}"]
                res = run_config(name, data_dir, os.path.join(work, f"{name}_{seed}"), overrides, store)
                res["overrides"] = [o.replace(work, "<tmp>") for o in res["overrides"]]
                print(json.dumps({k: v for k, v in res.items() if not isinstance(v, list)}), flush=True)
                runs.append(res)
            out["runs"] += runs
            print(json.dumps({"config": name, "seeds": list(seeds),
                              "median_registered": float(np.median([r["registered"] for r in runs])),
                              "median_pose_auc_@5.0_deg": float(np.median([r["pose_auc_@5.0_deg"] for r in runs]))}),
                  flush=True)
    if args.out:
        if os.path.exists(args.out):
            with open(args.out) as f:
                kept = [r for r in json.load(f)["runs"] if r["config"] not in args.configs.split(",")]
            out["runs"] = kept + out["runs"]
        head = json.dumps({k: v for k, v in out.items() if k != "runs"})
        with open(args.out, "w") as f:
            f.write(head[:-1] + ', "runs": [\n' + ",\n".join(json.dumps(r) for r in out["runs"]) + "\n]}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
