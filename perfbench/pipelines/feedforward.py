"""The feed-forward cluster slot with VGGT in the public layout: each pass
builds an Olsson loader over one cluster of consecutive views of the loop
and runs ``SceneOptimizer.run`` on it, as ``--config vggt1b`` runs a
cluster: the slot's VGGT forward (the products), the track head on frame
0's confident patches (a second aggregator pass), the post-BA and the
common tail. A pass counts the cluster's views, and as ``failed`` those
left without a finite pose.

The checkpoint (perfbench/vggt_weights.py) is seeded from the run's seed
and given to the program by path. The model is built by the warm-up pass,
through the slot's own cache; then its ``run`` and ``track`` are wrapped on
the instance to keep each call's inputs and outputs. The check holds the
last pass's against the plain reference (perfbench/reference/vggt.py) on
the same images and query points, with the same checkpoint:

- ``pose_gap``: the largest absolute gap of the 9 pose-encoding values
  (translation, unit quaternion, fields of view, read back from the
  extrinsics and intrinsics on both sides);
- ``depth_gap``, ``conf_gap``: the largest relative gap of depth and of its
  confidence;
- ``track_gap_px``: the largest gap of the final track positions;
- ``vis_gap``: the largest gap of visibility times confidence;
- ``views_missing``: views of the last pass without a finite pose (exact).

In a traced run the program's spans (utils/tracing.py) of ``SPAN_RANGES``
are added to the run's ranges after each pass, so the trace gives each its
device time, and each pass adds the work of its attention spans and of the
model (perfbench/counts/vggt.py)."""

from __future__ import annotations

import copy
import json
import os
import sys

import numpy as np
import torch

from perfbench import vggt_weights
from perfbench.counts import vggt as counts

SPAN_RANGES = ("vggt.aggregator", "vggt.dino", "vggt.frame", "vggt.global", "vggt.attention", "vggt.camera_head",
               "vggt.depth_head", "vggt.track_head", "feedforward.tracks", "feedforward.ba")


def with_overrides(config: dict, overrides: dict | None) -> dict:
    """The configuration with dotted ``overrides`` applied to its ``model``
    (the checkpoint's sizes)."""
    config = copy.deepcopy(config)
    for key, value in (overrides or {}).items():
        node = config["model"]
        for part in key.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[key.split(".")[-1]] = value
    return config


def write_clusters(scene_dir: str, root: str, size: int) -> list:
    """One Olsson folder per start view: ``size`` consecutive views of the
    loop (wrapping around), linked from the scene's images in loop order,
    with their projection matrices. Returns the folders by start."""
    import scipy.io

    names = sorted(os.listdir(os.path.join(scene_dir, "images")))
    P = scipy.io.loadmat(os.path.join(scene_dir, "data.mat"))["P"]
    n = len(names)
    folders = []
    for start in range(n):
        folder = os.path.join(root, f"{start:03d}")
        os.makedirs(os.path.join(folder, "images"))
        idx = [(start + i) % n for i in range(size)]
        sub = np.empty((1, size), object)
        for j, i in enumerate(idx):
            os.symlink(os.path.join(scene_dir, "images", names[i]),
                       os.path.join(folder, "images", f"{j:03d}{os.path.splitext(names[i])[1]}"))
            sub[0, j] = P[0, i]
        scipy.io.savemat(os.path.join(folder, "data.mat"), {"P": sub})
        folders.append(folder)
    return folders


def pose_encoding(extrinsic: np.ndarray, intrinsic: np.ndarray, hw, like: np.ndarray | None = None) -> np.ndarray:
    """(S, 9): translation, the rotation's unit quaternion (real part last;
    its sign that of ``like``'s, else a non-negative real part), the
    vertical and horizontal fields of view of images of size hw."""
    R = extrinsic[:, :, :3].astype(np.float64)
    w = np.sqrt(np.maximum(0.0, 1 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2])) / 2
    x = np.sqrt(np.maximum(0.0, 1 + R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2])) / 2
    y = np.sqrt(np.maximum(0.0, 1 - R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2])) / 2
    z = np.sqrt(np.maximum(0.0, 1 - R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2])) / 2
    x = np.copysign(x, R[:, 2, 1] - R[:, 1, 2])
    y = np.copysign(y, R[:, 0, 2] - R[:, 2, 0])
    z = np.copysign(z, R[:, 1, 0] - R[:, 0, 1])
    q = np.stack([x, y, z, w], axis=-1)
    ref = like[:, 3:7] if like is not None else np.tile([0.0, 0, 0, 1], (len(q), 1))
    q = np.where(np.sum(q * ref, axis=-1, keepdims=True) < 0, -q, q)
    H, W = hw
    fov_h = 2 * np.arctan((H / 2.0) / intrinsic[:, 1, 1].astype(np.float64))
    fov_w = 2 * np.arctan((W / 2.0) / intrinsic[:, 0, 0].astype(np.float64))
    return np.concatenate([extrinsic[:, :, 3], q, fov_h[:, None], fov_w[:, None]], axis=-1)


def _rel_gap(a, b) -> float:
    return float(np.max(np.abs(a.astype(np.float64) - b) / np.maximum(np.abs(b.astype(np.float64)), 1e-30)))


def compare(prog: dict, ref: dict, hw) -> dict:
    """The check's numbers (all but ``views_missing``) of the program's
    products and tracks against the reference's."""
    ref_enc = pose_encoding(ref["extrinsic"], ref["intrinsic"], hw)
    prog_enc = pose_encoding(prog["extrinsic"], prog["intrinsic"], hw, like=ref_enc)
    seen = {k: v["vis"].astype(np.float64) * v["conf"] for k, v in (("prog", prog), ("ref", ref))}
    return {"pose_gap": float(np.max(np.abs(prog_enc - ref_enc))),
            "depth_gap": _rel_gap(prog["depth"], ref["depth"]),
            "conf_gap": _rel_gap(prog["depth_conf"], ref["depth_conf"]),
            "track_gap_px": float(np.max(np.abs(prog["tracks"].astype(np.float64) - ref["tracks"]))),
            "vis_gap": float(np.max(np.abs(seen["prog"] - seen["ref"])))}


class Pipeline:
    ORDER = ("pose_gap", "depth_gap", "conf_gap", "track_gap_px", "vis_gap", "views_missing")
    ATTEMPTED = "views"

    def __init__(self, config: dict, traffic: dict, scene_dir: str, views: dict, seed: int, work: str, device: str,
                 spans, overrides: dict | None = None):
        from gtsfm_tpu_torch.configs.config import build_scene_optimizer, load_config

        config = with_overrides(config, overrides)
        settings = load_config(config["program_config"])
        if settings != config["settings"]:
            raise RuntimeError(f"the program's {config['program_config']} configuration differs from the "
                               f"benchmark's copy: {settings} != {config['settings']}")
        self.model, self.spans, self.device = config["model"], spans, device
        self.max_resolution = traffic["max_resolution"]
        self.clusters = write_clusters(scene_dir, os.path.join(work, "clusters"), traffic["cluster_views"])
        self.weights = vggt_weights.write(self.model, seed, os.path.join(work, "weights", "vggt.pt"), device)
        cfg = copy.deepcopy(settings)
        cfg["scene_optimizer"].update(device=device, vggt_weights_path=self.weights)
        self.program = build_scene_optimizer(cfg)
        self.kept, self.last, self.vggt, self.passes, self._seen = {}, None, None, 0, 0

    # ------------------------------------------------------------ the program's model
    def _install(self) -> None:
        """Wrap the cached VGGTModel's ``run`` and ``track`` on the instance."""
        from gtsfm_tpu_torch.scene import cluster_feedforward

        model = next(m for k, m in cluster_feedforward._MODEL_CACHE.items()
                     if k[0] == "vggt_exact" and k[1] == self.weights)
        inner_run, inner_track = model.run, model.track

        def run(images):
            out = inner_run(images)
            self.kept["products"] = (images, out)
            return out

        def track(images, query_points):
            out = inner_track(images, query_points)
            self.kept["tracks"] = (query_points, out)
            return out

        model.run, model.track = run, track
        self.vggt = model

    def warm(self) -> None:
        self.run_pass(0)
        self._install()

    def run_pass(self, seed: int) -> dict:
        from gtsfm_tpu_torch.loader.olsson import OlssonLoader

        start = int(np.random.default_rng([seed, 3]).integers(len(self.clusters)))
        loader = OlssonLoader(self.clusters[start], max_resolution=self.max_resolution)
        data, _groups = self.program.run(loader)
        finite = data.pose_mask & torch.isfinite(data.poses.R).flatten(1).all(1) & torch.isfinite(data.poses.t).all(1)
        missing = len(loader) - int(finite.sum())
        self.last = {"start": start, "missing": missing, **self.kept}
        self.passes += 1
        if self.spans.traced and "products" in self.kept:
            self._trace_pass()
        print(f"perfbench: pass {self.passes}: cluster at view {start}, {data.number_tracks()} tracks, "
              f"{missing} views without a pose", file=sys.stderr, flush=True)
        return {"views": len(loader), "failed": missing}

    def _trace_pass(self) -> None:
        """The pass's program spans as the run's ranges; the work of its
        attention spans and of the model."""
        from gtsfm_tpu_torch.utils import tracing

        records = tracing.spans()
        new, self._seen = records[self._seen:], len(records)
        names = {r["id"]: r for r in new}
        C = self.model["embed_dim"]
        for r in new:
            if r["name"] in SPAN_RANGES:
                self.spans.ranges.append((r["name"], r["start_ns"], r["end_ns"]))
            if r["name"] == "vggt.attention":
                parent = names[r["parent"]]  # vggt.frame or vggt.global, units frames
                seq = r["units"] if parent["name"] == "vggt.global" else r["units"] // parent["units"]
                self.spans.add_work("vggt_attention", *counts.attention_work(r["units"], seq, C))
        images = self.last["products"][0]
        S, H, W = images.shape[:3]
        self.spans.add_work("vggt_model", counts.pass_flops(self.model, S, H, W, len(self.last["tracks"][0])), 0.0)

    def counters(self) -> dict:
        from gtsfm_tpu_torch.frontend import vggt
        from gtsfm_tpu_torch.utils import numerics

        return {"vggt_aggregator_passes": getattr(vggt, "VGGT_AGGREGATOR_PASSES", None),
                "attention_chunks": getattr(numerics, "ATTENTION_CHUNKS", None)}

    def context(self) -> dict:
        return {}

    def close(self) -> None:
        """Unwrap the model and drop it from the slot's cache with the scene
        optimizer; the last pass's inputs and outputs stay."""
        from gtsfm_tpu_torch.scene import cluster_feedforward

        if self.vggt is not None:
            del self.vggt.run, self.vggt.track
        for key in [k for k in cluster_feedforward._MODEL_CACHE if k[0] == "vggt_exact" and k[1] == self.weights]:
            del cluster_feedforward._MODEL_CACHE[key]
        self.program = self.vggt = None
        self.kept = {}

    def check(self, params: dict, control: bool = False) -> tuple:
        from perfbench.reference import vggt as reference

        images, out = self.last["products"]
        queries, tracks = self.last["tracks"]
        prog = {k: v.cpu().numpy() for k, v in {**out, **tracks}.items()}
        hw = images.shape[1:3]
        print(f"perfbench: the last pass: cluster at view {self.last['start']}, {images.shape[0]} views of "
              f"{hw[0]} x {hw[1]}, {len(queries)} queries", file=sys.stderr, flush=True)
        net = reference.load(self.weights, reference.dims_from(self.model), self.device)
        ref = reference.run(net, images, queries)
        nums = compare(prog, ref, hw)
        nums["views_missing"] = self.last["missing"]
        low = None
        if control:
            low = compare(reference.run(net, images, queries, tf32=True), ref, hw)
            low["views_missing"] = 0
        print(f"perfbench: check numbers {json.dumps(nums)}", file=sys.stderr, flush=True)
        return nums, low
