"""The detector-and-matcher front end: detect every view with its global
descriptor, retrieve the pairs, and match and verify them chunk by chunk,
as the scene optimizer's front end runs (perfbench/adapter.py). A pass
counts its views and its pairs. The check (perfbench/check.py) holds the
last pass's detector batches and one chunk of pairs, drawn from the seed,
against the plain reference in perfbench/reference/."""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from perfbench import adapter, check, weights


def with_overrides(config: dict, overrides: dict | None) -> dict:
    """The configuration with dotted ``overrides`` applied to its settings."""
    config = json.loads(json.dumps(config))
    for key, value in (overrides or {}).items():
        node = config["settings"]
        for part in key.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[key.split(".")[-1]] = value
    return config


class Pipeline:
    ORDER = check.ORDER
    ATTEMPTED = "pairs"

    def __init__(self, config: dict, traffic: dict, scene_dir: str, views: dict, seed: int, work: str, device: str,
                 spans: adapter.Spans, overrides: dict | None = None):
        self.config, self.scene_dir, self.seed, self.device, self.overrides = config, scene_dir, seed, device, overrides
        self.meta = {k: views[k] for k in ("focal", "width", "height")}
        self.n_views = len(views["images"])
        self.gray = views["images"].astype(np.float32) @ np.asarray([0.299, 0.587, 0.114], np.float32) / 255.0
        self.weights = weights.write(config, seed, os.path.join(work, "weights"), device)
        self.program = adapter.FrontEnd(config, self.weights, scene_dir, traffic["max_resolution"], device, spans, -1,
                                        overrides)
        self.pair_batch, self.image_batch = self.program.pair_batch, self.program.so.options.image_batch_size
        self.passes, self.last = 0, None

    def warm(self) -> None:
        n_pairs = self.program.warm(self.gray)
        self.gray = None
        self.program.check_chunk = check.check_chunk(self.seed, n_pairs, self.pair_batch)

    def run_pass(self, seed: int) -> dict:
        out = self.last = self.program.run_pass(seed)
        self.passes += 1
        print(f"perfbench: pass {self.passes}: {len(out.pairs)} pairs, stages (load-detect, retrieve, two-view) "
              f"{', '.join(f'{s:.3f}' for s in out.stage_s)} s", file=sys.stderr, flush=True)
        return {"views": self.n_views, "pairs": len(out.pairs),
                "failed": max(0, len(out.pairs) - len(out.result["valid"]))}

    def counters(self) -> dict:
        return adapter.layer_counters()

    def context(self) -> dict:
        return {"detector_hw": (self.meta["height"], self.meta["width"])}

    def close(self) -> None:
        self.program.close()
        self.program = None

    def check(self, params: dict, control: bool = False) -> tuple:
        out = self.last
        print(f"perfbench: the last pass: {-(-len(out.pairs) // self.pair_batch)} chunks, "
              f"{int(out.result['valid'].sum())} valid pairs, {int(out.kp_mask.sum())} keypoints, "
              f"{int(out.result['num_matches'].sum())} matches", file=sys.stderr, flush=True)
        ref = check.Reference(with_overrides(self.config, self.overrides), self.weights, self.meta, self.scene_dir,
                              self.device)
        batches = check.sample(self.seed, self.n_views, self.image_batch, params["detector_batches"])
        start = out.chunk["start"]
        chunk = out.pairs[start:start + self.pair_batch]
        nums = check.compare(ref, out, batches, chunk, start, out.chunk)
        nums["rows_missing"] = check.rows_missing(out, self.config["settings"]["retriever"]["max_frame_lookahead"])
        low = check.compare(ref, out, batches, chunk, start, out.chunk, control=True) if control else None
        return nums, low
