"""Every call the benchmark makes into the program, ``gtsfm_tpu_torch``.

The configuration is built as the runner builds it
(``configs.config.load_config`` then ``build_scene_optimizer``) and the
scene is read through the port's ``OlssonLoader``, as ``--loader olsson``
reads it. A front-end pass drives the scene optimizer's own stage calls in
the order ``SceneOptimizer._run_impl`` makes them: load, detect and
describe every view with its global descriptor, retrieve the pairs,
estimate two-view geometry over chunks of ``pair_batch_size`` pairs
through the optimizer's chunk loop, and copy the results to the host.
Bridge pairs and the back end are not part of a pass.

The benchmark's spans sit around the layers' entries. The detector, the
global descriptor, the retriever and a learned matcher are handed to the
scene optimizer behind proxies; the two-view batch, the fused mutual-NN
matcher and LightGlue's attention entries are wrapped where the program
looks them up (a module attribute). The wrappers keep the outputs of one
chunk, drawn from the seed, for the check. When the program renames one
of these, this file is the one to change.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field

import numpy as np
import torch

SCENE_OPTIMIZER = "gtsfm_tpu_torch.scene.scene_optimizer"
TWO_VIEW = "gtsfm_tpu_torch.frontend.two_view"
ATTENTION = "gtsfm_tpu_torch.frontend.matchers.fused_attention"
ATTENTION_ENTRIES = ("fused_attention", "fused_attention_merged", "fused_cross_attention",
                     "fused_cross_attention_merged")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclass
class Spans:
    """Per-layer spans and work of a traced run: name -> [seconds],
    [units]; the host intervals (name, start_ns, end_ns) on
    ``time.time_ns``'s clock, which the trace's device operations are laid
    against; and the work (operations, bytes) of device ranges, kept as
    device tensors until the window closes."""

    traced: bool = False
    seconds: dict = field(default_factory=dict)
    units: dict = field(default_factory=dict)
    ranges: list = field(default_factory=list)
    work: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    def clear(self) -> None:
        for store in (self.seconds, self.units, self.ranges, self.work, self.counters):
            store.clear()

    def add_work(self, name: str, flops, nbytes: float) -> None:
        self.work.setdefault(name, []).append((flops, nbytes))

    def count(self, name: str, value) -> None:
        self.counters.setdefault(name, []).append(value)

    def timed(self, name: str, fn, units, *args, **kwargs):
        """fn(*args) inside a span; in a traced run the device is
        synchronized at both ends, so the span holds the layer's device
        work and nothing before it."""
        if not self.traced:
            return fn(*args, **kwargs)
        _sync()
        t0 = time.time_ns()
        out = fn(*args, **kwargs)
        _sync()
        t1 = time.time_ns()
        self.ranges.append((name, t0, t1))
        self.seconds.setdefault(name, []).append((t1 - t0) * 1e-9)
        self.units.setdefault(name, []).append(units)
        return out

    def ranged(self, name: str, fn, *args, **kwargs):
        """fn(*args) inside a host interval, with no synchronization: the
        trace gives the range the device operations launched inside it."""
        t0 = time.time_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            self.ranges.append((name, t0, time.time_ns()))

    def totals(self) -> dict:
        """The work of each device range, summed (one host copy)."""
        out = {}
        for name, items in self.work.items():
            flops = sum(float(f) if not torch.is_tensor(f) else f.double().sum().item() for f, _ in items)
            out[name] = (flops, float(sum(b for _, b in items)))
        return out


class _Proxy:
    """An object behind which the scene optimizer sees the wrapped one;
    ``methods`` maps a method name to its replacement."""

    def __init__(self, inner, **methods):
        self._inner = inner
        self.__dict__.update(methods)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __len__(self):
        return len(self._inner)


@dataclass
class PassOutput:
    """What a pass produced, on the host, and the chunk kept for the check."""

    seed: int
    kp_xy: np.ndarray
    kp_mask: np.ndarray
    descs: np.ndarray
    pairs: np.ndarray
    result: dict  # TwoViewResult's fields as numpy, one row per pair
    chunk: dict  # the checked chunk: its first pair and the matcher's outputs
    stage_s: list  # host seconds of load-and-detect, retrieval, two-view


class FrontEnd:
    """The scene optimizer of one configuration over one scene folder."""

    def __init__(self, config: dict, weights: dict, scene_dir: str, max_resolution: int, device: str,
                 spans: Spans, check_chunk: int, overrides: dict | None = None):
        from gtsfm_tpu_torch.configs.config import build_scene_optimizer, load_config
        from gtsfm_tpu_torch.loader.olsson import OlssonLoader

        cfg = load_config(config["program_config"])
        if cfg != config["settings"]:
            raise RuntimeError(f"the program's {config['program_config']} configuration differs from the "
                               f"benchmark's copy: {cfg} != {config['settings']}")
        cfg = copy.deepcopy(cfg)
        for section, path in weights.items():
            cfg[section]["weights_path"] = path
        cfg.setdefault("scene_optimizer", {})["device"] = device
        for key, value in (overrides or {}).items():  # the CPU tests' small shapes
            node = cfg
            for part in key.split(".")[:-1]:
                node = node.setdefault(part, {})
            node[key.split(".")[-1]] = value
        self.so = build_scene_optimizer(cfg)
        self.loader = OlssonLoader(scene_dir, max_resolution=max_resolution)
        self.spans = spans
        self.check_chunk = check_chunk
        self.device = torch.device(device)
        self.pair_batch = self.so.options.pair_batch_size
        from gtsfm_tpu_torch.retriever.retrievers import JointSimilaritySequentialRetriever, SimilarityRetriever

        self.want_global = isinstance(self.so.retriever, (SimilarityRetriever, JointSimilaritySequentialRetriever))
        self._chunk_index = 0
        self._chunk = {}
        self._in_attention = False
        self._wrapped = []
        # the program's functions the wrappers call, looked up at each call
        self.inner = {}
        self._install()

    # -------------------------------------------------------------- proxies
    def _install(self) -> None:
        import importlib

        so, spans = self.so, self.spans
        loader = self.loader
        self.loader_proxy = _Proxy(loader, load_grayscale_batch=lambda indices=None, **k: spans.timed(
            "load_images", loader.load_grayscale_batch, len(indices) if indices is not None else len(loader),
            indices=indices, **k))
        det = so.detector
        self.inner["detect_batch"] = det.detect_batch
        so.detector = _Proxy(det, detect_batch=lambda images: spans.timed(
            "detect", self.inner["detect_batch"], int(images.shape[0]), images))
        if self.want_global:
            gd = so._global_descriptor()
            so.global_descriptor = _Proxy(gd, describe_batch=lambda images: spans.timed(
                "global_descriptor", gd.describe_batch, int(images.shape[0]), images))
        retr = so.retriever
        so.retriever = _Proxy(retr, get_image_pairs=lambda *a, **k: spans.timed(
            "retrieve", retr.get_image_pairs, 1, *a, **k))
        if so.matcher is not None:
            matcher = so.matcher
            self.inner["match_batch"] = matcher.match_batch

            def match_batch(desc1, desc2, kp1, kp2, m1, m2, image_size):
                if spans.traced:
                    spans.count("lightglue_valid", (m1.sum(-1), m2.sum(-1)))
                out = spans.timed("lightglue", self.inner["match_batch"], int(desc1.shape[0]),
                                  desc1, desc2, kp1, kp2, m1, m2, image_size=image_size)
                self._keep(out)
                return out

            so.matcher = _Proxy(matcher, match_batch=match_batch)

        sopt = importlib.import_module(SCENE_OPTIMIZER)
        two_view = importlib.import_module(TWO_VIEW)
        self.inner["run_two_view_batch"] = sopt.run_two_view_batch

        def two_view_batch(*args, **kwargs):
            out = spans.timed("two_view", self.inner["run_two_view_batch"], int(args[0].shape[0]), *args,
                              **kwargs)
            self._chunk_index += 1
            return out

        self.inner["fused_match_descriptors"] = two_view.fused_match_descriptors

        def match_descriptors(desc1, desc2, mask1, mask2, *args, **kwargs):
            if spans.traced:
                from perfbench.counts.mutual_nn import mutual_nn_work

                spans.add_work("mutual_nn", *mutual_nn_work(desc1, desc2, mask1, mask2))
            out = spans.timed("mutual_nn", self.inner["fused_match_descriptors"], int(desc1.shape[0]),
                              desc1, desc2, mask1, mask2, *args, **kwargs)
            self._keep(out)
            return out

        self._patch(sopt, "run_two_view_batch", two_view_batch)
        self._patch(two_view, "fused_match_descriptors", match_descriptors)
        if spans.traced and so.matcher is not None:
            attention = importlib.import_module(ATTENTION)
            for name in ATTENTION_ENTRIES:
                self._patch(attention, name, self._attention_range(name, getattr(attention, name)))

    def _attention_range(self, name: str, fn):
        spans = self.spans

        def entry(*args, **kwargs):
            # an entry may call another (the cross entry runs the self entry
            # twice): the outermost call counts the work and opens the range
            if self._in_attention:
                return fn(*args, **kwargs)
            from perfbench.counts.attention import attention_work

            flops, nbytes = attention_work(name, *args, **kwargs)
            spans.add_work("attention", flops, nbytes)
            self._in_attention = True
            try:
                return spans.ranged("attention", fn, *args, **kwargs)
            finally:
                self._in_attention = False

        return entry

    def _patch(self, module, name: str, fn) -> None:
        self._wrapped.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def _keep(self, out) -> None:
        if self._chunk_index == self.check_chunk:
            self._chunk = {"match_idx": out[0], "match_mask": out[1], "match_score": out[2]}

    def close(self) -> None:
        """Put the program's functions back and drop its state."""
        for module, name, fn in reversed(self._wrapped):
            setattr(module, name, fn)
        self._wrapped.clear()
        self.so = None

    # -------------------------------------------------------------- passes
    def calibration(self):
        from gtsfm_tpu_torch.loader.base import batch_calibrations

        return batch_calibrations(self.loader.get_all_intrinsics()).map(lambda a: a.to(self.device))

    def detect(self):
        """Stage 1: load, detect and describe every view."""
        return self.so._load_detect_chunked(self.loader_proxy, self.want_global)

    def retrieve(self, global_descs) -> np.ndarray:
        """Stage 2: the retriever's pairs."""
        n = len(self.loader)
        return np.asarray(self.so.retriever.get_image_pairs(n, global_descriptors=global_descs, loader=self.loader),
                          np.int64).reshape(-1, 2)

    def two_view(self, pairs, kp_xy, kp_mask, descs, cal, sizes):
        """Stage 3 on ``pairs`` through the optimizer's chunk loop."""
        image_wh = (max(w for (_h, w) in sizes), max(h for (h, _w) in sizes))
        return self.so._run_two_view(pairs, kp_xy, kp_mask, descs, cal, image_wh)

    def warm(self, gray: np.ndarray) -> int:
        """Every shape of a pass once, from the rendered views ``gray``
        (N, H, W) in place of the files (decoding has no device shapes):
        detection and global description of the whole scene, the
        retriever, one full chunk of pairs and the last partial one.
        Returns the pair count."""
        cal = self.calibration()
        sizes = [tuple(gray.shape[1:])] * len(gray)
        images = torch.as_tensor(gray, device=self.device)
        kp_xy, kp_mask, descs = self.so._detect_batch(images, sizes)
        gdescs = self.so.global_descriptor.describe_batch(images) if self.want_global else None
        del images
        pairs = self.retrieve(gdescs)
        B = self.pair_batch
        parts = [pairs[:B]]
        if len(pairs) % B and len(pairs) > B:
            parts.append(pairs[-(len(pairs) % B):])
        for part in parts:
            self._chunk_index = 0
            self.two_view(part, kp_xy, kp_mask, descs, cal, sizes)
        _sync()
        return len(pairs)

    def run_pass(self, seed: int) -> PassOutput:
        """One front-end pass with the two-view stage's seed ``seed``."""
        so = self.so
        so.options = so.options._replace(seed=seed)
        self._chunk_index = 0
        self._chunk = {}
        t = [time.perf_counter()]  # stage ends: each stage ends in a host copy, so no sync is added
        cal = self.calibration()
        kp_xy, kp_mask, descs, gdescs, sizes, _ = self.spans.timed("load_detect", self.detect, len(self.loader))
        t.append(time.perf_counter())
        pairs = self.retrieve(gdescs)
        t.append(time.perf_counter())
        tvr = self.spans.timed("two_view_stage", self.two_view, len(pairs), pairs, kp_xy, kp_mask, descs, cal,
                               sizes)
        result = {k: getattr(tvr, k).cpu().numpy() for k in tvr.__dataclass_fields__}
        t.append(time.perf_counter())
        chunk = {k: v.cpu().numpy() for k, v in self._chunk.items()}
        chunk["start"] = self.check_chunk * self.pair_batch
        return PassOutput(seed, kp_xy, kp_mask, descs, pairs, result, chunk, np.diff(t).tolist())


def layer_counters() -> dict:
    """The program's launch counters the benchmark reads as checks on the
    path: attention launches, mutual-NN calls and DoG-SIFT calls by device."""
    import importlib

    out = {}
    for key, module, attr in (("attention_launches", ATTENTION, "launch_count"),
                              ("mutual_nn_launches", "gtsfm_tpu_torch.frontend.matchers.fused_matcher",
                               "launch_count")):
        out[key] = getattr(importlib.import_module(module), attr)
    dog = importlib.import_module("gtsfm_tpu_torch.frontend.detectors.dog_sift")
    out["dog_sift_calls"] = dict(dog.calls_by_device)
    return out
