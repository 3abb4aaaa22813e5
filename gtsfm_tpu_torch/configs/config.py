"""Config system: YAML -> nested option tuples and the component tree.

Port of gtsfm_tpu/configs/config.py: YAML dicts map onto the port's
NamedTuple option types by field name, with dotted CLI overrides
(``key.subkey=value``), and ``build_scene_optimizer`` composes the
retriever and the front-end components through frontend/registry.py. The
named configs are the port's copies in this directory, those whose
components are all ported. A config that names a component or an option
field that no option tuple has raises before any work.
"""

from __future__ import annotations

import os

import yaml

from gtsfm_tpu_torch.averaging.rotation.averaging import RotationAveragingOptions
from gtsfm_tpu_torch.averaging.translation.averaging import TranslationAveragingOptions
from gtsfm_tpu_torch.bundle.ba import BAOptions
from gtsfm_tpu_torch.bundle.triangulation import TriangulationMode
from gtsfm_tpu_torch.frontend.detectors.dog_sift import DoGSiftOptions
from gtsfm_tpu_torch.frontend.two_view import TwoViewOptions
from gtsfm_tpu_torch.frontend.verifiers.essential import RansacOptions
from gtsfm_tpu_torch.retriever.retrievers import (
    ExhaustiveRetriever,
    JointSimilaritySequentialRetriever,
    RetrieverOptions,
    SequentialRetriever,
    SimilarityRetriever,
)
from gtsfm_tpu_torch.scene.mvo import MVOOptions
from gtsfm_tpu_torch.scene.scene_optimizer import SceneOptimizer, SceneOptimizerOptions
from gtsfm_tpu_torch.view_graph.cycle_consistency import ViewGraphOptions

CONFIG_DIR = os.path.dirname(__file__)

_RETRIEVERS = {
    "sequential": SequentialRetriever,
    "exhaustive": ExhaustiveRetriever,
    "similarity": SimilarityRetriever,
    "joint": JointSimilaritySequentialRetriever,
}

_NESTED = {
    "ransac": RansacOptions,
    "view_graph": ViewGraphOptions,
    "rotation": RotationAveragingOptions,
    "translation": TranslationAveragingOptions,
    "ba": BAOptions,
    "detector": DoGSiftOptions,
    "two_view": TwoViewOptions,
    "mvo": MVOOptions,
}


def _build(nt_type, d: dict):
    """An option tuple from a dict, recursing into nested option fields."""
    kwargs = {}
    for k, v in (d or {}).items():
        if k not in nt_type._fields:
            raise NotImplementedError(f"{nt_type.__name__} has no option {k!r} (fields: {', '.join(nt_type._fields)})")
        if k in _NESTED and isinstance(v, dict):
            kwargs[k] = _build(_NESTED[k], v)
        elif k == "triangulation_mode" and isinstance(v, str):
            kwargs[k] = TriangulationMode[v]
        elif k == "reproj_thresholds" and isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return nt_type(**kwargs)


def apply_overrides(cfg: dict, overrides: list) -> dict:
    """Apply dotted key=value overrides (``mvo.ba.max_iterations=50``)."""
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(val)
    return cfg


def load_config(name_or_path: str = "unified", overrides: list = None) -> dict:
    """Load a named config (gtsfm_tpu_torch/configs/<name>.yaml) or a path."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(CONFIG_DIR, f"{name_or_path}.yaml")
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    return apply_overrides(cfg, overrides)


def build_scene_optimizer(cfg: dict) -> SceneOptimizer:
    """Compose the object tree from a config dict.

    Top-level sections: ``scene_optimizer`` (options), ``retriever``,
    ``detector``, ``matcher``, ``global_descriptor`` and
    ``correspondence``, the last four name-dispatched through
    frontend/registry.py. A detector dict may also live at
    ``scene_optimizer.detector`` (then it is DoG-SIFT)."""
    from gtsfm_tpu_torch.frontend.registry import (
        build_correspondence,
        build_detector,
        build_global_descriptor,
        build_matcher,
    )

    so_cfg = dict(cfg.get("scene_optimizer") or {})
    det_cfg = cfg.get("detector")
    if det_cfg is None:
        det_cfg = dict(so_cfg.get("detector") or {})
        det_cfg.setdefault("name", "dog_sift")
    if det_cfg.get("name", "dog_sift") != "dog_sift":
        so_cfg.pop("detector", None)  # other detectors do not parse as DoGSiftOptions
    so_opts = _build(SceneOptimizerOptions, so_cfg)

    retr_cfg = dict(cfg.get("retriever") or {})
    retr_name = retr_cfg.pop("name", "sequential")
    if retr_name not in _RETRIEVERS:
        raise ValueError(f"Unknown retriever: {retr_name!r}")
    retr_cls = _RETRIEVERS[retr_name]
    retriever = retr_cls() if retr_cls is ExhaustiveRetriever else retr_cls(_build(RetrieverOptions, retr_cfg))

    detector = build_detector(det_cfg)
    matcher = build_matcher(cfg.get("matcher"))
    global_descriptor = build_global_descriptor(cfg["global_descriptor"]) if cfg.get("global_descriptor") else None
    correspondence = build_correspondence(cfg.get("correspondence"))
    return SceneOptimizer(so_opts, retriever=retriever, detector=detector, matcher=matcher,
                          global_descriptor=global_descriptor, correspondence=correspondence)
