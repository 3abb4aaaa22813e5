"""Front-end component registry: config dicts -> matcher objects.

Port of the matcher part of gtsfm_tpu/frontend/registry.py
(``build_matcher``) for the two matchers the port has: ``mutual_nn`` and
``lightglue``. The result goes into ``SceneOptimizer(matcher=...)``.
"""

from __future__ import annotations

from typing import Optional


def build_matcher(cfg: Optional[dict]):
    """cfg: {name: mutual_nn|lightglue, weights_path?: str,
    descriptor_dim?: int, <LightGlueOptions fields>}. Returns None for
    mutual_nn: the fused matcher inside run_two_view_batch, no separate
    matcher stage."""
    cfg = dict(cfg or {})
    name = cfg.pop("name", "mutual_nn")
    if name == "mutual_nn":
        return None
    if name == "lightglue":
        from gtsfm_tpu_torch.frontend.matchers.lightglue import (
            LightGlueMatcher,
            LightGlueOptions,
            load_torch_weights,
        )

        weights_path = cfg.pop("weights_path", None)
        example_dim = cfg.pop("descriptor_dim", 256)
        opts = LightGlueOptions(**cfg)
        state_dict = None
        if weights_path is not None:
            state_dict, opts = load_torch_weights(weights_path, opts)
        return LightGlueMatcher(opts, state_dict=state_dict, example_dim=example_dim)
    raise ValueError(f"Unknown matcher: {name!r} (the port has mutual_nn and lightglue)")
