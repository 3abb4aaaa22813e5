"""Front-end component registry: config dicts -> detector, matcher, global
descriptor and correspondence generator.

Port of gtsfm_tpu/frontend/registry.py for the components the port has:
the ``dog_sift`` detector, the ``mutual_nn`` and ``lightglue`` matchers,
the ``tiny`` global descriptor and the ``synthetic`` correspondence
generator. A detector, global descriptor or correspondence generator the
reference knows but the port has not ported raises ``NotImplementedError``
naming its ROADMAP item; an unknown name, and any other matcher, raises
``ValueError``. The results go into ``SceneOptimizer``.

Contracts: a detector has ``max_keypoints`` and ``detect_batch(images
(B, H, W)) -> (kp_xy (B, K, 2), kp_mask (B, K), descs (B, K, D))`` numpy;
the images may be a tensor on the device to run on. A matcher is None (the
fused mutual-NN matcher inside the two-view batch) or has ``match_batch``.
A global descriptor has ``describe_batch(images) -> (N, D)`` numpy.
"""

from __future__ import annotations

from typing import Optional

# names of the reference's components that are still to be ported, with the
# ROADMAP item that holds each
_UNPORTED = {
    "detector": {
        **dict.fromkeys(("superpoint", "d2net", "disk"), "ROADMAP queue 1 item 8, the deep front end"),
        **dict.fromkeys(("sift", "root_sift", "orb", "brisk", "kaze", "combination"),
                        "ROADMAP queue 1 item 10, the OpenCV-class detectors"),
    },
    "global descriptor": dict.fromkeys(("netvlad", "hloc_netvlad", "megaloc"),
                                       "ROADMAP queue 1 item 8, the deep front end"),
    "correspondence generator": dict.fromkeys(("loftr", "loftr_compact", "mast3r", "colmap"),
                                              "ROADMAP queue 1 item 10, the correspondence generators"),
}


def _unknown(kind: str, name: str):
    item = _UNPORTED[kind].get(name)
    if item is not None:
        return NotImplementedError(f"the {kind} {name!r} is not ported yet ({item})")
    return ValueError(f"Unknown {kind}: {name!r}")


def build_detector(cfg: Optional[dict]):
    """cfg: {name: dog_sift, <DoGSiftOptions fields>}."""
    cfg = dict(cfg or {})
    name = cfg.pop("name", "dog_sift")
    if name == "dog_sift":
        from gtsfm_tpu_torch.frontend.detectors.dog_sift import DoGSift, DoGSiftOptions

        return DoGSift(DoGSiftOptions(**cfg))
    raise _unknown("detector", name)


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


def build_global_descriptor(cfg: Optional[dict]):
    """cfg: {name: tiny, res?: int}."""
    cfg = dict(cfg or {})
    name = cfg.pop("name", "tiny")
    if name == "tiny":
        from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import TinyImageDescriptor

        return TinyImageDescriptor(**cfg)
    raise _unknown("global descriptor", name)


def build_correspondence(cfg: Optional[dict]):
    """cfg: {name: detdesc|synthetic, <SyntheticOptions fields>}. Returns
    None for detdesc (the detector and matcher path) or the synthetic
    generator, which the scene optimizer runs in its direct branch."""
    cfg = dict(cfg or {})
    name = cfg.pop("name", "detdesc")
    if name == "detdesc":
        return None
    if name == "synthetic":
        from gtsfm_tpu_torch.frontend.synthetic import SyntheticCorrespondenceGenerator, SyntheticOptions

        return SyntheticCorrespondenceGenerator(SyntheticOptions(**cfg))
    raise _unknown("correspondence generator", name)
