"""Front-end component registry: config dicts -> detector, matcher, global
descriptor and correspondence generator.

Port of gtsfm_tpu/frontend/registry.py for the components the port has:
the ``dog_sift`` detector and the deep front end's ``superpoint``,
``d2net`` and ``disk`` detectors (batched CNNs behind an adapter that pads
the images to the net's stride), the ``mutual_nn`` and ``lightglue``
matchers, the ``tiny``, ``netvlad``, ``hloc_netvlad`` and ``megaloc``
global descriptors and the ``synthetic`` correspondence generator. A
detector or correspondence generator the reference knows but the port has
not ported raises ``NotImplementedError`` naming its ROADMAP item; an
unknown name, and any other matcher, raises ``ValueError``. The results go
into ``SceneOptimizer``. A net built without ``weights_path`` keeps its
random init of seed 0; ``netvlad`` drops ``weights_path``, as the
reference does.

Contracts: a detector has ``max_keypoints`` and ``detect_batch(images
(B, H, W)) -> (kp_xy (B, K, 2), kp_mask (B, K), descs (B, K, D))`` numpy;
the images may be a tensor on the device to run on. A matcher is None (the
fused mutual-NN matcher inside the two-view batch) or has ``match_batch``.
A global descriptor has ``describe_batch(images) -> (N, D)`` numpy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# names of the reference's components that are still to be ported, with the
# ROADMAP item that holds each
_UNPORTED = {
    "detector": dict.fromkeys(("sift", "root_sift", "orb", "brisk", "kaze", "combination"),
                              "ROADMAP queue 1 item 10, the OpenCV-class detectors"),
    "correspondence generator": dict.fromkeys(("loftr", "loftr_compact", "mast3r", "colmap"),
                                              "ROADMAP queue 1 item 10, the correspondence generators"),
}


def _unknown(kind: str, name: str):
    item = _UNPORTED.get(kind, {}).get(name)
    if item is not None:
        return NotImplementedError(f"the {kind} {name!r} is not ported yet ({item})")
    return ValueError(f"Unknown {kind}: {name!r}")


class _BatchedCNNDetectorAdapter:
    """A batched CNN detector ((B, H, W) -> (Keypoints, descriptors)) behind
    the detector contract: the images padded with zeros at the bottom and
    right to a multiple of the net's stride, the outputs as numpy."""

    def __init__(self, detector, max_keypoints: int, stride: int):
        self.detector = detector
        self.max_keypoints = max_keypoints
        self.stride = stride

    def detect_batch(self, images):
        images = torch.as_tensor(images, dtype=torch.float32)
        H, W = images.shape[-2:]
        s = self.stride
        images = F.pad(images, (0, -W % s, 0, -H % s))
        kps, d = self.detector(images)
        return kps.coordinates.cpu().numpy(), kps.mask.cpu().numpy(), d.cpu().numpy()


def build_detector(cfg: Optional[dict]):
    """cfg: {name: dog_sift|superpoint|d2net|disk, weights_path?: str,
    <the detector's option fields>}."""
    cfg = dict(cfg or {})
    name = cfg.pop("name", "dog_sift")
    weights_path = cfg.pop("weights_path", None)
    if name == "dog_sift":
        from gtsfm_tpu_torch.frontend.detectors.dog_sift import DoGSift, DoGSiftOptions

        return DoGSift(DoGSiftOptions(**cfg))
    if name == "superpoint":
        from gtsfm_tpu_torch.frontend.detectors.superpoint import SuperPoint, SuperPointOptions

        opts = SuperPointOptions(**cfg)
        return _BatchedCNNDetectorAdapter(SuperPoint(opts, weights_path=weights_path), opts.max_keypoints, 8)
    if name == "d2net":
        from gtsfm_tpu_torch.frontend.detectors.d2net import D2Net, D2NetOptions

        opts = D2NetOptions(**cfg)
        return _BatchedCNNDetectorAdapter(D2Net(opts, weights_path=weights_path), opts.max_keypoints, 4)
    if name == "disk":
        from gtsfm_tpu_torch.frontend.detectors.disk import DISK, DISKOptions

        opts = DISKOptions(**cfg)
        return _BatchedCNNDetectorAdapter(DISK(opts, weights_path=weights_path), opts.max_keypoints, 16)
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
    """cfg: {name: tiny|netvlad|hloc_netvlad|megaloc, weights_path?: str,
    <options>}."""
    cfg = dict(cfg or {})
    name = cfg.pop("name", "tiny")
    if name == "tiny":
        from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import TinyImageDescriptor

        return TinyImageDescriptor(**cfg)
    if name == "netvlad":
        from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import NetVLADDescriptor, NetVLADOptions

        cfg.pop("weights_path", None)
        return NetVLADDescriptor(NetVLADOptions(**cfg))
    if name == "hloc_netvlad":
        from gtsfm_tpu_torch.frontend.global_descriptors.descriptors import HlocNetVLADDescriptor

        return HlocNetVLADDescriptor(weights_path=cfg.pop("weights_path", None))
    if name == "megaloc":
        from gtsfm_tpu_torch.frontend.global_descriptors.megaloc import MegaLocDescriptor, MegaLocOptions

        weights_path = cfg.pop("weights_path", None)
        return MegaLocDescriptor(MegaLocOptions(**cfg), weights_path=weights_path)
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
