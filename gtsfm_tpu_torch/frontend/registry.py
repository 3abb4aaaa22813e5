"""Front-end component registry: config dicts -> detector, matcher, global
descriptor and correspondence generator.

Port of gtsfm_tpu/frontend/registry.py, every component the reference
has: the ``dog_sift`` detector, the deep front end's ``superpoint``,
``d2net`` and ``disk`` detectors (batched CNNs behind an adapter that pads
the images to the net's stride) and OpenCV's ``sift``, ``root_sift``,
``orb``, ``brisk``, ``kaze`` and ``combination`` (host code, one image at a
time); the ``mutual_nn``, ``lightglue`` and ``superglue`` matchers; the
``tiny``, ``netvlad``, ``hloc_netvlad`` and ``megaloc`` global
descriptors; and the ``synthetic``, ``colmap``, ``loftr``,
``loftr_compact`` and ``mast3r`` correspondence generators (the nets on
``device``). An unknown name raises ``ValueError``. The results go into
``SceneOptimizer``. A net built without ``weights_path`` keeps its random
init of seed 0; ``netvlad`` and ``loftr_compact`` drop ``weights_path``,
as the reference does.

Contracts: a detector has ``max_keypoints`` and ``detect_batch(images
(B, H, W)) -> (kp_xy (B, K, 2), kp_mask (B, K), descs (B, K, D))`` numpy;
the images may be a tensor on the device to run on. A matcher is None (the
fused mutual-NN matcher inside the two-view batch) or has ``match_batch``.
A global descriptor has ``describe_batch(images) -> (N, D)`` numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


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


class _HostDetectorAdapter:
    """A per-image host detector (image (H, W) numpy -> (Keypoints,
    descriptors)) behind the detector contract, one image at a time."""

    def __init__(self, detector, max_keypoints: int):
        self.detector = detector
        self.max_keypoints = max_keypoints

    def detect_batch(self, images):
        out = [self.detector(im) for im in torch.as_tensor(images).cpu().numpy()]
        return (np.stack([k.coordinates.numpy() for k, _ in out]), np.stack([k.mask.numpy() for k, _ in out]),
                np.stack([d.numpy() for _, d in out]))


def build_detector(cfg: Optional[dict]):
    """cfg: {name: dog_sift|superpoint|d2net|disk|sift|root_sift|orb|brisk|
    kaze|combination, weights_path?: str, <the detector's option fields>}."""
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
    if name in ("sift", "root_sift", "orb", "brisk", "kaze"):
        from gtsfm_tpu_torch.frontend.detectors.opencv_classical import (
            OpenCVDetectorDescriptor,
            OpenCVDetectorOptions,
        )

        opts = OpenCVDetectorOptions(kind=name, **cfg)
        return _HostDetectorAdapter(OpenCVDetectorDescriptor(opts), opts.max_keypoints)
    if name == "combination":
        from gtsfm_tpu_torch.frontend.detectors.opencv_classical import (
            CombinationDetectorDescriptor,
            CombinationOptions,
        )

        opts = CombinationOptions(**cfg)
        return _HostDetectorAdapter(CombinationDetectorDescriptor(opts), opts.max_keypoints)
    raise ValueError(f"Unknown detector: {name!r}")


def build_matcher(cfg: Optional[dict]):
    """cfg: {name: mutual_nn|lightglue|superglue, weights_path?: str,
    descriptor_dim?: int (LightGlue), <the matcher's option fields>}.
    Returns None for
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
    if name == "superglue":
        from gtsfm_tpu_torch.frontend.matchers.superglue import SuperGlueMatcher, SuperGlueOptions, load_torch_weights

        weights_path = cfg.pop("weights_path", None)
        opts = SuperGlueOptions(**cfg)
        return SuperGlueMatcher(opts, state_dict=load_torch_weights(weights_path) if weights_path else None)
    raise ValueError(f"Unknown matcher: {name!r}")


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
    raise ValueError(f"Unknown global descriptor: {name!r}")


def build_correspondence(cfg: Optional[dict], device="cuda"):
    """cfg: {name: detdesc|synthetic|colmap|loftr|loftr_compact|mast3r,
    weights_path?: str, colmap_dir and binary (colmap), <the generator's
    option fields>}. Returns None for detdesc (the detector and matcher
    path), else a generator the scene optimizer runs in its direct branch:
    the synthetic one (``requires_gt``), or one with ``generate(images,
    pairs) -> {(i1, i2): (uv1, uv2)}`` whose net runs on ``device``."""
    cfg = dict(cfg or {})
    name = cfg.pop("name", "detdesc")
    if name == "detdesc":
        return None
    if name == "synthetic":
        from gtsfm_tpu_torch.frontend.synthetic import SyntheticCorrespondenceGenerator, SyntheticOptions

        return SyntheticCorrespondenceGenerator(SyntheticOptions(**cfg))
    if name == "loftr":
        from gtsfm_tpu_torch.frontend.correspondence import DenseCorrespondenceGenerator
        from gtsfm_tpu_torch.frontend.matchers.loftr import LoFTRMatcher, LoFTROptions, load_torch_weights

        weights_path = cfg.pop("weights_path", None)
        matcher = LoFTRMatcher(LoFTROptions(**cfg), state_dict=load_torch_weights(weights_path) if weights_path
                               else None)
        return DenseCorrespondenceGenerator(matcher, device=device)
    if name == "loftr_compact":
        from gtsfm_tpu_torch.frontend.correspondence import DenseCorrespondenceGenerator
        from gtsfm_tpu_torch.frontend.matchers.dense_matcher import DenseImageMatcher, DenseMatcherOptions

        cfg.pop("weights_path", None)
        return DenseCorrespondenceGenerator(DenseImageMatcher(DenseMatcherOptions(**cfg)), device=device)
    if name == "mast3r":
        from gtsfm_tpu_torch.frontend.mast3r import Mast3rCorrespondenceGenerator, MASt3ROptions

        weights_path = cfg.pop("weights_path", None)
        return Mast3rCorrespondenceGenerator(MASt3ROptions(**cfg), weights_path=weights_path, device=device)
    if name == "colmap":
        from gtsfm_tpu_torch.frontend.correspondence import ColmapCorrespondenceGenerator

        return ColmapCorrespondenceGenerator(cfg.pop("colmap_dir"), binary=cfg.pop("binary", False))
    raise ValueError(f"Unknown correspondence generator: {name!r}")
