"""Classical OpenCV detectors and descriptors (host components).

Port of gtsfm_tpu/frontend/detectors/opencv_classical.py: OpenCV's SIFT,
RootSIFT, ORB, BRISK and KAZE, and the combination of one detector (FAST,
GFTT or SIFT's DoG) with one descriptor (SIFT, RootSIFT or ORB), each on
one image on the host as in the reference. The keypoints, by response, fill
the padded ``Keypoints`` of ``max_keypoints``; descriptors are float32 with
unit norm (RootSIFT: the square root of the L1-normalized SIFT vector
first). The scene optimizer moves the outputs to its device, where the
mutual-NN matcher kernel matches them. ``cv2`` is imported when a detector
is built, so the package imports without OpenCV.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gtsfm_tpu_torch.common.keypoints import Keypoints


def _cv2():
    import cv2

    return cv2


class OpenCVDetectorOptions(NamedTuple):
    max_keypoints: int = 2048
    kind: str = "sift"  # sift | root_sift | orb | brisk | kaze


def _make(kind: str, max_kp: int):
    cv2 = _cv2()
    if kind in ("sift", "root_sift"):
        return cv2.SIFT_create(nfeatures=max_kp)
    if kind == "orb":
        return cv2.ORB_create(nfeatures=max_kp)
    if kind == "brisk":
        return cv2.BRISK_create()
    if kind == "kaze":
        return cv2.KAZE_create()
    raise ValueError(kind)


def _pack(kps, desc, K: int, root_sift: bool):
    """OpenCV keypoints and descriptors -> the padded (Keypoints,
    descriptors (K, D)): the K strongest by response, each descriptor
    float32 with unit norm (RootSIFT first: the square root of the
    L1-normalized vector)."""
    coords = np.zeros((K, 2), np.float32)
    scales = np.zeros(K, np.float32)
    resp = np.zeros(K, np.float32)
    mask = np.zeros(K, bool)
    if desc is None or len(kps) == 0:
        desc = np.zeros((0, 128), np.float32)
        kps = []
    order = np.argsort([-k.response for k in kps])[:K]
    out_desc = np.zeros((K, desc.shape[1] if len(desc) else 128), np.float32)
    for i, j in enumerate(order):
        k = kps[j]
        coords[i] = k.pt
        scales[i] = k.size
        resp[i] = k.response
        mask[i] = True
        d = desc[j].astype(np.float32)
        if root_sift:
            d = np.sqrt(d / max(d.sum(), 1e-9))
        out_desc[i] = d / max(np.linalg.norm(d), 1e-9)
    return (Keypoints(coordinates=torch.as_tensor(coords), scales=torch.as_tensor(scales),
                      responses=torch.as_tensor(resp), mask=torch.as_tensor(mask)), torch.as_tensor(out_desc))


class OpenCVDetectorDescriptor:
    """detect_and_describe(image (H, W) float [0,1]) -> (Keypoints, desc)."""

    def __init__(self, options: OpenCVDetectorOptions = OpenCVDetectorOptions()):
        self.options = options
        self._det = _make(options.kind, options.max_keypoints)

    def __call__(self, image):
        img8 = (np.asarray(image) * 255).clip(0, 255).astype(np.uint8)
        kps, desc = self._det.detectAndCompute(img8, None)
        return _pack(kps, desc, self.options.max_keypoints, self.options.kind == "root_sift")


class CombinationOptions(NamedTuple):
    max_keypoints: int = 2048
    detector: str = "fast"  # fast | gftt | dog (SIFT's detector)
    descriptor: str = "sift"  # sift | root_sift | orb


class CombinationDetectorDescriptor:
    """One detector's keypoints described by another's descriptor."""

    def __init__(self, options: CombinationOptions = CombinationOptions()):
        cv2 = _cv2()
        self.options = options
        o = options
        if o.detector == "fast":
            self._det = cv2.FastFeatureDetector_create()
        elif o.detector == "gftt":
            self._det = cv2.GFTTDetector_create(maxCorners=o.max_keypoints)
        elif o.detector == "dog":
            self._det = cv2.SIFT_create(nfeatures=o.max_keypoints)
        else:
            raise ValueError(o.detector)
        if o.descriptor in ("sift", "root_sift"):
            self._desc = cv2.SIFT_create()
        elif o.descriptor == "orb":
            self._desc = cv2.ORB_create()
        else:
            raise ValueError(o.descriptor)

    def __call__(self, image):
        img8 = (np.asarray(image) * 255).clip(0, 255).astype(np.uint8)
        kps = self._det.detect(img8, None)
        # descriptors need scale/orientation fields FAST doesn't set
        for k in kps:
            if k.size <= 0:
                k.size = 7.0
        kps, desc = self._desc.compute(img8, kps)
        return _pack(kps, desc, self.options.max_keypoints, self.options.descriptor == "root_sift")
