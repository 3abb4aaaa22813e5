"""Global image descriptors for retrieval.

Port of the weight-free half of gtsfm_tpu/frontend/global_descriptors/
descriptors.py: ``TinyImageDescriptor`` (the NetVLAD descriptors wait in
ROADMAP queue 1 item 8). It feeds the similarity and joint retrievers.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch.frontend.detectors.dog_sift import resize_linear


class TinyImageDescriptor:
    """Weight-free global descriptor: the image resized to res x res (the
    reference's antialiased linear resize), its mean subtracted, L2
    normalized."""

    def __init__(self, res: int = 32):
        self.res = res

    def describe_batch(self, images) -> np.ndarray:
        """(B, H, W) numpy, or a tensor on the device to run on -> (B,
        res * res) numpy."""
        images = torch.as_tensor(images, dtype=torch.float32)
        v = resize_linear(images, (self.res, self.res)).reshape(images.shape[0], -1)
        v = v - torch.mean(v, dim=-1, keepdim=True)
        return (v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)).cpu().numpy()
