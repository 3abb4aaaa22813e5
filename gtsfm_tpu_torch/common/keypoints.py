"""Keypoints container.

Port of gtsfm_tpu/common/keypoints.py: fixed-size, padded per-image
keypoints with an explicit validity mask, so batches of images keep static
shapes. Here a dataclass of tensors (``TensorStruct``: ``map`` and
``replace``) in place of the reference's flax pytree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from gtsfm_tpu_torch.utils.numerics import TensorStruct


@dataclasses.dataclass
class Keypoints(TensorStruct):
    """2D detections of one image or a padded batch of images.

    coordinates: (..., K, 2) (x = column, y = row, pixels)
    scales:      (..., K) detection scale (0 where unknown)
    responses:   (..., K) detection confidence (0 where unknown)
    mask:        (..., K) True for valid entries (padding is False)
    """

    coordinates: torch.Tensor
    scales: torch.Tensor
    responses: torch.Tensor
    mask: torch.Tensor

    @classmethod
    def create(cls, coordinates, scales=None, responses=None, mask=None) -> "Keypoints":
        coordinates = torch.as_tensor(coordinates, dtype=torch.float32)
        shape, dev = coordinates.shape[:-1], coordinates.device
        if scales is None:
            scales = torch.zeros(shape, device=dev)
        if responses is None:
            responses = torch.zeros(shape, device=dev)
        if mask is None:
            mask = torch.ones(shape, dtype=torch.bool, device=dev)
        return cls(coordinates=coordinates, scales=torch.as_tensor(scales, dtype=torch.float32, device=dev),
                   responses=torch.as_tensor(responses, dtype=torch.float32, device=dev),
                   mask=torch.as_tensor(mask, dtype=torch.bool, device=dev))

    def __len__(self) -> int:
        return int(self.mask.sum())

    @property
    def max_keypoints(self) -> int:
        return self.coordinates.shape[-2]

    def extract(self, indices: torch.Tensor) -> "Keypoints":
        """Gather keypoints at ``indices`` (..., k) along the K axis."""
        take = lambda a: torch.gather(a, -1, indices)  # noqa: E731
        idx2 = indices[..., None].expand(*indices.shape, 2)
        return Keypoints(coordinates=torch.gather(self.coordinates, -2, idx2), scales=take(self.scales),
                         responses=take(self.responses), mask=take(self.mask))

    def get_top_k(self, k: int) -> "Keypoints":
        """The k highest-response valid keypoints (padded to k), equal
        responses in index order (the reference's stable argsort)."""
        score = torch.where(self.mask, self.responses, -torch.inf)
        idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]
        return self.extract(idx)

    def filter_by_mask(self, keep: torch.Tensor) -> "Keypoints":
        """AND an extra validity mask in (no compaction: stays padded)."""
        return self.replace(mask=self.mask & keep)

    def pad_to(self, k: int) -> "Keypoints":
        pad = k - self.max_keypoints
        if pad <= 0:
            return self
        return Keypoints(coordinates=F.pad(self.coordinates, (0, 0, 0, pad)), scales=F.pad(self.scales, (0, pad)),
                         responses=F.pad(self.responses, (0, pad)), mask=F.pad(self.mask, (0, pad), value=False))

    def valid_coordinates_np(self) -> np.ndarray:
        """(n_valid, 2) numpy array of the valid coordinates."""
        return self.coordinates[self.mask].cpu().numpy()
