"""Stage cachers for the learned matcher and the global descriptor.

Port of gtsfm_tpu/frontend/cachers.py: disk caches (utils/cache.py) keyed
on a SHA1 of the stage's input content and the component's class name.
Together with the detector cache and the two-view cacher
(frontend/two_view_cacher.py) of scene/scene_optimizer.py and the cluster
cache of scene/hierarchical.py, every costly stage replays from disk on a
re-run.

The port's stages take and give tensors on the run's device: the keys hash
host copies of small samples of the inputs (one device sync a call), the
entries hold host numpy arrays, and a hit comes back on the input's
device.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch.utils.cache import DiskCache, content_key
from gtsfm_tpu_torch.utils.convert import to_numpy


class MatcherCacher:
    """Wraps a learned matcher's ``match_batch``. The key covers samples of
    the descriptors and coordinates, the keypoint counts and the matcher's
    class name, so a change downstream never re-runs matching."""

    def __init__(self, matcher, root=None, enabled: bool = True):
        self.matcher = matcher
        self.cache = DiskCache("matcher", root=root, enabled=enabled)

    def _key(self, desc0, desc1, coords0, coords1, mask0, mask1) -> str:
        stride = max(1, desc0.shape[1] // 32)
        return content_key(
            to_numpy(desc0[:, ::stride, :8]), to_numpy(desc1[:, ::stride, :8]),
            to_numpy(coords0[:, ::stride]), to_numpy(coords1[:, ::stride]),
            to_numpy(mask0).sum(axis=-1), to_numpy(mask1).sum(axis=-1),
            type(self.matcher).__name__,
        )

    def match_batch(self, desc0, desc1, coords0, coords1, mask0, mask1, **kw):
        """-> (match_idx, match_mask, match_score) on the device of desc0."""
        key = self._key(desc0, desc1, coords0, coords1, mask0, mask1)
        hit = self.cache.get(key)
        if hit is not None:
            return tuple(torch.as_tensor(a, device=desc0.device) for a in hit)
        out = self.matcher.match_batch(desc0, desc1, coords0, coords1, mask0, mask1, **kw)
        self.cache.put(key, tuple(to_numpy(a) for a in out))
        return out


class GlobalDescriptorCacher:
    """Wraps a global descriptor's ``describe_batch``. The key covers the
    images subsampled by 8, their shape and the descriptor's class name."""

    def __init__(self, descriptor, root=None, enabled: bool = True):
        self.descriptor = descriptor
        self.cache = DiskCache("global_descriptor", root=root, enabled=enabled)

    def describe_batch(self, images) -> np.ndarray:
        key = content_key(to_numpy(images[:, ::8, ::8]), tuple(images.shape), type(self.descriptor).__name__)
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        out = to_numpy(self.descriptor.describe_batch(images))
        self.cache.put(key, out)
        return out
