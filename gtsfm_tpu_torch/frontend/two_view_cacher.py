"""Disk cacher for the batched two-view stage.

Port of gtsfm_tpu/frontend/two_view_cacher.py: the key covers the pair
list, samples of each image's keypoints and descriptors, the keypoint
counts and the options' repr, so a re-run with the same front-end output
replays the stage. The port's result is a ``TwoViewResult`` of tensors on
the run's device: the entry holds its fields as host numpy arrays (the
same float32 values), and a hit rebuilds it on the device of the
calibrations. The keypoints and descriptors are host arrays already, so
the key costs no device sync.
"""

from __future__ import annotations

import torch

from gtsfm_tpu_torch.frontend.two_view import TwoViewResult
from gtsfm_tpu_torch.utils.cache import DiskCache, content_key
from gtsfm_tpu_torch.utils.convert import to_numpy


class TwoViewEstimatorCacher:
    def __init__(self, run_fn, options_repr: str = "", root=None, enabled: bool = True):
        """run_fn: ``(pairs, kp_xy, kp_mask, descs, cal, *args) ->
        TwoViewResult``."""
        self.run_fn = run_fn
        self.options_repr = options_repr
        self.cache = DiskCache("two_view", root=root, enabled=enabled)

    def _key(self, pairs, kp_xy, kp_mask, descs) -> str:
        # samples of the content, as the reference samples keypoints
        stride = max(1, kp_xy.shape[1] // 32)
        return content_key(
            to_numpy(pairs),
            to_numpy(kp_xy[:, ::stride]),
            to_numpy(kp_mask).sum(axis=1),
            to_numpy(descs[:, ::stride, :8]),
            self.options_repr,
        )

    def run(self, pairs, kp_xy, kp_mask, descs, cal, *args) -> TwoViewResult:
        key = self._key(pairs, kp_xy, kp_mask, descs)
        hit = self.cache.get(key)
        dev = cal.u0.device  # a field of every calibration model
        if hit is not None:
            return TwoViewResult(**{k: torch.as_tensor(v, device=dev) for k, v in hit.items()})
        tvr = self.run_fn(pairs, kp_xy, kp_mask, descs, cal, *args)
        self.cache.put(key, to_numpy(tvr))
        return tvr
