"""Content-addressed disk caching.

Port of gtsfm_tpu/utils/cache.py: SHA1 content keys over numpy arrays,
bytes, strings and numbers, and a pickle store namespaced per stage.
The stage cachers (frontend/cachers.py, frontend/two_view_cacher.py, the
cluster cache of scene/hierarchical.py, ``DetectorCacher`` here for a
one-image detector) replay each stage from disk on a re-run with the same
inputs; ``enabled=False`` turns a cache off.

The default root is the port's own, ``~/.cache/gtsfm_tpu_torch``: entries
written by the JAX package are never replayed here. Entries hold host
numpy arrays or CPU tensors only: a pickled CUDA tensor loads back onto
the writer's card, and cannot load on a host without one, so ``put``
refuses it.

The reference compresses its entries with bz2; the port writes them
uncompressed. Descriptors are float32 noise to a compressor: bz2 shrinks a
32-view detection entry (2,048 keypoints of 128 floats) by a few percent
and takes seconds to write and to read it, longer than the detector takes
on the card (PERF.md, "Findings").
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Callable, Optional

import numpy as np
import torch

from gtsfm_tpu_torch.common.keypoints import Keypoints
from gtsfm_tpu_torch.utils.convert import to_numpy
from gtsfm_tpu_torch.utils.numerics import resolve_device

DEFAULT_CACHE_ROOT = os.path.join(os.path.expanduser("~"), ".cache", "gtsfm_tpu_torch")


def content_key(*parts) -> str:
    """SHA1 over numpy arrays, bytes, strings and numbers (the reference's
    key for the same parts)."""
    h = hashlib.sha1()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(p.tobytes())
            h.update(str(p.shape).encode())
            h.update(str(p.dtype).encode())
        elif isinstance(p, bytes):
            h.update(p)
        else:
            h.update(repr(p).encode())
    return h.hexdigest()


def _check_host(value: Any) -> None:
    """Raise on a CUDA tensor anywhere in a tuple / list / dict tree or a
    dataclass of tensors."""
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            raise ValueError(f"cache entries hold host arrays only, got a tensor on {value.device}")
    elif isinstance(value, (tuple, list)):
        for v in value:
            _check_host(v)
    elif isinstance(value, dict):
        for v in value.values():
            _check_host(v)
    elif hasattr(value, "__dataclass_fields__"):
        for name in value.__dataclass_fields__:
            _check_host(getattr(value, name))


class DiskCache:
    """Pickle store keyed by content hash, namespaced per stage. A missing
    or unreadable entry is a miss. With ``enabled=False`` no directory is
    made, every ``get`` misses and ``put`` does nothing."""

    def __init__(self, namespace: str, root: Optional[str] = None, enabled: bool = True):
        self.dir = os.path.join(root or DEFAULT_CACHE_ROOT, namespace)
        self.enabled = enabled
        if enabled:
            os.makedirs(self.dir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.pkl")

    def get(self, key: str) -> Optional[Any]:
        if not self.enabled:
            return None
        p = self._path(key)
        if not os.path.exists(p):
            return None
        try:
            with open(p, "rb") as f:
                return pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError):
            return None

    def put(self, key: str, value: Any) -> None:
        if not self.enabled:
            return
        _check_host(value)
        tmp = self._path(key) + f".{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self._path(key))

    def get_or_compute(self, key: str, fn: Callable[[], Any]) -> Any:
        hit = self.get(key)
        if hit is not None:
            return hit
        value = fn()
        self.put(key, value)
        return value


class DetectorCacher:
    """Wraps a detector-descriptor ``detector(image, device=) -> (Keypoints,
    descriptors)`` for one image: the cache is keyed on the image's content
    plus the detector's class name and options, and holds host numpy. A
    miss runs the detector on ``device``, a replay rebuilds the port's
    ``Keypoints`` and descriptors there; the card by default, raising
    without one (``numerics.resolve_device``)."""

    def __init__(self, detector, root: Optional[str] = None, enabled: bool = True):
        self.detector = detector
        tag = type(detector).__name__ + repr(getattr(detector, "options", ""))
        self.cache = DiskCache(f"detector/{hashlib.sha1(tag.encode()).hexdigest()[:12]}",
                               root=root, enabled=enabled)

    def __call__(self, image, device="cuda"):
        dev = resolve_device(device)
        key = content_key(np.asarray(to_numpy(image)))
        hit = self.cache.get(key)
        if hit is not None:
            kps_d, desc = hit
            return (Keypoints(**{f: torch.as_tensor(v, device=dev) for f, v in kps_d.items()}),
                    torch.as_tensor(desc, device=dev))
        kps, desc = self.detector(image, device=dev)
        if self.cache.enabled:
            self.cache.put(key, (to_numpy(kps), to_numpy(desc)))
        return kps, desc
