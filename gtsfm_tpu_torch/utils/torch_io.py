"""Safe torch checkpoint loading shared by the weight loaders.

Port of gtsfm_tpu/utils/torch_io.py. ``torch.load`` on an untrusted file
runs arbitrary pickled code; ``weights_only=True`` restricts unpickling to
tensor and container types. The public checkpoints the nets take
(SuperPoint, LightGlue, NetVLAD, MegaLoc, D2-Net, DISK) are plain tensor
state_dicts, so the restricted loader is tried first and the permissive one
only as an explicit, warned fallback for legacy formats.
"""

from __future__ import annotations

import warnings

import torch


def load_torch_checkpoint(path: str):
    """``torch.load`` onto the CPU with ``weights_only=True``, falling back
    (with a warning) for checkpoints whose container types the restricted
    unpickler rejects."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # pickle.UnpicklingError or a rejected container type
        warnings.warn(
            f"weights_only torch.load failed for {path} ({e}); falling back "
            "to the permissive loader: only do this for trusted files",
            stacklevel=2,
        )
        return torch.load(path, map_location="cpu", weights_only=False)
