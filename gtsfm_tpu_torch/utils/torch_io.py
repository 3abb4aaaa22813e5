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


def load_public_state_dict(net, sd: dict) -> None:
    """Load a public checkpoint's state_dict into ``net``: keys the net
    lacks (heads it does not build) are dropped, values take the net's
    shapes (a 0-d parameter saved as (1,)), and BatchNorm's
    ``num_batches_tracked`` (unused in eval) may be missing; any other
    missing key raises."""
    own = net.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"the state_dict lacks {missing[:5]} ({len(missing)} keys)")
    net.load_state_dict({k: torch.as_tensor(v).reshape(own[k].shape) for k, v in sd.items() if k in own},
                        strict=False)
