"""Fused mutual-NN matcher: the hand-written CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``_matcher_kernel`` in
gtsfm_tpu/frontend/matchers/pallas_matcher.py (entry
``pallas_match_descriptors``, vmapped over pairs in two_view.py). The
reference keeps that kernel opt-in (``TwoViewOptions.use_pallas_matcher``);
the port has no such option: on a CUDA tensor the two-view path always
launches this kernel, and on a CPU tensor it runs the plain version
(mutual_nn.match_descriptors). It never falls back from one to the other.

What bounds it on an H100: at the two-view shape (P=96 pairs, K=1024, D=128)
the similarity is 2*P*K*K*D = 26 GFLOP against 50 MB of descriptors read, so
the op is compute-bound; the plain version instead writes the (P, K, K)
float32 similarity (400 MB) to device memory and reads it back three times
(row max, masked second best, column max). The kernel (csrc/fused_matcher.cu)
keeps each 64x64 similarity tile in shared memory and folds the row top-2,
row argmax and per-tile column argmax into the pass, so device-memory
traffic drops to the descriptors plus a (P, K1/64, K2) column buffer. This
first design multiplies bf16 values with float32 FMAs on the CUDA cores,
not the tensor cores (wgmma/TMA come later), so its floor is the float32
FMA rate, not the bf16 tensor-core rate.

The library is compiled from the repository's source at first use
(utils/cuda_build.py: nvcc, sm_90a, into build/torch_kernels/) and bound
through ctypes; the launch runs on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes

import torch

from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
from gtsfm_tpu_torch.utils import cuda_build

TILE = 64
MAX_D = 832  # shared memory: 2 * 64 * (D + 2) bf16 + the 64x65 float tile <= 227 KB

# launches of the CUDA kernel in this process (never incremented by the
# CPU path)
launch_count = 0


def _kernel():
    return cuda_build.function("fused_matcher", "gtsfm_fused_matcher",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6)


def _check(desc1, desc2, mask1, mask2):
    if desc1.dim() != 3 or desc2.dim() != 3:
        raise ValueError(f"descriptors must be (P, K, D): {tuple(desc1.shape)}, {tuple(desc2.shape)}")
    P, K1, D = desc1.shape
    if desc2.shape[0] != P or desc2.shape[2] != D:
        raise ValueError(f"desc2 {tuple(desc2.shape)} does not match desc1 {tuple(desc1.shape)}")
    K2 = desc2.shape[1]
    if tuple(mask1.shape) != (P, K1) or tuple(mask2.shape) != (P, K2):
        raise ValueError("masks must be (P, K1) and (P, K2)")
    if mask1.dtype != torch.bool or mask2.dtype != torch.bool:
        raise TypeError("masks must be bool")
    if not desc1.dtype.is_floating_point or not desc2.dtype.is_floating_point:
        raise TypeError("descriptors must be floating point")
    for t in (desc2, mask1, mask2):
        if t.device != desc1.device:
            raise ValueError("all inputs must be on one device")
    if D % 8 != 0 or D > MAX_D:
        raise ValueError(f"descriptor width D={D} must be a multiple of 8 and <= {MAX_D}")
    if K1 == 0 or K2 == 0 or P == 0 or P > 65535:
        raise ValueError(f"unsupported sizes P={P} K1={K1} K2={K2}")
    return P, K1, K2, D


def fused_match_descriptors(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    mask1: torch.Tensor,
    mask2: torch.Tensor,
    ratio: float = 0.8,
):
    """Batched mutual-NN + ratio-test matching, bf16 similarity.

    desc1 (P, K1, D), desc2 (P, K2, D) L2-normalized; masks bool (P, K).
    Returns (match_idx int32 (P, K1) or -1, match_mask bool, best f32), the
    contract of mutual_nn.match_descriptors. CPU tensors run that plain
    version; CUDA tensors launch the kernel (or raise)."""
    P, K1, K2, D = _check(desc1, desc2, mask1, mask2)
    if desc1.device.type == "cpu":
        return match_descriptors(desc1, desc2, mask1, mask2, ratio=ratio)
    if desc1.device.type != "cuda":
        raise ValueError(f"unsupported device {desc1.device}")
    global launch_count
    dev = desc1.device
    d1 = desc1.to(torch.bfloat16).contiguous()
    d2 = desc2.to(torch.bfloat16).contiguous()
    m1 = mask1.to(torch.uint8).contiguous()
    m2 = mask2.to(torch.uint8).contiguous()
    n_rt = (K1 + TILE - 1) // TILE
    best = torch.empty((P, K1), dtype=torch.float32, device=dev)
    second = torch.empty((P, K1), dtype=torch.float32, device=dev)
    bidx = torch.empty((P, K1), dtype=torch.int32, device=dev)
    colbest = torch.empty((P, n_rt, K2), dtype=torch.float32, device=dev)
    colidx = torch.empty((P, n_rt, K2), dtype=torch.int32, device=dev)
    kernel = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(
            d1.data_ptr(), d2.data_ptr(), m1.data_ptr(), m2.data_ptr(),
            P, K1, K2, D,
            best.data_ptr(), second.data_ptr(), bidx.data_ptr(),
            colbest.data_ptr(), colidx.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused matcher launch failed: cudaError {rc}")
    launch_count += 1
    return _finish(best, second, bidx, colbest, colidx, mask1, ratio)


def _finish(best, second, bidx, colbest, colidx, mask1, ratio):
    """Cross-tile column argmax (first tile on ties, i.e. the lowest row),
    mutual check and ratio test — the part the reference leaves to XLA
    after its kernel."""
    K1 = best.shape[1]
    blk = torch.argmax(colbest, dim=1, keepdim=True)  # (P, 1, K2)
    nn21 = torch.gather(colidx, 1, blk)[:, 0, :].to(torch.int64)  # (P, K2)
    nn12 = bidx.to(torch.int64)
    mutual = torch.gather(nn21, 1, nn12) == torch.arange(K1, device=best.device)
    ok = mask1 & mutual & (best > -1e8)
    d2_best = torch.clamp(2.0 - 2.0 * best, min=0.0)
    d2_second = torch.clamp(2.0 - 2.0 * second, min=1e-12)
    ok = ok & (d2_best < (ratio**2) * d2_second)
    return torch.where(ok, nn12, -1).to(torch.int32), ok, best
