"""Fused mutual-NN matcher: the hand-written CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``_matcher_kernel`` in
gtsfm_tpu/frontend/matchers/pallas_matcher.py (entry
``pallas_match_descriptors``, vmapped over pairs in two_view.py). The
reference keeps that kernel opt-in (``TwoViewOptions.use_pallas_matcher``);
the port has no such option: on a CUDA tensor the two-view path always
launches this kernel, and on a CPU tensor it runs the plain version
(mutual_nn.match_descriptors). It never falls back from one to the other.

What bounds it on an H100: at the two-view shape (P=96 pairs, K=1024, D=128)
the similarity is 2*P*K*K*D = 25.8 GFLOP of bf16 against 101 MB of float32
descriptors, and each of its 100.7 M values feeds a row top-2 and a column
argmax, so the op is bound by the tensor cores and the instructions that
reduce their output; the plain version instead writes the (P, K, K) float32
similarity (400 MB) to device memory and reads it back three times (row
max, masked second best, column max). The kernel (csrc/fused_matcher.cu)
multiplies on the tensor cores (``mma.sync`` bf16, float32 sums), with
desc1's fragments held in registers and desc2 tiles double-buffered by
``cp.async``, and reduces the row top-2 and the column argmax on the
accumulator fragments; device-memory traffic is the descriptors plus a
(P, ceil(K1/128), K2) column buffer, which a second small kernel, launched
by the same C call, reduces into the matches (``_finish`` is its plain
version). One call of the wrapper is two casts and one C call, so its host
time stays small beside the kernels' device time.

The library is compiled from the repository's source at first use
(utils/cuda_build.py: nvcc, sm_90a, into build/torch_kernels/) and bound
through ctypes; the launch runs on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gtsfm_tpu_torch.frontend.matchers.mutual_nn import match_descriptors
from gtsfm_tpu_torch.utils import cuda_build

TILE = 128  # desc1 rows per block: the column buffer's row-tile height
MAX_D = 576  # shared memory above D = 128: (128 + 2 * 32) * (D + 8) bf16 <= 227 KB

# launches of the CUDA kernels in this process, one per call of the C entry
# (the tile kernel and the finish kernel); never incremented by the CPU path
launch_count = 0


@functools.cache
def _kernel():
    return cuda_build.function("fused_matcher", "gtsfm_fused_matcher",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
                               + [ctypes.c_void_p] * 8)


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
    dev = desc1.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return fused_match_descriptors(desc1, desc2, mask1, mask2, ratio)
    d1, d2 = (d.to(torch.bfloat16).contiguous() for d in (desc1, desc2))
    # cp.async reads 16-byte chunks: the rows must start 16-byte aligned
    d1, d2 = (d if d.data_ptr() % 16 == 0 else d.clone() for d in (d1, d2))
    m1, m2 = (m.contiguous() for m in (mask1, mask2))  # bool: one byte, 0 or 1
    return match_tiles(d1, d2, m1, m2, ratio)[0]


def match_tiles(d1: torch.Tensor, d2: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor, ratio: float = 0.8):
    """The kernels alone, on the current CUDA device: bf16 descriptors d1
    (P, K1, D) and d2 (P, K2, D), contiguous and 16-byte aligned, bool
    masks. One call launches the tile kernel and the finish kernel.
    Returns ((match_idx, match_mask, best), (second, bidx, colbest,
    colidx)): the matches, and the tile kernel's other outputs, from which
    ``_finish`` (the finish kernel's plain version) computes the same
    matches."""
    global launch_count
    P, K1, K2, D = _check(d1, d2, m1, m2)
    for x in (d1, d2, m1, m2):
        if x.device.type != "cuda" or not x.is_contiguous():
            raise ValueError("the kernel takes contiguous CUDA tensors")
    if d1.dtype != torch.bfloat16 or d2.dtype != torch.bfloat16:
        raise TypeError("the kernel takes bf16 descriptors")
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("the descriptors must start 16-byte aligned")
    dev = d1.device
    n_rt = (K1 + TILE - 1) // TILE
    best = torch.empty((P, K1), dtype=torch.float32, device=dev)
    second = torch.empty((P, K1), dtype=torch.float32, device=dev)
    bidx = torch.empty((P, K1), dtype=torch.int32, device=dev)
    colbest = torch.empty((P, n_rt, K2), dtype=torch.float32, device=dev)
    colidx = torch.empty((P, n_rt, K2), dtype=torch.int32, device=dev)
    match_idx = torch.empty((P, K1), dtype=torch.int32, device=dev)
    ok = torch.empty((P, K1), dtype=torch.bool, device=dev)
    rc = _kernel()(
        d1.data_ptr(), d2.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        P, K1, K2, D, ratio**2,
        best.data_ptr(), second.data_ptr(), bidx.data_ptr(), colbest.data_ptr(), colidx.data_ptr(),
        match_idx.data_ptr(), ok.data_ptr(), torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused matcher launch failed: cudaError {rc}")
    launch_count += 1
    return (match_idx, ok, best), (second, bidx, colbest, colidx)


def _finish(best, second, bidx, colbest, colidx, mask1, ratio):
    """Cross-tile column argmax (first tile on ties, i.e. the lowest row),
    mutual check and ratio test — the part the reference leaves to XLA
    after its kernel. The plain version of the finish kernel in
    csrc/fused_matcher.cu, which must agree with it exactly."""
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
