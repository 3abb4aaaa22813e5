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

On a (data, model) mesh with more than one ``model`` rank
(``parallel/sharding.py``, the reference's desc1 keypoint axis over
``model``), each model rank runs the tile kernel alone on its whole
128-row tiles of desc1 (its own C entry, the row offset added to
``colidx``); the ranks' row outputs and (P, n_rt, K2) column buffers are
gathered in rank order, so the buffer's row tiles stand where the unsplit
call puts them and the finish keeps "first tile, lowest row" on ties; the
finish kernel then runs from its own C entry on the gathered buffers. The
matches are those of the unsplit call, bit for bit. On the CPU the same
split runs through the plain twins (mutual_nn.tile_outputs,
finish_tiles).

The library is compiled from the repository's source at first use
(utils/cuda_build.py: nvcc, sm_90a, into build/torch_kernels/) and bound
through ctypes; the launch runs on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gtsfm_tpu_torch.frontend.matchers.mutual_nn import TILE, finish_tiles, match_descriptors, tile_outputs
from gtsfm_tpu_torch.parallel.sharding import gather, model_row_range
from gtsfm_tpu_torch.utils import cuda_build

MAX_D = 576  # shared memory above D = 128: (128 + 2 * 32) * (D + 8) bf16 <= 227 KB

# launches of the CUDA kernels in this process, never incremented by the
# CPU path: launch_count one per C call that launches the tile kernel (the
# unsplit entry, which also launches the finish kernel, or the split's tile
# entry), finish_launch_count one per call of the finish kernel's own entry
launch_count = 0
finish_launch_count = 0


@functools.cache
def _kernel():
    return cuda_build.function("fused_matcher", "gtsfm_fused_matcher",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
                               + [ctypes.c_void_p] * 8)


@functools.cache
def _tile_kernel():
    return cuda_build.function("fused_matcher", "gtsfm_fused_matcher_tiles",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6)


@functools.cache
def _finish_kernel():
    return cuda_build.function("fused_matcher", "gtsfm_fused_matcher_finish",
                               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float]
                               + [ctypes.c_void_p] * 3)


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
    mesh=None,
):
    """Batched mutual-NN + ratio-test matching, bf16 similarity.

    desc1 (P, K1, D), desc2 (P, K2, D) L2-normalized; masks bool (P, K).
    Returns (match_idx int32 (P, K1) or -1, match_mask bool, best f32), the
    contract of mutual_nn.match_descriptors. CPU tensors run that plain
    version; CUDA tensors launch the kernel (or raise). With a
    ``parallel.sharding.Mesh`` whose ``model`` axis is above 1, every rank
    of this rank's model group must make the same call: desc1's rows are
    split over them (the module's docstring)."""
    P, K1, K2, D = _check(desc1, desc2, mask1, mask2)
    split = mesh is not None and mesh.shape["model"] > 1
    if desc1.device.type == "cpu":
        if not split:
            return match_descriptors(desc1, desc2, mask1, mask2, ratio=ratio)
        lo, hi = model_row_range(mesh, K1, TILE)
        part = (tile_outputs(desc1[:, lo:hi], desc2, mask1[:, lo:hi], mask2, row0=lo) if hi > lo
                else _no_rows(P, K2, desc1.device))
        return finish_tiles(*_gather_tiles(mesh, part, lo, K1), mask1, ratio)
    if desc1.device.type != "cuda":
        raise ValueError(f"unsupported device {desc1.device}")
    dev = desc1.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return fused_match_descriptors(desc1, desc2, mask1, mask2, ratio, mesh)
    d1, d2 = (d.to(torch.bfloat16).contiguous() for d in (desc1, desc2))
    # cp.async reads 16-byte chunks: the rows must start 16-byte aligned
    d1, d2 = (d if d.data_ptr() % 16 == 0 else d.clone() for d in (d1, d2))
    m1, m2 = (m.contiguous() for m in (mask1, mask2))  # bool: one byte, 0 or 1
    if not split:
        return match_tiles(d1, d2, m1, m2, ratio)[0]
    lo, hi = model_row_range(mesh, K1, TILE)
    # a row slice of (P, K1, D) is not contiguous: the kernel takes a copy
    part = launch_tiles(d1[:, lo:hi].contiguous(), d2, m1[:, lo:hi].contiguous(), m2, lo) if hi > lo \
        else _no_rows(P, K2, dev)
    return launch_finish(*_gather_tiles(mesh, part, lo, K1), m1, ratio)


def _no_rows(P: int, K2: int, dev) -> tuple:
    """The tile outputs of an empty row range (a model rank past the last
    row tile)."""
    f, i = torch.empty((P, 0), device=dev), torch.empty((P, 0), dtype=torch.int32, device=dev)
    return f, f, i, torch.empty((P, 0, K2), device=dev), torch.empty((P, 0, K2), dtype=torch.int32, device=dev)


def _gather_tiles(mesh, part: tuple, lo: int, K1: int) -> tuple:
    """The model ranks' tile outputs for rows [lo, ...) gathered in rank
    order into those of all K1 rows."""
    best, second, bidx, colbest, colidx = part
    n_rt, t0 = -(-K1 // TILE), lo // TILE
    return (*(gather(mesh, "model", t, lo, K1, dim=1) for t in (best, second, bidx)),
            *(gather(mesh, "model", t, t0, n_rt, dim=1) for t in (colbest, colidx)))


def _check_kernel_inputs(d1, d2, m1, m2) -> None:
    for x in (d1, d2, m1, m2):
        if x.device.type != "cuda" or not x.is_contiguous():
            raise ValueError("the kernel takes contiguous CUDA tensors")
    if d1.dtype != torch.bfloat16 or d2.dtype != torch.bfloat16:
        raise TypeError("the kernel takes bf16 descriptors")
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("the descriptors must start 16-byte aligned")


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
    _check_kernel_inputs(d1, d2, m1, m2)
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


def launch_tiles(d1: torch.Tensor, d2: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor, row0: int = 0) -> tuple:
    """The tile kernel alone (its own C entry), on the current CUDA device:
    d1 (P, K1, D) are desc1's rows row0 .. row0 + K1 (row0 a multiple of
    TILE), d2 (P, K2, D) all of desc2, as ``match_tiles`` takes them.
    Returns (best, second, bidx (P, K1), colbest, colidx (P, ceil(K1 /
    TILE), K2)), ``colidx`` in global rows: mutual_nn.tile_outputs'
    contract."""
    global launch_count
    P, K1, K2, D = _check(d1, d2, m1, m2)
    _check_kernel_inputs(d1, d2, m1, m2)
    if row0 < 0 or row0 % TILE:
        raise ValueError(f"row0={row0} is not a non-negative multiple of {TILE}")
    dev = d1.device
    n_rt = (K1 + TILE - 1) // TILE
    best = torch.empty((P, K1), dtype=torch.float32, device=dev)
    second = torch.empty((P, K1), dtype=torch.float32, device=dev)
    bidx = torch.empty((P, K1), dtype=torch.int32, device=dev)
    colbest = torch.empty((P, n_rt, K2), dtype=torch.float32, device=dev)
    colidx = torch.empty((P, n_rt, K2), dtype=torch.int32, device=dev)
    rc = _tile_kernel()(
        d1.data_ptr(), d2.data_ptr(), m1.data_ptr(), m2.data_ptr(), P, K1, K2, D, row0,
        best.data_ptr(), second.data_ptr(), bidx.data_ptr(), colbest.data_ptr(), colidx.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused matcher tile launch failed: cudaError {rc}")
    launch_count += 1
    return best, second, bidx, colbest, colidx


def launch_finish(best, second, bidx, colbest, colidx, m1, ratio: float = 0.8) -> tuple:
    """The finish kernel alone (its own C entry), on the current CUDA device,
    on the tile outputs of all K1 rows: best, second float32 and bidx int32
    (P, K1), colbest float32 and colidx int32 (P, ceil(K1 / TILE), K2), m1
    bool (P, K1), all contiguous. Returns (match_idx, match_mask, best), as
    ``finish_tiles``, its plain version."""
    global finish_launch_count
    P, K1 = best.shape
    n_rt, K2 = colbest.shape[1:]
    want = ((best, torch.float32, (P, K1)), (second, torch.float32, (P, K1)), (bidx, torch.int32, (P, K1)),
            (colbest, torch.float32, (P, -(-K1 // TILE), K2)), (colidx, torch.int32, (P, n_rt, K2)),
            (m1, torch.bool, (P, K1)))
    for x, dtype, shape in want:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"finish input {x.dtype} {tuple(x.shape)}, expected {dtype} {shape}")
        if x.device != best.device or x.device.type != "cuda" or not x.is_contiguous():
            raise ValueError("the finish kernel takes contiguous CUDA tensors on one device")
    if P == 0 or P > 65535 or K1 == 0 or K2 == 0:
        raise ValueError(f"unsupported sizes P={P} K1={K1} K2={K2}")
    match_idx = torch.empty((P, K1), dtype=torch.int32, device=best.device)
    ok = torch.empty((P, K1), dtype=torch.bool, device=best.device)
    rc = _finish_kernel()(
        best.data_ptr(), second.data_ptr(), bidx.data_ptr(), colbest.data_ptr(), colidx.data_ptr(),
        m1.data_ptr(), P, K1, K2, ratio**2, match_idx.data_ptr(), ok.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused matcher finish launch failed: cudaError {rc}")
    finish_launch_count += 1
    return match_idx, ok, best


# the finish kernel's plain version (mutual_nn.finish_tiles)
_finish = finish_tiles
