"""Numerical helpers shared across the port.

Port of gtsfm_tpu/utils/numerics.py. On the TPU, geometry code had to pin
every matmul to HIGHEST precision; on an NVIDIA card the float32 hazard is
TF32: a float32 matmul may run on the tensor cores with a 10-bit mantissa
when ``torch.backends.cuda.matmul.allow_tf32`` is set, and cuDNN does so by
default. ``precise()`` turns both off for a solver stage (``einsum`` runs
under it; the reference's ``HIGHEST`` constant has no counterpart). Only
the matchers'
descriptor similarity and LightGlue's transformer run in bf16, and they
do so explicitly.

Also here: the unrolled tiny-system solvers of the reference (batched LAPACK
calls on 3x3..9x9 matrices are slow on the card as they were on the TPU), a
small dataclass base for the port's tensor structs, a counter-based
uniform generator that replaces ``jax.random`` streams, and the plain
attention of the feed-forward models, in chunks of query rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import torch


@contextlib.contextmanager
def precise():
    """Run the body with TF32 off for matmuls and convolutions, and with
    bf16 matmuls summing in float32 (no reduced-precision reduction).

    The port's counterpart of the reference's ``precise`` decorator. Usable
    as a context manager or, through ``contextlib``, as a decorator
    (``@precise()``). Restores the previous flags on exit."""
    mat = torch.backends.cuda.matmul
    prev = (mat.allow_tf32, torch.backends.cudnn.allow_tf32, mat.allow_bf16_reduced_precision_reduction)
    mat.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mat.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mat.allow_tf32, torch.backends.cudnn.allow_tf32, mat.allow_bf16_reduced_precision_reduction = prev


# float32 attention scores per chunk of query rows (``attention``)
SCORE_BYTES = 1 << 30
# query-row chunks ``attention`` has computed in this process (a path
# counter the benchmark reads)
ATTENTION_CHUNKS = 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_scale: Optional[float] = None,
              score_div: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T) v with q (..., N, h, d), k and v (..., M, h, d) ->
    (..., N, h, d). ``q_scale`` multiplies q before the product,
    ``score_div`` divides the scores after it (the two references' orders).
    Query rows go in chunks whose (..., h, rows, M) float32 scores hold
    SCORE_BYTES at most; every row's numbers are those of one pass."""
    global ATTENTION_CHUNKS
    qh, kh, vh = (a.movedim(-2, -3) for a in (q, k, v))  # (..., h, N|M, d)
    kt = kh.transpose(-1, -2)
    N, M = qh.shape[-2], kh.shape[-2]
    per_row = 4 * M * math.prod(qh.shape[:-2])
    rows = max(1, SCORE_BYTES // max(per_row, 1))
    ATTENTION_CHUNKS += -(-N // rows)
    outs = []
    for s in range(0, N, rows):
        qs = qh[..., s : s + rows, :]
        if q_scale is not None:
            qs = qs * q_scale
        att = qs @ kt
        if score_div is not None:
            att = att / score_div
        outs.append(torch.softmax(att, dim=-1) @ vh)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)
    return out.movedim(-3, -2)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"``, the entry points'
    default, raises when there is no CUDA device: the port never falls back
    to the CPU by itself; pass ``device="cpu"`` for a CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} asked for, but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _nan_where_nonfinite(M: torch.Tensor):
    """(M with its non-finite matrices zeroed, a NaN-or-0 offset per matrix)."""
    bad = ~torch.isfinite(M).flatten(-2).all(-1)
    return torch.where(bad[..., None, None], 0.0, M), torch.where(bad, torch.nan, 0.0).to(M.dtype)


def svd(M: torch.Tensor):
    """``torch.linalg.svd`` (reduced) with ``jnp.linalg.svd``'s answer for a
    matrix that holds a NaN or an infinity: NaN factors, where torch raises.
    The two-view batch meets such matrices on pairs with one or two matches
    (every minimal set repeats a point); the reference marks those pairs
    invalid and goes on."""
    M, nan = _nan_where_nonfinite(M)
    U, S, Vh = torch.linalg.svd(M)
    return U + nan[..., None, None], S + nan[..., None], Vh + nan[..., None, None]


def eigh(M: torch.Tensor):
    """``torch.linalg.eigh`` with NaN eigenpairs for a matrix that holds a
    NaN or an infinity, as ``jnp.linalg.eigh`` gives (see ``svd``)."""
    M, nan = _nan_where_nonfinite(M)
    w, V = torch.linalg.eigh(M)
    return w + nan[..., None], V + nan[..., None, None]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul for small geometry matrices (float32; callers run under
    ``precise()``)."""
    return torch.matmul(a, b)


def einsum(subscripts: str, *operands) -> torch.Tensor:
    """Full-precision einsum: ``torch.einsum`` under ``precise()``, the
    port's counterpart of the reference's einsum at ``HIGHEST`` (torch has
    no per-call precision argument)."""
    with precise():
        return torch.einsum(subscripts, *operands)


class TensorStruct:
    """Mixin for the port's dataclasses of tensors (the JAX pytrees):
    ``map`` applies a function to every tensor field, ``replace`` swaps
    fields. Nested TensorStructs are mapped recursively."""

    def map(self, fn):
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, TensorStruct):
                out[f.name] = v.map(fn)
            elif isinstance(v, torch.Tensor):
                out[f.name] = fn(v)
            else:
                out[f.name] = v
        return dataclasses.replace(self, **out)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


def where_struct(cond: torch.Tensor, a: TensorStruct, b: TensorStruct) -> TensorStruct:
    """Field-wise ``torch.where(cond, a, b)`` for a scalar boolean ``cond``
    (the accept/reject of the LM loops, with no host sync)."""
    out = {}
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, TensorStruct):
            out[f.name] = where_struct(cond, va, vb)
        elif isinstance(va, torch.Tensor):
            out[f.name] = torch.where(cond, va, vb)
        else:
            out[f.name] = va
    return dataclasses.replace(a, **out)


class SegmentSum:
    """Scatter-add onto a fixed index set, summed in a fixed order.

    ``SegmentSum(shape, *index)`` takes one index tensor (E,) per output
    dimension; calling it with vals (E, ...) returns ``out`` of shape
    ``shape + vals.shape[1:]`` with out[index[:, e]] the sum of the vals
    that share that index: the reference's ``.at[].add``.

    Not ``index_add_`` or ``index_put_(accumulate=True)``: on CUDA those add
    with float atomics in no fixed order, so a solve built from them, and
    every decision downstream of it, changes from run to run. Here the keys
    are sorted once (the edge structure is fixed for a whole solve); each
    call gathers vals in that order, sums each run of equal keys with
    ``torch.segment_reduce`` (a sequential or CUB segmented sum, the same
    order every time) and writes the sums with a non-accumulating index.
    O(E) per call."""

    def __init__(self, shape: Sequence[int], *index: torch.Tensor):
        self.shape = tuple(int(s) for s in shape)
        key = torch.zeros_like(index[0], dtype=torch.int64)
        for size, idx in zip(self.shape, index):
            key = key * size + idx.to(torch.int64)
        self.order = torch.argsort(key, stable=True)
        self.keys, self.lengths = torch.unique_consecutive(key[self.order], return_counts=True)

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        size = 1
        for s in self.shape:
            size *= s
        out = vals.new_zeros((size,) + vals.shape[1:])
        if self.order.numel():
            # unsafe: skips the checks of ``lengths`` against the data, which
            # read device values back to the host (two syncs per call); the
            # lengths come from unique_consecutive and sum to E by construction
            out[self.keys] = torch.segment_reduce(
                vals[self.order], "sum", lengths=self.lengths, axis=0, unsafe=True)
        return out.reshape(self.shape + vals.shape[1:])


def jacobian_fwd(fn, x: torch.Tensor) -> torch.Tensor:
    """Per-row forward-mode Jacobian of a batched function: ``fn`` maps
    x (B, n) to (B, ...) with rows independent; returns (B, ..., n).

    One ``torch.func.jvp`` per parameter with the unit tangent broadcast
    over the batch — the reference's vmapped ``jax.jacfwd``. (vmap + jacfwd
    is avoided on purpose: per-sample 0-dim intermediates lose PyTorch's
    scalar type-promotion rule under forward-mode AD and turn float64.)"""
    cols = []
    for i in range(x.shape[-1]):
        tangent = torch.zeros_like(x)
        tangent[..., i] = 1.0
        cols.append(torch.func.jvp(fn, (x,), (tangent,))[1])
    return torch.stack(cols, dim=-1)


def jacobian_fwd_stacked(fn, x: torch.Tensor) -> torch.Tensor:
    """``jacobian_fwd`` in one ``torch.func.jvp``: the batch x (B, n) is
    stacked n times, (n, B, n), with the unit tangents, so ``fn`` must
    broadcast over a leading axis. One call's host overhead instead of n,
    for functions whose jvp costs more to dispatch than to run (the SE3
    logs of BA's pose priors)."""
    n = x.shape[-1]
    xs = x.expand((n,) + tuple(x.shape)).clone()
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    tangent = eye.reshape((n,) + (1,) * (x.dim() - 1) + (n,)).expand_as(xs).clone()
    return torch.func.jvp(fn, (xs,), (tangent,))[1].movedim(0, -1)


def nullvec_pinned(AtA: torch.Tensor) -> torch.Tensor:
    """Nullvector of a rank-deficient (..., n, n) normal matrix by pinning
    the last coordinate to 1 and solving the leading (n-1) system (closed
    form for n == 4, unrolled pivoted elimination otherwise)."""
    n = AtA.shape[-1]
    B = AtA[..., : n - 1, : n - 1]
    b = -AtA[..., : n - 1, n - 1]
    if n == 4:
        y = _solve3_adjugate(B, b)
    else:
        ridge = 1e-10 * torch.eye(n - 1, dtype=AtA.dtype, device=AtA.device)
        y = solve_psd_unrolled(B + ridge, b)
    e = torch.cat([y, torch.ones_like(y[..., :1])], dim=-1)
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-20)


def _solve3_adjugate(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form solve of (..., 3, 3) x = (..., 3) via the adjugate."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    det = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    x0 = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) / det
    x1 = (c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) / det
    x2 = (c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]) / det
    return torch.stack([x0, x1, x2], dim=-1)


def solve_psd_unrolled(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small (..., n, n) PSD A by unrolled Gauss-Jordan
    elimination with largest-remaining-diagonal pivoting (n static)."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)  # (..., n, n+1)
    cols = torch.arange(n, device=A.device)
    done = torch.zeros(A.shape[:-2] + (n,), dtype=torch.bool, device=A.device)
    for _ in range(n):
        diag = torch.diagonal(M[..., :, :n], dim1=-2, dim2=-1).abs()
        p = torch.argmax(torch.where(done, torch.full_like(diag, -1.0), diag), dim=-1)
        prow = torch.gather(M, -2, p[..., None, None].expand(*p.shape, 1, n + 1))[..., 0, :]
        pval = torch.gather(prow, -1, p[..., None])
        pval = torch.where(pval.abs() > 1e-30, pval, torch.full_like(pval, 1e-30))
        prow = prow / pval
        factors = torch.gather(M, -1, p[..., None, None].expand(*p.shape, n, 1))[..., 0]
        elim = M - factors[..., None] * prow[..., None, :]
        is_p = cols == p[..., None]
        M = torch.where(is_p[..., None], prow[..., None, :], elim)
        done = done | is_p
    return torch.einsum("...ij,...i->...j", M[..., :, :n], M[..., :, n])


def nullvec_pinned_scalarized(AtA: torch.Tensor) -> torch.Tensor:
    """Hypothesis-grade nullvec_pinned for big batches of tiny systems:
    each matrix entry is its own batch-shaped tensor and the leading
    (n-1) system is eliminated unpivoted (a bad solve only loses a RANSAC
    vote)."""
    n = AtA.shape[-1]
    m = n - 1
    M = [[AtA[..., i, j] for j in range(m)] + [-AtA[..., i, m]] for i in range(m)]
    for k in range(m):
        piv = M[k][k]
        inv = torch.where(
            piv.abs() > 1e-30,
            1.0 / torch.where(piv == 0, torch.ones_like(piv), piv),
            torch.full_like(piv, 1e30),
        )
        row_k = [M[k][j] * inv for j in range(m + 1)]
        for i in range(m):
            if i == k:
                M[i] = row_k
            else:
                f = M[i][k]
                M[i] = [M[i][j] - f * row_k[j] for j in range(m + 1)]
    y = torch.stack([M[i][m] for i in range(m)], dim=-1)
    e = torch.cat([y, torch.ones_like(y[..., :1])], dim=-1)
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-20)


def nullvec_pinned_from_rows(A8: torch.Tensor) -> torch.Tensor:
    """``nullvec_pinned_scalarized`` fed from the (..., 8, 9) sample rows:
    builds the entries of the 9x9 normal matrix that the pinned solve reads
    (the leading 8x8 block's upper triangle and the pinned column) as
    batch-shaped tensors and solves without forming the matrix, with one
    pass of iterative refinement (the residual in float32, corrected
    through the same elimination). The reference's TPU branch of the
    essential solver; the port's essential path runs the scalarized solve,
    the reference's CPU branch."""
    m = 8
    a = [[A8[..., k, j] for j in range(9)] for k in range(m)]
    ent = {}
    for i in range(m):
        for j in range(i, m):
            ent[(i, j)] = sum(a[k][i] * a[k][j] for k in range(m))
    B = [[ent[(i, j)] if i <= j else ent[(j, i)] for j in range(m)] for i in range(m)]
    b = [-sum(a[k][i] * a[k][8] for k in range(m)) for i in range(m)]

    def gj_solve(rhs):
        M = [list(B[i]) + [rhs[i]] for i in range(m)]
        for k in range(m):
            piv = M[k][k]
            inv = torch.where(
                piv.abs() > 1e-30,
                1.0 / torch.where(piv == 0, torch.ones_like(piv), piv),
                torch.full_like(piv, 1e30),
            )
            row_k = [M[k][j] * inv for j in range(m + 1)]
            for i in range(m):
                if i == k:
                    M[i] = row_k
                else:
                    f = M[i][k]
                    M[i] = [M[i][j] - f * row_k[j] for j in range(m + 1)]
        return [M[i][m] for i in range(m)]

    y = gj_solve(b)
    r = [b[i] - sum(B[i][j] * y[j] for j in range(m)) for i in range(m)]
    dy = gj_solve(r)
    ys = torch.stack([y[i] + dy[i] for i in range(m)], dim=-1)
    e = torch.cat([ys, torch.ones_like(ys[..., :1])], dim=-1)
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-20)


def smallest_eigvec_power(A: torch.Tensor, iters: int = 60, est_iters: int = 12) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of small SPD matrices
    A (..., n, n) by shifted power iteration: ``est_iters`` steps estimate
    the largest eigenvalue (a Rayleigh quotient), then ``iters`` steps on
    1.01 lambda_max I - A, whose top eigenvector is A's bottom one. The
    start vector is the reference's fixed linspace(1, 2, n), normalized."""
    n = A.shape[-1]
    ramp = torch.linspace(1.0, 2.0, n, dtype=torch.float32)
    v0 = (ramp / torch.linalg.vector_norm(ramp)).to(dtype=A.dtype, device=A.device).expand(A.shape[:-2] + (n,))

    def normalize(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)

    with precise():
        v = v0
        for _ in range(est_iters):
            v = normalize(torch.einsum("...ij,...j->...i", A, v))
        lam_max = torch.sum(v * torch.einsum("...ij,...j->...i", A, v), dim=-1)
        shift = 1.01 * lam_max[..., None, None] + 1e-12
        Bm = shift * torch.eye(n, dtype=A.dtype, device=A.device) - A
        v = v0
        for _ in range(iters):
            v = normalize(torch.einsum("...ij,...j->...i", Bm, v))
    return v


def ceil_pow2(n: int, floor: int = 1) -> int:
    """Next power of two >= max(n, floor): the pad buckets that keep the
    solver shapes static across scenes."""
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# counter-based random draws
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def counter_uniform(
    seed: int,
    tag: int,
    stream: torch.Tensor,
    shape: Sequence[int],
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """Uniform float32 draws of shape ``stream.shape + shape``.

    Replaces ``jax.random``: element ``c`` of stream ``s`` is a hash of
    (seed, tag, s, c), so a pair's draws depend on its global pair id only
    (not on how pairs are chunked) and are the same on every device. The
    tag separates the random stages of one run."""
    dev = stream.device
    s = stream.to(torch.int64) & _M32
    base = _mix32(s ^ _mix32(torch.tensor((seed * 0x9E3779B1 + tag) & _M32, device=dev)))
    n = 1
    for d in shape:
        n *= int(d)
    ctr = torch.arange(n, dtype=torch.int64, device=dev)
    h = _mix32((base[..., None] + _mul32(ctr + 1, 0x9E3779B9)) & _M32)
    h = _mix32(h ^ base[..., None])
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    u = minval + (maxval - minval) * u
    return u.reshape(tuple(stream.shape) + tuple(shape))
