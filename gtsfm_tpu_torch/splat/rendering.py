"""Differentiable 3D Gaussian splat rasterization.

Port of gtsfm_tpu/splat/rendering.py: EWA projection of 3D gaussians to 2D
(``project_gaussians``), the brute renderer that evaluates every gaussian at
every pixel (``render``), and the tile-binned renderer the trainer uses
(``render_tiled``): one stable sort of packed (tile, depth) keys, per-tile
windows of at most ``per_tile_cap`` depth-ordered slots, and front-to-back
alpha compositing of each 16x16 tile.

The compositing is the reference's one Pallas kernel on this path
(``_composite_kernel``, entry ``_composite_tiles_pallas`` under the custom
VJP ``_tiled_composite``). Here it is ``composite_tiles``: on a CUDA tensor
it launches the hand-written kernel ``csrc/splat_composite.cu``, on a CPU
tensor it runs the plain version ``composite_tiles_plain`` (the reference's
``_composite_tiles_xla``). It never falls back from one to the other.
``TiledComposite`` is the gradient: as in the reference, the backward
recomputes the float32 gather and the plain compositing from the packed
attributes and differentiates through them, on both devices.

The kernel: one block of 64 threads per 16x16 tile, four pixels of one row
per thread, transmittance and RGB in registers. Each of the block's two
warps walks the tile's slots on its own, 32 at a time: every lane gathers
one slot's 9 float32 attributes from the (G, 9) table (the gather the TPU
did in XLA before its kernel), the warp keeps the slots whose q < 16
ellipse can reach its 8 rows (a conservative test: a dropped slot adds
exactly nothing there) and composites them front to back from shared
memory, with one ``ex2.approx`` per pixel and slot. Between 256-slot
batches the block stops once every pixel has T <= 1/255, the reference's
rule applied per tile. What bounds it on an H100 is not memory (about 40
bytes per slot against 256 pixels of about 20 float32 operations) but
instruction issue and the latency of each pixel's chain through T
(``scripts/composite_limits.py``). The reference packs rgb and the inverse
covariance as bf16 pairs for the TPU's gather; the kernel reads float32,
the formulation of the reference's CPU path and VJP.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gtsfm_tpu_torch.geometry import SE3, so3
from gtsfm_tpu_torch.splat.gs_data import GSData
from gtsfm_tpu_torch.utils import cuda_build
from gtsfm_tpu_torch.utils.numerics import mm

KERNEL_TILE = 16  # the kernel's tile side: one block per tile

# launches of the CUDA compositing kernel in this process (never incremented
# by the CPU path)
launch_count = 0


def project_gaussians(gs: GSData, wTc: SE3, K: torch.Tensor):
    """EWA projection. Returns (xy (G, 2), cov2d (G, 2, 2), depth (G,),
    alpha (G,), rgb (G, 3)), the J Σ Jᵀ chain unrolled over the shared 3x3
    as in the reference."""
    cTw = wTc.inverse()
    p_cam = cTw.transform(gs.means)  # (G, 3)
    z = p_cam[..., 2]
    # behind-camera gaussians are masked invisible downstream (z > 0.01);
    # a placeholder depth keeps every intermediate finite (an inf reached
    # through any where still poisons gradients: 0 * inf = NaN)
    z_safe = torch.where(z > 1e-6, z, torch.ones_like(z))
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = torch.clamp(p_cam[..., 0] / z_safe, -1e4, 1e4)
    y = torch.clamp(p_cam[..., 1] / z_safe, -1e4, 1e4)
    xy = torch.stack([fx * x + cx, fy * y + cy], dim=-1)

    # A = R_cam_world @ R_gauss, rows of A as three tuples of (G,) vectors
    Rg = so3.from_quat(gs.quats)  # (G, 3, 3)
    Wr = cTw.R  # (3, 3)
    A = [
        [Wr[i, 0] * Rg[:, 0, k] + Wr[i, 1] * Rg[:, 1, k] + Wr[i, 2] * Rg[:, 2, k] for k in range(3)]
        for i in range(3)
    ]
    # B = J @ A with J = [[fx/z, 0, -fx x/z], [0, fy/z, -fy y/z]]
    j0, j2x = fx / z_safe, fx * x / z_safe
    j1, j2y = fy / z_safe, fy * y / z_safe
    B0 = [j0 * A[0][k] - j2x * A[2][k] for k in range(3)]
    B1 = [j1 * A[1][k] - j2y * A[2][k] for k in range(3)]
    # cov2d = B diag(s^2) Bᵀ + 0.3 I (anti-alias dilation); overflowing
    # near-camera giants are rescaled as a whole by one shared factor, which
    # keeps the matrix positive definite
    s2 = torch.exp(2.0 * gs.log_scales)  # (G, 3)
    c00 = sum(B0[k] * B0[k] * s2[:, k] for k in range(3))
    c01 = sum(B0[k] * B1[k] * s2[:, k] for k in range(3))
    c11 = sum(B1[k] * B1[k] * s2[:, k] for k in range(3))
    cap = 1e8
    c00 = torch.where(torch.isfinite(c00), c00, torch.full_like(c00, cap))
    c11 = torch.where(torch.isfinite(c11), c11, torch.full_like(c11, cap))
    c01 = torch.where(torch.isfinite(c01), c01, torch.zeros_like(c01))
    m = torch.clamp(torch.maximum(c00, c11), min=1.0)
    # a numerical guard, not model semantics: no gradient through the cap
    f_cap = torch.clamp(cap / m, max=1.0).detach()
    c00 = c00 * f_cap + 0.3
    c01 = c01 * f_cap
    c11 = c11 * f_cap + 0.3
    cov2d = torch.stack([torch.stack([c00, c01], -1), torch.stack([c01, c11], -1)], dim=-2)

    alpha = torch.sigmoid(gs.opacity_logit) * gs.alive.to(gs.opacity_logit.dtype)
    rgb = torch.sigmoid(gs.colors)
    return xy, cov2d, z, alpha, rgb


def _inverse_cov(cov2d: torch.Tensor):
    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0]
    det = torch.clamp(det, min=1e-9)
    return det, cov2d[:, 1, 1] / det, -cov2d[:, 0, 1] / det, cov2d[:, 0, 0] / det


def render(gs: GSData, wTc: SE3, K: torch.Tensor, height: int, width: int, bg: float = 0.0,
           chunk: int = 256):
    """Brute-force render: every gaussian at every pixel, in depth-ordered
    chunks of ``chunk`` with the transmittance carried between chunks.
    Returns an (H, W, 3) image and an (H, W) alpha map."""
    xy, cov2d, z, alpha, rgb = project_gaussians(gs, wTc, K)
    G = gs.max_gaussians
    dev = xy.device

    visible = (z > 0.01) & (alpha > 1e-4)
    order = torch.argsort(torch.where(visible, z, torch.full_like(z, float("inf"))), stable=True)
    xy = xy[order]
    cov = cov2d[order]
    a = torch.where(visible[order], alpha[order], torch.zeros_like(alpha))
    col = rgb[order]
    _det, inv00, inv01, inv11 = _inverse_cov(cov)

    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    T = torch.ones((height, width), device=dev)
    color = torch.zeros((height, width, 3), device=dev)
    for s in range(0, G, chunk):
        e = min(s + chunk, G)
        dx = xs[..., None] - xy[s:e, 0]  # (H, W, C)
        dy = ys[..., None] - xy[s:e, 1]
        q = inv00[s:e] * dx * dx + 2 * inv01[s:e] * dx * dy + inv11[s:e] * dy * dy
        # f32 cancellation on capped near-singular covariances can leave q
        # hugely negative, and exp(+big) would leak NaN through the cutoff
        q = torch.clamp(q, min=0.0)
        g_alpha = torch.clamp(a[s:e] * torch.exp(-0.5 * q), max=0.995)
        g_alpha = torch.where(q < 16.0, g_alpha, torch.zeros_like(g_alpha))  # 4-sigma cutoff
        cum = torch.cumprod(1.0 - g_alpha, dim=-1)
        prefix = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], dim=-1)
        w = g_alpha * prefix
        color = color + T[..., None] * torch.einsum("hwc,cd->hwd", w, col[s:e])
        T = T * cum[..., -1]
    color = color + T[..., None] * bg
    return color, 1.0 - T


def render_tiled(gs: GSData, wTc: SE3, K: torch.Tensor, height: int, width: int, bg: float = 0.0,
                 tile: int = 16, per_tile_cap: int = 512, max_dup: int = 9):
    """Tile-binned rasterization (public wrapper).

    The sort key packs (tile_id, quantized depth) into int32: the tile grid
    takes ceil(log2(n_tiles + 2)) high bits, depth the top ``rank_bits``
    bits of the positive float32 depth's bit pattern (monotone in z). Depths
    equal in those bits composite in gaussian-index order. ``max_dup`` (a
    square) bounds the binning sort to G * max_dup keys: a footprint wider
    than sqrt(max_dup) tiles keeps the window centred on its centre tile."""
    rank_bits = _rank_bits(height, width, tile)
    if rank_bits < 8:  # absurd grid (> ~8M tiles): dense fallback, as the reference
        return render(gs, wTc, K, height, width, bg=bg)
    return _render_tiled_impl(gs, wTc, K, height, width, bg=bg, tile=tile, per_tile_cap=per_tile_cap,
                              max_dup=max_dup, rank_bits=rank_bits)


def _rank_bits(height: int, width: int, tile: int) -> int:
    """Depth bits of the sort key once the tile grid has its high bits (the
    top tile decode value stays reserved)."""
    n_tiles = (-(-height // tile)) * (-(-width // tile))
    return 31 - max(1, (n_tiles + 2).bit_length())


def _render_tiled_impl(gs: GSData, wTc: SE3, K: torch.Tensor, height: int, width: int, bg: float = 0.0,
                       tile: int = 16, per_tile_cap: int = 512, max_dup: int = 9, rank_bits: int = 20):
    """Binning (``bin_tiles``), then compositing through ``TiledComposite``,
    then the tiles laid out as an image."""
    th = tw = tile
    ny = (height + th - 1) // th
    nx = (width + tw - 1) // tw
    packed, gidx, counts, origins = bin_tiles(gs, wTc, K, height, width, tile=tile, per_tile_cap=per_tile_cap,
                                              max_dup=max_dup, rank_bits=rank_bits)
    color, T = TiledComposite.apply(packed, gidx, counts, origins, th)
    color = color + T[..., None] * bg

    img = color.reshape(ny, nx, th, tw, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(ny * th, nx * tw, 3)[:height, :width]
    am = (1.0 - T).reshape(ny, nx, th, tw).permute(0, 2, 1, 3)
    am = am.reshape(ny * th, nx * tw)[:height, :width]
    return img, am


def bin_tiles(gs: GSData, wTc: SE3, K: torch.Tensor, height: int, width: int, tile: int = 16,
              per_tile_cap: int = 512, max_dup: int = 9, rank_bits: int | None = None):
    """The gsplat binning as tensor ops, up to the compositing's inputs: one
    stable sort of the duplicated (tile, depth) keys carrying the gaussian
    index, two searchsorted passes for each tile's [start, end), and the
    first ``per_tile_cap`` slots of each tile gathered from the cap-padded
    sorted list. Returns packed (G, 9), gidx (n_tiles, cap) int32, counts
    (n_tiles,) int32 and origins (n_tiles, 2) int32, tiles in row-major
    order."""
    if rank_bits is None:
        rank_bits = _rank_bits(height, width, tile)
    th = tw = tile
    ny = (height + th - 1) // th
    nx = (width + tw - 1) // tw
    n_tiles = ny * nx
    G = gs.max_gaussians
    dev = gs.means.device
    # the top tile decode value is reserved: invalid duplicates carry key
    # int32-max, whose high bits sort after every real tile
    if n_tiles >= (1 << (31 - rank_bits)) - 1:
        raise ValueError(f"{n_tiles} tiles do not fit the {31 - rank_bits} tile bits of the sort key")

    xy, cov2d, z, alpha, rgb = project_gaussians(gs, wTc, K)
    visible = (z > 0.01) & (alpha > 1e-4)
    det, inv00, inv01, inv11 = _inverse_cov(cov2d)
    # 4-sigma radius of the major axis (the q < 16 cutoff): it only selects
    # tiles, so it carries no gradient (sqrt(mid^2 - det) has an infinite
    # derivative at isotropic covariances)
    mid = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    radius = (4.0 * torch.sqrt(torch.clamp(lam1, min=0.0))).detach()
    xyd = xy.detach()

    side = int(max_dup**0.5)
    if side * side != max_dup:
        raise ValueError(f"max_dup must be a square, got {max_dup}")

    def tile_of(v, n, size):
        return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int32)

    tx0, tx1 = tile_of(xyd[:, 0] - radius, nx, tw), tile_of(xyd[:, 0] + radius, nx, tw)
    ty0, ty1 = tile_of(xyd[:, 1] - radius, ny, th), tile_of(xyd[:, 1] + radius, ny, th)
    tcx, tcy = tile_of(xyd[:, 0], nx, tw), tile_of(xyd[:, 1], ny, th)
    wx0 = torch.minimum(torch.maximum(tcx - (side - 1) // 2, tx0), torch.maximum(tx1 - side + 1, tx0))
    wy0 = torch.minimum(torch.maximum(tcy - (side - 1) // 2, ty0), torch.maximum(ty1 - side + 1, ty0))
    dxs = torch.arange(side, dtype=torch.int32, device=dev)
    gx = wx0[:, None] + dxs[None, :]  # (G, side)
    gy = wy0[:, None] + dxs[None, :]
    in_x = gx <= tx1[:, None]
    in_y = gy <= ty1[:, None]
    tile_id = (gy[:, :, None] * nx + gx[:, None, :]).reshape(G, max_dup)
    dup_ok = (in_y[:, :, None] & in_x[:, None, :]).reshape(G, max_dup) & visible[:, None]

    # depth key: the top rank_bits of z's float32 bits. z is clamped
    # positive, so the sign bit is 0 and the arithmetic shift is a logical one
    zbits = torch.clamp(z.detach(), min=1e-30).contiguous().view(torch.int32)
    depth_q = zbits >> (31 - rank_bits)
    key = torch.where(dup_ok, tile_id * (1 << rank_bits) + depth_q[:, None],
                      torch.full_like(tile_id, torch.iinfo(torch.int32).max)).reshape(-1)
    sorted_key, perm = torch.sort(key, stable=True)
    sorted_gauss = (perm // max_dup).to(torch.int32)
    sorted_tile = (sorted_key >> rank_bits).contiguous()  # invalid entries decode past n_tiles

    tids = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    st = torch.searchsorted(sorted_tile, tids, right=False)
    en = torch.searchsorted(sorted_tile, tids, right=True)
    # the cap-row zero pad keeps every window in range for segments ending at N
    sg_pad = torch.cat([sorted_gauss, torch.zeros(per_tile_cap, dtype=torch.int32, device=dev)])
    gidx = sg_pad[st[:, None] + torch.arange(per_tile_cap, device=dev)[None, :]]  # (n_tiles, cap)

    packed = torch.stack([xy[:, 0], xy[:, 1], alpha, rgb[:, 0], rgb[:, 1], rgb[:, 2], inv00, inv01, inv11],
                         dim=-1)  # (G, 9)
    counts = torch.clamp(en - st, 0, per_tile_cap).to(torch.int32)
    origins = torch.stack([(tids % nx) * tw, (tids // nx) * th], dim=-1).to(torch.int32)
    return packed, gidx, counts, origins


# ---------------------------------------------------------------------------
# tile compositing: the plain version, the kernel, and the gradient
# ---------------------------------------------------------------------------
def _gather_attrs_f32(packed: torch.Tensor, gidx: torch.Tensor, counts: torch.Tensor):
    """(G, 9) rows -> per-tile (n_tiles, cap) attribute tables; slots at or
    past a tile's count get alpha 0."""
    cap = gidx.shape[1]
    t_attr = packed[gidx.long()]  # (n_tiles, cap, 9)
    slot_ok = torch.arange(cap, device=packed.device)[None, :] < counts[:, None]
    t_a = torch.where(slot_ok, t_attr[..., 2], torch.zeros_like(t_attr[..., 2]))
    return t_attr[..., 0:2], t_a, t_attr[..., 3:6], t_attr[..., 6], t_attr[..., 7], t_attr[..., 8]


def composited_slots(cap: int) -> int:
    """How many of a tile's ``cap`` slots the compositing reads: whole
    chunks of min(64, cap), as the reference's scan (a remainder past the
    last whole chunk is never composited)."""
    chunk = min(64, cap)
    return (cap // chunk) * chunk if chunk else 0


def composite_tiles_plain(t_xy, t_a, t_rgb, t_i00, t_i01, t_i11, origins, tile: int):
    """Front-to-back compositing of every tile over its slots in chunks of
    64 (the reference's ``_composite_tiles_xla``): the CPU forward and the
    differentiable formulation behind the kernel's gradient. Returns color
    (n_tiles, tile², 3) and transmittance (n_tiles, tile²)."""
    n_tiles, cap = t_a.shape
    dev = t_a.device
    py, px = torch.meshgrid(torch.arange(tile, dtype=torch.float32, device=dev),
                            torch.arange(tile, dtype=torch.float32, device=dev), indexing="ij")
    pix_x = origins[:, 0].float()[:, None] + px.reshape(-1)[None, :]  # (n_tiles, P)
    pix_y = origins[:, 1].float()[:, None] + py.reshape(-1)[None, :]

    chunk = min(64, cap)
    T = torch.ones((n_tiles, tile * tile), device=dev)
    color = torch.zeros((n_tiles, tile * tile, 3), device=dev)
    for s in range(0, composited_slots(cap), chunk):
        sl = slice(s, s + chunk)
        dx = pix_x[:, None, :] - t_xy[:, sl, 0, None]  # (n_tiles, chunk, P)
        dy = pix_y[:, None, :] - t_xy[:, sl, 1, None]
        q = t_i00[:, sl, None] * dx * dx + 2.0 * t_i01[:, sl, None] * dx * dy + t_i11[:, sl, None] * dy * dy
        q = torch.clamp(q, min=0.0)  # f32 cancellation guard (see render)
        g_alpha = torch.clamp(t_a[:, sl, None] * torch.exp(-0.5 * q), max=0.995)
        g_alpha = torch.where(q < 16.0, g_alpha, torch.zeros_like(g_alpha))
        cum = torch.cumprod(1.0 - g_alpha, dim=1)  # over the chunk, front to back
        prefix = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        w = g_alpha * prefix  # (n_tiles, chunk, P)
        color = color + T[:, :, None] * torch.einsum("tcp,tcd->tpd", w, t_rgb[:, sl])
        T = T * cum[:, -1]
    return color, T


@functools.cache
def _kernel():
    return cuda_build.function("splat_composite", "gtsfm_splat_composite",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)


def _check(packed, gidx, counts, origins, tile):
    if packed.dim() != 2 or packed.shape[1] != 9 or packed.dtype != torch.float32:
        raise ValueError(f"packed must be float32 (G, 9): {packed.dtype} {tuple(packed.shape)}")
    if gidx.dim() != 2:
        raise ValueError(f"gidx must be (n_tiles, cap): {tuple(gidx.shape)}")
    n_tiles = gidx.shape[0]
    if tuple(counts.shape) != (n_tiles,) or tuple(origins.shape) != (n_tiles, 2):
        raise ValueError(f"counts {tuple(counts.shape)} / origins {tuple(origins.shape)} do not match "
                         f"{n_tiles} tiles")
    for name, t in (("gidx", gidx), ("counts", counts), ("origins", origins)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for t in (packed, gidx, counts, origins):
        if t.device != packed.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    if packed.device.type == "cuda" and tile != KERNEL_TILE:
        raise ValueError(f"the kernel composites {KERNEL_TILE}x{KERNEL_TILE} tiles, not {tile}x{tile}")
    if packed.shape[0] == 0 or n_tiles > 2**31 - 1 or gidx.shape[1] > 2**31 - 1:
        raise ValueError(f"unsupported sizes G={packed.shape[0]} n_tiles={n_tiles} cap={gidx.shape[1]}")
    return n_tiles, gidx.shape[1]


def composite_tiles(packed: torch.Tensor, gidx: torch.Tensor, counts: torch.Tensor, origins: torch.Tensor,
                    tile: int):
    """(G, 9) per-gaussian attributes (x, y, alpha, r, g, b, inv00, inv01,
    inv11) and per-tile depth-sorted slot indices gidx (n_tiles, cap) with
    their valid counts and pixel origins -> color (n_tiles, tile², 3) and
    transmittance (n_tiles, tile²). CPU tensors run the plain version; CUDA
    tensors launch the kernel (or raise)."""
    n_tiles, cap = _check(packed, gidx, counts, origins, tile)
    if packed.device.type == "cpu":
        return composite_tiles_plain(*_gather_attrs_f32(packed, gidx, counts), origins, tile)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    global launch_count
    dev = packed.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return composite_tiles(packed, gidx, counts, origins, tile)
    P = tile * tile
    color = torch.empty((n_tiles, P, 3), dtype=torch.float32, device=dev)
    T = torch.empty((n_tiles, P), dtype=torch.float32, device=dev)
    if n_tiles == 0:
        return color, T
    rc = _kernel()(packed.data_ptr(), gidx.data_ptr(), counts.data_ptr(), origins.data_ptr(), packed.shape[0],
                   n_tiles, cap, composited_slots(cap), color.data_ptr(), T.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"splat composite launch failed: cudaError {rc}")
    launch_count += 1
    return color, T


class TiledComposite(torch.autograd.Function):
    """``composite_tiles`` with the reference's gradient: the backward
    recomputes the float32 gather and ``composite_tiles_plain`` from the
    packed attributes and differentiates through them (the early stop only
    skips tails below 1/255 of transmittance, which the gradient tolerates).
    Only ``packed`` gets a gradient."""

    @staticmethod
    def forward(ctx, packed, gidx, counts, origins, tile):
        ctx.save_for_backward(packed, gidx, counts, origins)
        ctx.tile = tile
        return composite_tiles(packed, gidx, counts, origins, tile)

    @staticmethod
    def backward(ctx, d_color, d_T):
        packed, gidx, counts, origins = ctx.saved_tensors
        with torch.enable_grad():
            p = packed.detach().requires_grad_(True)
            out = composite_tiles_plain(*_gather_attrs_f32(p, gidx, counts), origins, ctx.tile)
            (d_packed,) = torch.autograd.grad(out, (p,), (d_color, d_T))
        return d_packed, None, None, None, None


def bspline_camera_path(wTi: SE3, num_frames: int) -> SE3:
    """Smooth camera path through the given poses: uniform Catmull-Rom on
    the centers, geodesic interpolation between the two bracketing
    rotations."""
    n = wTi.t.shape[0]
    dev = wTi.t.device
    u = torch.linspace(0, n - 1.0001, num_frames, dtype=torch.float32, device=dev)
    i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, n - 2)
    f = (u - i0)[:, None]
    im1 = torch.clamp(i0 - 1, 0, n - 1)
    i1 = i0 + 1
    i2 = torch.clamp(i0 + 2, 0, n - 1)
    P0, P1, P2, P3 = (wTi.t[i] for i in (im1, i0, i1, i2))
    f2 = f * f
    f3 = f2 * f
    centers = 0.5 * (
        2 * P1 + (-P0 + P2) * f + (2 * P0 - 5 * P1 + 4 * P2 - P3) * f2
        + (-P0 + 3 * P1 - 3 * P2 + P3) * f3
    )
    Ra = wTi.R[i0]
    Rb = wTi.R[i1]
    rel = so3.logmap(mm(Ra.transpose(-1, -2), Rb))
    return SE3(R=mm(Ra, so3.expmap(rel * f)), t=centers)

