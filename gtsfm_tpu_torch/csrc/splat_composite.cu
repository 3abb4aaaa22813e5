// Front-to-back Gaussian splat tile compositing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gtsfm_tpu/splat/rendering.py:420
// (_composite_kernel, entry _composite_tiles_pallas, under the custom VJP
// _tiled_composite). It computes what splat/rendering.py's
// composite_tiles_plain computes on _gather_attrs_f32's tables, with the
// gather fused in:
//
//   for each tile t, pixel p = (ox + p % 16, oy + p / 16), slot j < count[t]
//   in order (depth-sorted by the binning), gaussian g = gidx[t, j]:
//     q  = max(i00 dx^2 + 2 i01 dx dy + i11 dy^2, 0),  (dx, dy) = p - xy_g
//     a  = min(alpha_g exp(-q / 2), 0.995), and 0 where q >= 16
//     C += a T rgb_g;  T *= 1 - a
//
// What bounds it on an H100: about 20 float32 operations and one exp per
// pixel-slot pair against 40 bytes read per slot, so not the bytes; and
// not the float32 peak either but instruction issue and latency: at the
// trainer's shape (1200 tiles x cap 512, 295,024 evaluated slots) every
// instruction per pixel-slot costs about 2 us of issue on 132 SMs, and the
// slots of one pixel form one dependent chain, so the longest tiles' warps
// set the tail (scripts/composite_limits.py measures both). The design:
//
// - Pixels per thread: a block of THREADS = 256 / PIX threads (PIX = 4: two
//   warps) composites one 16x16 tile; each thread owns PIX neighbouring
//   pixels of one row, so a slot's shared-memory reads and its dy terms
//   (dy, 2 i01 dy, i11 dy^2) are paid once for PIX pixels and q is two
//   FMAs per pixel, dx (i00 dx + 2 i01 dy) + i11 dy^2. Small blocks let
//   every tile of a 480x640 image be resident at once.
// - Warps work alone: each warp composites its 2 PIX rows over the tile's
//   slots with no barrier but the early stop's. It stages 32 slots at a
//   time, one gathered per lane, and keeps only the slots whose q < 16
//   ellipse can reach its rows (`touches`, a conservative test, so a
//   dropped slot is one that adds exactly nothing there).
// - Shared-memory layout: a kept slot is three float4s (x, y, i00, 2 i01),
//   (i11, alpha, r, g), (b, -, -, -): three broadcast reads per slot
//   instead of nine. 2 i01 is exact.
// - exp: exp(-q/2) = ex2(q (-log2(e) / 2)) as one ex2.approx.ftz (inline
//   PTX; the build keeps accurate math elsewhere). The q < 16 cutoff tests
//   q itself, before the rescaling, so no boundary slot flips against the
//   plain version's test; a cut pixel's exponent is -inf, so ex2 gives 0.
// - Software pipeline: while slot j blends, slot j + 1's exponentials are
//   in flight and slot j + 2's attributes are read. T = fma(-a, T, T), one
//   rounding of T (1 - a).
// - Prefetch: while a warp composites a stage, its registers already hold
//   the attributes of the next one, gathered with the index loaded a stage
//   before, so no load waits on another.
// - Early stop: the block stops at a 256-slot boundary once every
//   pixel has T <= 1/255 (__syncthreads_or), the reference's early-saturation
//   rule per tile: the skipped tail adds at most 1/255 to any output.
// - Tile order: blocks take tiles in order. Longest tiles first gains about
//   5% of the kernel, less than sorting the counts on the card costs.
//
// Blocks are independent: no atomics, the result is deterministic and does
// not depend on the schedule. Slot indices outside [0, G) and slots at or
// past count contribute nothing (alpha 0: never staged). Only the first
// `limit` slots of a row are read (the plain version's whole-chunk rule,
// composited_slots in rendering.py). Empty tiles give color 0 and T = 1.
//
// Measurement builds (scripts/composite_limits.py): -DGTSFM_COMPOSITE_PIX=2
// or 8 sets the pixels per thread; -DGTSFM_COMPOSITE_NO_CULL keeps every
// slot of nonzero alpha; -DGTSFM_COMPOSITE_CLOCKS records each block's SM,
// start and end (%globaltimer, ns), clock64 duration and its warps' clocks
// by phase, which gtsfm_splat_composite_clocks reads.
//
// Returns a cudaError_t as int: the launch error, or cudaErrorInvalidValue
// for arguments the kernel does not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TILE 16
#define NPIX (TILE * TILE)
#ifndef GTSFM_COMPOSITE_PIX
#define GTSFM_COMPOSITE_PIX 4
#endif
#define PIX GTSFM_COMPOSITE_PIX  // pixels of one row per thread
#define THREADS (NPIX / PIX)
#define WARPS (THREADS / 32)
#define WARP_ROWS (32 * PIX / TILE)  // rows of the tile a warp composites
#define STAGE 32                     // slots a warp stages per step: one per lane
#define STOP_BATCH 256               // slots between early-stop checks
#define T_STOP (1.0f / 255.0f)
#define NEG_HALF_LOG2E (-0.72134752044448170f)  // exp(-q/2) = 2^(q * this)

static_assert(TILE % PIX == 0 && (PIX == 2 || PIX == 4 || PIX == 8), "PIX: 2, 4 or 8 pixels of one row");
static_assert(STOP_BATCH % STAGE == 0, "stages must tile the stop batch");

#ifdef GTSFM_COMPOSITE_CLOCKS
#define CLOCK_TILES 8192
// per tile: sm, start ns, end ns, clock64 ticks; then summed over its
// warps: clocks staging (waiting for the gathered slots included),
// compositing, at the stop checks, and slots kept
__device__ unsigned long long g_clocks[CLOCK_TILES][8];
#define CLK(v) long long v = clock64()
#define CLK_ADD(acc, since) acc += clock64() - (since)
#else
#define CLK(v)
#define CLK_ADD(acc, since)
#endif

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// gaussian g's 9 attributes as the three staged float4s (x, y, i00, 2 i01),
// (i11, alpha, r, g), (b, -, -, -); zeros (alpha 0) for g outside [0, G)
__device__ __forceinline__ void gather(const float* __restrict__ packed, int g, int G, float4& a, float4& b,
                                       float4& c) {
  if (g >= 0 && g < G) {
    const float* p = packed + (size_t)g * 9;
    a = make_float4(p[0], p[1], p[6], 2.0f * p[7]);
    b = make_float4(p[8], p[2], p[3], p[4]);
    c = make_float4(p[5], 0.0f, 0.0f, 0.0f);
  } else {
    a = b = c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// the least of q = A d^2 + 2 i01 d e + B e^2 over e in [lo, hi], one
// offset d fixed: q along one edge of a pixel rectangle
__device__ __forceinline__ float edge_min(float d, float lo, float hi, float A, float B, float i01) {
  const float e = fminf(fmaxf(-__fdividef(i01 * d, B), lo), hi);
  return fmaf(A * d, d, fmaf(2.0f * i01 * d, e, B * e * e));
}

// false only where the slot adds exactly nothing to any pixel (x0..x1,
// y0..y1): alpha 0, or a positive definite conic whose least q over the
// rectangle is at least 16.5. The least q of a convex quadratic whose
// centre lies outside a rectangle is on one of its edges. The margin
// covers the float32 rounding of both that least value and the kernel's
// q: with i01^2 <= 0.999 i00 i11 each is within 2e-3 of the exact one
// (q >= (1 - sqrt(0.999)) (i00 dx^2 + i11 dy^2), and a few roundings of
// terms no larger than twice that sum), so every pixel of the rectangle has
// a computed q of 16 or more and the kernel's own alpha there is 0. Nearly
// degenerate or non-finite conics are kept.
__device__ __forceinline__ bool touches(const float4& a, const float4& b, float x0, float x1, float y0,
                                        float y1) {
  const float i00 = a.z, i01 = 0.5f * a.w, i11 = b.x;
  if (b.y == 0.0f) return false;
#ifdef GTSFM_COMPOSITE_NO_CULL
  return true;
#endif
  if (!(i00 > 0.0f && i11 > 0.0f && i01 * i01 <= 0.999f * i00 * i11 &&
        fabsf(a.x) + fabsf(a.y) + i00 + i11 < 1e30f)) {
    return true;
  }
  const float lx = x0 - a.x, hx = x1 - a.x, ly = y0 - a.y, hy = y1 - a.y;  // the rectangle about the centre
  if (lx <= 0.0f && hx >= 0.0f && ly <= 0.0f && hy >= 0.0f) return true;
  const float q = fminf(fminf(edge_min(lx, ly, hy, i00, i11, i01), edge_min(hx, ly, hy, i00, i11, i01)),
                        fminf(edge_min(ly, lx, hx, i11, i00, i01), edge_min(hy, lx, hx, i11, i00, i01)));
  return !(q >= 16.5f);
}

// one slot's exp(-q/2) at each of the thread's PIX pixels (px[k], py),
// 0 where q >= 16 (the cutoff tests q itself; ex2(-inf) = 0)
__device__ __forceinline__ void gauss(const float4& A, const float4& B, const float* px, float py, float* e) {
  const float dy = py - A.y;
  const float e01 = A.w * dy;
  const float e11 = B.x * dy * dy;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const float dx = px[k] - A.x;
    const float q = fmaf(fmaf(A.z, dx, e01), dx, e11);
    e[k] = ex2_approx(q < 16.0f ? fmaxf(q, 0.0f) * NEG_HALF_LOG2E : -INFINITY);
  }
}

__global__ void __launch_bounds__(THREADS)
splat_composite_kernel(const float* __restrict__ packed,
                       const int* __restrict__ gidx,
                       const int* __restrict__ counts,
                       const int* __restrict__ origins,
                       int G, int cap, int limit,
                       float* __restrict__ color,
                       float* __restrict__ T_out) {
  // a warp's kept slots of one stage, then two zero slots (the loop reads
  // two slots ahead)
  __shared__ float4 s_slot[WARPS][STAGE + 2][3];

#ifdef GTSFM_COMPOSITE_CLOCKS
  unsigned long long t_start;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_start));
  const long long c_start = clock64();
  long long c_stage = 0, c_loop = 0, c_stop = 0, n_kept = 0;
#endif
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int count = min(max(counts[t], 0), limit);
  const int prow = tid / (TILE / PIX);
  const int pcol = (tid % (TILE / PIX)) * PIX;
  const float ox = (float)origins[2 * t], oy = (float)origins[2 * t + 1];
  const float py = oy + prow;
  float px[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) px[k] = ox + (pcol + k);
  // this warp's pixels: rows y0..y1, columns x0..x1
  const float x0 = ox, x1 = ox + (TILE - 1);
  const float y0 = oy + warp * WARP_ROWS, y1 = y0 + (WARP_ROWS - 1);
  const int* row = gidx + (size_t)t * cap;
  float4(*slots)[3] = s_slot[warp];

  float T[PIX], cr[PIX], cg[PIX], cb[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
  }

  // registers: the attributes of the lane's slot in the next stage, and
  // the index of its slot in the stage after it
  float4 ra, rb, rc;
  gather(packed, lane < count ? row[lane] : -1, G, ra, rb, rc);
  int g_next = STAGE + lane < count ? row[STAGE + lane] : -1;

  for (int s = 0; s < count; s += STAGE) {
    if (s > 0 && s % STOP_BATCH == 0) {  // the whole block stops together
      CLK(c0);
      bool live = false;
#pragma unroll
      for (int k = 0; k < PIX; ++k) live |= T[k] > T_STOP;
      const bool go = __syncthreads_or(live);
      CLK_ADD(c_stop, c0);
      if (!go) break;
    }
    CLK(c1);
    // the stage's slots that reach this warp's pixels, in depth order
    const bool keep = touches(ra, rb, x0, x1, y0, y1);
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    const int n = __popc(kept);
    __syncwarp();  // the last stage's reads are done
    if (keep) {
      const int at = __popc(kept & ((1u << lane) - 1u));
      slots[at][0] = ra;
      slots[at][1] = rb;
      slots[at][2] = rc;
    }
    if (lane < 2) {  // the two slots past the last kept one
      slots[n + lane][0] = slots[n + lane][1] = slots[n + lane][2] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncwarp();
    if (s + STAGE < count) {  // in flight while this stage composites
      gather(packed, g_next, G, ra, rb, rc);
      const int j = s + 2 * STAGE + lane;
      g_next = j < count ? row[j] : -1;
    }
    CLK_ADD(c_stage, c1);
    CLK(c2);
    // a software pipeline over the kept slots: while slot j blends, the
    // exponentials of slot j + 1 are in flight and slot j + 2's attributes
    // are read, so no step waits on the exponential unit or shared memory.
    // Slots past n read as zeros and are never blended.
    float4 B1 = slots[0][1];  // (i11, alpha, r, g)
    float s1 = slots[0][2].x;  // b
    float e1[PIX];
    gauss(slots[0][0], B1, px, py, e1);
    float4 A2 = slots[1][0], B2 = slots[1][1];  // (x, y, i00, 2 i01), (i11, alpha, r, g)
    float s2 = slots[1][2].x;
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4 A3 = slots[j + 2][0], B3 = slots[j + 2][1];
      const float s3 = slots[j + 2][2].x;
      float e2[PIX];
      gauss(A2, B2, px, py, e2);
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        const float a = fminf(B1.y * e1[k], 0.995f);
        const float w = a * T[k];
        cr[k] = fmaf(w, B1.z, cr[k]);
        cg[k] = fmaf(w, B1.w, cg[k]);
        cb[k] = fmaf(w, s1, cb[k]);
        T[k] = fmaf(-a, T[k], T[k]);
        e1[k] = e2[k];
      }
      B1 = B2;
      s1 = s2;
      A2 = A3;
      B2 = B3;
      s2 = s3;
    }
    CLK_ADD(c_loop, c2);
#ifdef GTSFM_COMPOSITE_CLOCKS
    n_kept += n;
#endif
  }

  // PIX neighbouring pixels: 3 PIX consecutive color floats, PIX of T
  const size_t pix = (size_t)t * NPIX + prow * TILE + pcol;
  float out[3 * PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    out[3 * k] = cr[k];
    out[3 * k + 1] = cg[k];
    out[3 * k + 2] = cb[k];
  }
  float2* c2 = reinterpret_cast<float2*>(color + 3 * pix);  // 8-byte aligned: pix is even
#pragma unroll
  for (int i = 0; i < 3 * PIX / 2; ++i) c2[i] = make_float2(out[2 * i], out[2 * i + 1]);
  float2* t2 = reinterpret_cast<float2*>(T_out + pix);
#pragma unroll
  for (int i = 0; i < PIX / 2; ++i) t2[i] = make_float2(T[2 * i], T[2 * i + 1]);

#ifdef GTSFM_COMPOSITE_CLOCKS
  if (lane == 0 && t < CLOCK_TILES) {
    atomicAdd(&g_clocks[t][4], (unsigned long long)c_stage);
    atomicAdd(&g_clocks[t][5], (unsigned long long)c_loop);
    atomicAdd(&g_clocks[t][6], (unsigned long long)c_stop);
    atomicAdd(&g_clocks[t][7], (unsigned long long)n_kept);
  }
  __syncthreads();
  if (tid == 0 && t < CLOCK_TILES) {
    unsigned long long t_end;
    unsigned int sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_end));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_clocks[t][0] = sm;
    g_clocks[t][1] = t_start;
    g_clocks[t][2] = t_end;
    g_clocks[t][3] = (unsigned long long)(clock64() - c_start);
  }
#endif
}

extern "C" int gtsfm_splat_composite(const float* packed, const int* gidx, const int* counts,
                                     const int* origins, int G, int n_tiles, int cap, int limit,
                                     float* color, float* T, void* stream) {
  if (G <= 0 || n_tiles <= 0 || cap < 0 || limit < 0 || limit > cap) return (int)cudaErrorInvalidValue;
  splat_composite_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(packed, gidx, counts, origins, G, cap,
                                                                         limit, color, T);
  return (int)cudaGetLastError();
}

#ifdef GTSFM_COMPOSITE_CLOCKS
// copies the first n tiles' 8 counters (g_clocks) to host memory `out`
// (8 n unsigned 64-bit values) and zeroes them
extern "C" int gtsfm_splat_composite_clocks(unsigned long long* out, int n) {
  if (n < 0 || n > CLOCK_TILES) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_clocks, sizeof(unsigned long long) * 8 * n);
  if (rc != cudaSuccess) return (int)rc;
  static unsigned long long zeros[CLOCK_TILES][8];
  return (int)cudaMemcpyToSymbol(g_clocks, zeros, sizeof(zeros));
}
#endif
