// Front-to-back Gaussian splat tile compositing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gtsfm_tpu/splat/rendering.py
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
//   grid (n_tiles), 256 threads: one block per 16x16 tile, one pixel per
//   thread, T and C in registers. The block walks its tile's slots in
//   batches of 256. Each thread loads one slot index and gathers that
//   gaussian's 9 float32 attributes from the (G, 9) table into shared
//   memory (structure of arrays, 9 KB; every thread then reads the same
//   word, a broadcast); after a barrier every thread composites the batch.
//   Before each batch the block stops once every pixel has T <= 1/255
//   (__syncthreads_or), the reference's early-saturation rule per tile: the
//   skipped tail adds at most 1/255 to any output.
//
// What bounds it: about 20 float32 operations and one exp per pixel-slot
// pair against 40 bytes read per slot and 16 written per pixel, so it is
// compute-bound (float32 FMA and SFU rates). Blocks are independent: no
// atomics, the result is deterministic. Slot indices outside [0, G)
// contribute nothing. Only the first `limit` slots of a row are read (the
// plain version's whole-chunk rule, composited_slots in rendering.py).
//
// Returns a cudaError_t as int: the launch error, or cudaErrorInvalidValue
// for arguments the kernel does not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TILE 16
#define NPIX (TILE * TILE)
#define BATCH NPIX
#define NATTR 9
#define T_STOP (1.0f / 255.0f)

__global__ void __launch_bounds__(NPIX)
splat_composite_kernel(const float* __restrict__ packed,
                       const int* __restrict__ gidx,
                       const int* __restrict__ counts,
                       const int* __restrict__ origins,
                       int G, int cap, int limit,
                       float* __restrict__ color,
                       float* __restrict__ T_out) {
  __shared__ float s_attr[NATTR][BATCH];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = min(max(counts[t], 0), limit);
  const float px = (float)(origins[2 * t] + (tid % TILE));
  const float py = (float)(origins[2 * t + 1] + (tid / TILE));
  const int* row = gidx + (size_t)t * cap;

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int s = 0; s < count; s += BATCH) {
    // also the barrier that keeps the last batch's readers off s_attr
    if (!__syncthreads_or(T > T_STOP)) break;
    const int n = min(BATCH, count - s);
    if (tid < n) {
      const int g = row[s + tid];
      if (g >= 0 && g < G) {
        const float* a = packed + (size_t)g * NATTR;
#pragma unroll
        for (int k = 0; k < NATTR; ++k) s_attr[k][tid] = a[k];
      } else {
#pragma unroll
        for (int k = 0; k < NATTR; ++k) s_attr[k][tid] = 0.0f;  // alpha 0
      }
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = px - s_attr[0][j];
      const float dy = py - s_attr[1][j];
      float q = s_attr[6][j] * dx * dx + 2.0f * s_attr[7][j] * dx * dy + s_attr[8][j] * dy * dy;
      q = fmaxf(q, 0.0f);
      float a = fminf(s_attr[2][j] * expf(-0.5f * q), 0.995f);
      a = (q < 16.0f) ? a : 0.0f;
      const float w = a * T;
      cr += w * s_attr[3][j];
      cg += w * s_attr[4][j];
      cb += w * s_attr[5][j];
      T *= 1.0f - a;
    }
  }
  const size_t pix = (size_t)t * NPIX + tid;
  color[3 * pix + 0] = cr;
  color[3 * pix + 1] = cg;
  color[3 * pix + 2] = cb;
  T_out[pix] = T;
}

extern "C" int gtsfm_splat_composite(const float* packed, const int* gidx, const int* counts,
                                     const int* origins, int G, int n_tiles, int cap, int limit,
                                     float* color, float* T, void* stream) {
  if (G <= 0 || n_tiles <= 0 || cap < 0 || limit < 0 || limit > cap) return (int)cudaErrorInvalidValue;
  splat_composite_kernel<<<n_tiles, NPIX, 0, (cudaStream_t)stream>>>(packed, gidx, counts, origins, G, cap,
                                                                      limit, color, T);
  return (int)cudaGetLastError();
}
