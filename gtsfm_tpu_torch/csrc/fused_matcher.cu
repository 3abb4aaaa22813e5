// Fused mutual-NN descriptor matcher for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gtsfm_tpu/frontend/matchers/pallas_matcher.py
// (_matcher_kernel). It computes, batched over pairs, what
// mutual_nn.match_descriptors(..., ratio_test=True, use_bf16=True) computes,
// without ever writing the (K1, K2) similarity matrix to device memory:
//
//   grid (ceil(K1 / 64), P), 256 threads. A block owns a 64-row tile of
//   desc1 (bf16, shared memory) and walks the 64-row tiles of desc2 in
//   order. For each 64x64 tile it forms the float32 similarity (products of
//   bf16 values summed with FMAs), applies the masks exactly as
//   mutual_nn.py does (where(m1 & m2, s, -1e9)), and updates
//     - per row: best, second best (all columns but the argmax one) and the
//       first-index argmax, in registers;
//     - per column: the tile's best value and its first (global) row index,
//       written to a (P, ceil(K1/64), K2) buffer.
//   The wrapper (fused_matcher.py) reduces the column buffer across row
//   tiles (first index on ties), then applies the mutual check and the
//   ratio test. No float atomics: the result is deterministic.
//
// Any K1, K2 >= 1 (ragged tiles are masked); D % 8 == 0.
//
// Returns a cudaError_t as int: the launch error, or cudaErrorInvalidValue
// for arguments the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TILE 64
#define NTHREADS 256
#define MASKED_SIM -1e9f

__global__ void __launch_bounds__(NTHREADS)
fused_matcher_kernel(const __nv_bfloat16* __restrict__ d1,
                     const __nv_bfloat16* __restrict__ d2,
                     const uint8_t* __restrict__ m1,
                     const uint8_t* __restrict__ m2,
                     int K1, int K2, int D,
                     float* __restrict__ best_out,
                     float* __restrict__ second_out,
                     int* __restrict__ bidx_out,
                     float* __restrict__ colbest,
                     int* __restrict__ colidx) {
  extern __shared__ __align__(16) unsigned char smem[];
  // rows padded by one bf16 pair: a warp reading one k of 16 different rows
  // then hits 16 different banks
  const int Dp = D + 2;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + TILE * Dp;
  float* sS = reinterpret_cast<float*>(sB + TILE * Dp);  // TILE x (TILE + 1)
  uint8_t* sM1 = reinterpret_cast<uint8_t*>(sS + TILE * (TILE + 1));
  uint8_t* sM2 = sM1 + TILE;

  const int p = blockIdx.y;
  const int rt = blockIdx.x;
  const int nrt = gridDim.x;
  const int r0 = rt * TILE;
  const int rows = min(TILE, K1 - r0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int half = D >> 1;  // bf16 pairs per descriptor

  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  const __nv_bfloat162* g1 =
      reinterpret_cast<const __nv_bfloat162*>(d1 + (size_t)p * K1 * D);
  const __nv_bfloat162* g2 =
      reinterpret_cast<const __nv_bfloat162*>(d2 + (size_t)p * K2 * D);

  for (int i = tid; i < TILE * half; i += NTHREADS) {
    const int r = i / half;
    const int c = i - r * half;
    reinterpret_cast<__nv_bfloat162*>(sA + r * Dp)[c] =
        (r < rows) ? g1[(size_t)(r0 + r) * half + c] : zero2;
  }
  if (tid < TILE) sM1[tid] = (tid < rows) ? m1[(size_t)p * K1 + r0 + tid] : 0;

  // row state, owned by threads 0..TILE-1 (row = tid)
  float rbest = -INFINITY;
  float rsecond = MASKED_SIM;  // the reference's second best is >= -1e9
  int ridx = 0;

  for (int c0 = 0; c0 < K2; c0 += TILE) {
    const int cols = min(TILE, K2 - c0);
    __syncthreads();  // the previous tile's readers are done with sB / sS
    for (int i = tid; i < TILE * half; i += NTHREADS) {
      const int r = i / half;
      const int c = i - r * half;
      reinterpret_cast<__nv_bfloat162*>(sB + r * Dp)[c] =
          (r < cols) ? g2[(size_t)(c0 + r) * half + c] : zero2;
    }
    if (tid < TILE) sM2[tid] = (tid < cols) ? m2[(size_t)p * K2 + c0 + tid] : 0;
    __syncthreads();

    // 4x4 outputs per thread: rows ty + 16 i, columns tx + 16 j
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < half; ++k) {
      float2 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(sA + (ty + 16 * i) * Dp)[k]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(sB + (tx + 16 * j) * Dp)[k]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        sS[r * (TILE + 1) + c] = (sM1[r] && sM2[c]) ? acc[i][j] : MASKED_SIM;
      }
    __syncthreads();

    if (tid < TILE) {
      if (tid < rows) {
        const float* srow = sS + tid * (TILE + 1);
        for (int c = 0; c < cols; ++c) {
          const float v = srow[c];
          if (v > rbest) {
            rsecond = fmaxf(rsecond, rbest);
            rbest = v;
            ridx = c0 + c;
          } else if (v > rsecond) {
            rsecond = v;
          }
        }
      }
    } else if (tid < 2 * TILE) {
      const int c = tid - TILE;
      if (c < cols) {
        float cb = -INFINITY;
        int ci = 0;
        for (int r = 0; r < rows; ++r) {
          const float v = sS[r * (TILE + 1) + c];
          if (v > cb) {
            cb = v;
            ci = r;
          }
        }
        const size_t o = ((size_t)p * nrt + rt) * K2 + c0 + c;
        colbest[o] = cb;
        colidx[o] = r0 + ci;
      }
    }
  }

  if (tid < rows) {
    const size_t o = (size_t)p * K1 + r0 + tid;
    best_out[o] = rbest;
    second_out[o] = rsecond;
    bidx_out[o] = ridx;
  }
}

extern "C" int gtsfm_fused_matcher(const void* d1, const void* d2,
                                   const void* m1, const void* m2,
                                   int P, int K1, int K2, int D,
                                   void* best, void* second, void* bidx,
                                   void* colbest, void* colidx,
                                   void* stream) {
  if (P <= 0 || P > 65535 || K1 <= 0 || K2 <= 0 || D <= 0 || (D % 8) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)TILE * (D + 2) * sizeof(__nv_bfloat16) +
                      (size_t)TILE * (TILE + 1) * sizeof(float) + 2 * TILE;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_matcher_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((K1 + TILE - 1) / TILE, P);
  fused_matcher_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)d1, (const __nv_bfloat16*)d2, (const uint8_t*)m1,
      (const uint8_t*)m2, K1, K2, D, (float*)best, (float*)second, (int*)bidx,
      (float*)colbest, (int*)colidx);
  return (int)cudaGetLastError();
}
