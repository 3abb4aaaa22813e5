// Fused mutual-NN descriptor matcher for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel gtsfm_tpu/frontend/matchers/pallas_matcher.py
// (_matcher_kernel) and the XLA that follows it in pallas_match_descriptors.
// It computes, batched over pairs, what mutual_nn.match_descriptors(...,
// ratio_test=True, use_bf16=True) computes, without ever writing the
// (K1, K2) similarity matrix anywhere:
//   s = bf16(d1) . bf16(d2) summed in float32, s = -1e9 where m1 & m2 is false;
//   per row: best, second best (every column but the first-index argmax
//   one, so a duplicate of the best is the second) and that argmax;
//   per column and row tile: the best value and its lowest row, into a
//   (P, ceil(K1 / 128), K2) buffer;
// then, in a second kernel launched by the same call, the column buffer's
// argmax across row tiles (the first on ties), the mutual check and the
// ratio test (fused_matcher._finish is its plain version). Each kernel
// also has a C entry of its own, for a split of desc1's rows over ranks
// (parallel/sharding.py): the tile kernel on each rank's rows, the finish
// kernel on the gathered buffers.
//
// What bounds it on an H100: at the two-view shape (P = 96, K = 1024,
// D = 128) the products are 25.8 GFLOP of bf16 (0.026 ms at 989 TFLOP/s)
// against 101 MB of float32 descriptors (0.030 ms at 3.35 TB/s), and every
// one of the 100.7 M similarities also feeds a row top-2 and a column
// argmax. So it is bound by the tensor cores and by the instructions that
// reduce their output, not by device memory.
//
// The design:
//   - grid (ceil(K1 / 128), P), 4 warps. A block owns 128 rows of desc1;
//     each warp 32 of them, as four n8 tiles. 3 blocks (12 warps) per SM:
//     at D <= 128 the registers (at most 168 a thread) and 72 KB of shared
//     memory per block both allow 3.
//   - The product is taken transposed, S^T = d2 d1^T: a desc2 tile is the
//     m16 "row" operand (ldmatrix, as it lies) and desc1's rows are the n8
//     "col" operand. So a thread's accumulators hold 2 columns of S (g and
//     g + 8 of an m16 tile) by 8 rows of S (2t, 2t + 1 of each n8 tile):
//     a column's 32 rows in the warp lie in 4 lanes (one quad), and a
//     row's columns across 8 lanes, reduced once at the end of the walk.
//   - D <= 128: each warp loads its rows' fragments once with ldmatrix and
//     keeps them in registers for the whole walk (64 registers at D = 128).
//     D is zero-padded in shared memory to 16 * KS, KS in {1, 2, 4, 8} k16
//     steps. D > 128 (up to MAX_D = 576): the desc1 tile stays in shared
//     memory and its fragments are reloaded per k step.
//   - desc2 is walked in tiles of BN rows (64; 32 above D = 128), staged
//     in bf16 with 16-byte cp.async, double-buffered: tile j + 1 is in
//     flight while tile j multiplies. Rows are padded by 16 bytes, so the
//     8 rows an ldmatrix phase reads fall on 8 different bank quads. Rows
//     past K2 are zero-filled by cp.async and count as masked.
//   - products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. A
//     bf16 x bf16 product is exact in float32, so only the order of the
//     float32 sums differs from the plain version.
//   - masks: a masked row (and a row past K1) is zero-filled in shared
//     memory and its accumulators start at -1e9 instead of 0 (the C
//     operand of the first mma), so its similarities are -1e9 exactly at
//     no cost per element; a masked column is one select per element.
//     Rows past K1 are the tile's last rows and columns past K2 its last
//     columns, so at a tie of -1e9 the lowest (valid) index still wins.
//   - reductions on the accumulator fragments, never through shared
//     memory: a thread keeps (best, second, argmax) for each of its 8 rows
//     over its own columns, in column order, across all tiles, and merges
//     with the 7 other lanes that share the rows once at the end (lower
//     index on equal bests, the loser's best into the second). Per column:
//     the max over the thread's 8 rows and then over the quad (2 shuffles),
//     then the lowest row that holds it (a min over the quad); the 4
//     warps' (value, row) pairs meet in a small shared array, reduced in
//     warp order by BN threads after the next tile's barrier and written
//     once per column tile. No atomics: two calls are bitwise equal.
//
// Any K1, K2 >= 1; D % 8 == 0, D <= MAX_D; P <= 65535.
//
// Returns a cudaError_t as int: the launch error, or cudaErrorInvalidValue
// for arguments the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ROWS 128  // desc1 rows per block (the wrapper's TILE)
#define NWARPS 4  // 32 rows per warp: four n8 tiles
#define NTHREADS (32 * NWARPS)
#define MCH 2  // m16 tiles (16 desc2 rows) per accumulator chunk
#define MAX_D 576  // a multiple of 16: 226,496 bytes of shared memory
#define MASKED_SIM -1e9f
#define FINISH_THREADS 256

static_assert(NTHREADS == ROWS, "one thread per row stages the row mask");

struct MatcherArgs {
  const __nv_bfloat16* d1;
  const __nv_bfloat16* d2;
  const uint8_t* m1;
  const uint8_t* m2;
  int K1, K2, D, Dpad;
  int row0;  // desc1's first row in the whole desc1: added to colidx
  float* best;
  float* second;
  int* bidx;
  float* colbest;
  int* colidx;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d = a b + c. Fragments (g = lane / 4, t = lane % 4):
//   A (16x16, row major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                         a3 (g+8, 2t+8..)
//   B (16x8, k x n):      b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C, D (16x8 float):    c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1,
                                         const float* c) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// The B fragments of 16 desc1 rows (two n8 tiles) at one k16 step: row
// (lane & 7) of tile (lane >> 4), k half ((lane >> 3) & 1).
__device__ __forceinline__ void load_b(uint32_t (*b)[2], const __nv_bfloat16* p) {
  uint32_t r[4];
  ldsm_x4(r, p);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// Issues the 16-byte copies of rows [0, nrows) of a (rows x D) bf16 block
// at src into shared memory of pitch Dp; row r reads src row r when ok(r),
// else it is zero-filled. (r, c) walks the row's D / 8 chunks with a
// stride of NTHREADS chunks, (dr, dc) = divmod(NTHREADS, D / 8).
template <typename Ok>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int nrows,
                                           int D, int Dp, int r, int c, int dr, int dc, int cpr,
                                           Ok ok) {
  while (r < nrows) {
    const bool v = ok(r);
    cp_async16(dst + r * Dp + 8 * c, v ? src + (size_t)r * D + 8 * c : src, v ? 16 : 0);
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// KS k16 steps with desc1's fragments in registers (D <= 16 KS); KS = 0:
// fragments reloaded from shared memory, Dpad / 16 steps.
template <int KS>
__global__ void __launch_bounds__(NTHREADS, 3) fused_matcher_kernel(const MatcherArgs args) {
  constexpr int BN = KS > 0 ? 64 : 32;  // desc2 rows per tile
  constexpr int MT = BN / 16;           // m16 tiles per desc2 tile
  static_assert(MT % MCH == 0, "whole chunks per tile");
  extern __shared__ __align__(16) unsigned char smem[];
  const int K1 = args.K1, K2 = args.K2, D = args.D;
  const int Dpad = KS > 0 ? 16 * KS : args.Dpad;
  const int Dp = Dpad + 8;  // +16 bytes: ldmatrix phases on distinct bank quads
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // desc1: ROWS x Dp
  __nv_bfloat16* sB = sA + ROWS * Dp;                            // desc2: 2 x BN x Dp
  float* sColV = reinterpret_cast<float*>(sB + 2 * BN * Dp);     // 2 x NWARPS x BN
  int* sColI = reinterpret_cast<int*>(sColV + 2 * NWARPS * BN);  // 2 x NWARPS x BN
  uint8_t* sM2 = reinterpret_cast<uint8_t*>(sColI + 2 * NWARPS * BN);  // 2 x BN
  uint8_t* sRowOk = sM2 + 2 * BN;                                       // ROWS

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int p = blockIdx.y;
  const int rt = blockIdx.x;
  const int r0 = rt * ROWS;
  const __nv_bfloat16* g1 = args.d1 + ((size_t)p * K1 + r0) * D;
  const __nv_bfloat16* g2 = args.d2 + (size_t)p * K2 * D;
  const uint8_t* gm2 = args.m2 + (size_t)p * K2;

  // rows past K1 count as masked
  sRowOk[tid] = (r0 + tid < K1) && args.m1[(size_t)p * K1 + r0 + tid];
  // zero the padding columns [D, Dpad) of sA and both sB buffers once:
  // cp.async never writes them
  const int pad = (Dpad - D) >> 3;
  for (int i = tid; i < (ROWS + 2 * BN) * pad; i += NTHREADS) {
    const int r = i / pad;
    *reinterpret_cast<uint4*>(sA + r * Dp + D + 8 * (i - r * pad)) = make_uint4(0u, 0u, 0u, 0u);
  }
  const int cpr = D >> 3;  // 16-byte chunks per row
  const int cr = tid / cpr, cc = tid - cr * cpr, dr = NTHREADS / cpr, dc = NTHREADS - dr * cpr;
  __syncthreads();  // sRowOk

  stage_rows(sA, g1, ROWS, D, Dp, cr, cc, dr, dc, cpr, [&](int r) { return sRowOk[r] != 0; });
  stage_rows(sB, g2, BN, D, Dp, cr, cc, dr, dc, cpr, [&](int r) { return r < K2; });
  cp_async_commit();
  if (tid < BN) sM2[tid] = tid < K2 ? gm2[tid] : 0;

  // this thread's rows: warp * 32 + 8 nt + 2t + j, state index q = 2 nt + j
  float best[8], second[8];
  int bidx[8];
  // the C operand of the first mma per n8 tile: 0, or -1e9 for a masked row
  float cinit[4][4];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    best[q] = -INFINITY;
    second[q] = MASKED_SIM;  // the plain version's second best is >= -1e9
    bidx[q] = 0;
    const float f = sRowOk[warp * 32 + 8 * (q >> 1) + 2 * t + (q & 1)] ? 0.f : MASKED_SIM;
    cinit[q >> 1][q & 1] = f;
    cinit[q >> 1][2 + (q & 1)] = f;
  }

  cp_async_wait_all();
  __syncthreads();  // sA, tile 0 and its mask

  // ldmatrix addresses: desc1 (B) rows (lane & 7) of n8 tile (lane >> 4),
  // k halves ((lane >> 3) & 1); desc2 (A) rows (lane & 15), k halves
  // (lane >> 4)
  const __nv_bfloat16* bBase =
      sA + (warp * 32 + (lane & 7) + ((lane >> 4) << 3)) * Dp + (((lane >> 3) & 1) << 3);
  const int aOff = (lane & 15) * Dp + ((lane >> 4) << 3);
  uint32_t bf[KS > 0 ? KS : 1][4][2];
  if constexpr (KS > 0) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      load_b(bf[ks], bBase + ks * 16);
      load_b(bf[ks] + 2, bBase + 16 * Dp + ks * 16);
    }
  }

  const size_t colBase = ((size_t)p * gridDim.x + rt) * K2;
  // the 4 warps' (value, row) of each column of a tile, in warp order:
  // the lowest row on ties
  auto merge_columns = [&](int buf, int c0) {
    const int c = c0 + tid;
    if (tid < BN && c < K2) {
      const float* v = sColV + buf * NWARPS * BN + tid;
      const int* r = sColI + buf * NWARPS * BN + tid;
      float bv = v[0];
      int br = r[0];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w)
        if (v[w * BN] > bv) {
          bv = v[w * BN];
          br = r[w * BN];
        }
      args.colbest[colBase + c] = bv;
      args.colidx[colBase + c] = args.row0 + r0 + br;
    }
  };

  const int ntiles = (K2 + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    const int c0 = j * BN;
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();  // tile j landed; every warp is done with tile j - 1
      merge_columns(buf ^ 1, c0 - BN);
    }
    uint8_t nextMask = 0;
    if (j + 1 < ntiles) {
      const int n0 = c0 + BN;
      stage_rows(sB + (buf ^ 1) * BN * Dp, g2 + (size_t)n0 * D, BN, D, Dp, cr, cc, dr, dc, cpr,
                 [&](int r) { return n0 + r < K2; });
      cp_async_commit();
      if (tid < BN && n0 + tid < K2) nextMask = gm2[n0 + tid];
    }

    const __nv_bfloat16* tA = sB + buf * BN * Dp + aOff;
    const uint8_t* tM = sM2 + buf * BN;
    float* tV = sColV + (buf * NWARPS + warp) * BN;
    int* tI = sColI + (buf * NWARPS + warp) * BN;
#pragma unroll
    for (int mc = 0; mc < MT; mc += MCH) {
      float acc[MCH][4][4];  // [m16 tile][n8 tile][fragment]
      if constexpr (KS > 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int mi = 0; mi < MCH; ++mi) {
            uint32_t a[4];
            ldsm_x4(a, tA + (mc + mi) * 16 * Dp + ks * 16);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[mi][nt], a, bf[ks][nt][0], bf[ks][nt][1], ks == 0 ? cinit[nt] : acc[mi][nt]);
          }
      } else {
#pragma unroll
        for (int mi = 0; mi < MCH; ++mi)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mi][nt][i] = cinit[nt][i];
        for (int ks = 0; ks < Dpad / 16; ++ks) {
          uint32_t b[4][2];
          load_b(b, bBase + ks * 16);
          load_b(b + 2, bBase + 16 * Dp + ks * 16);
#pragma unroll
          for (int mi = 0; mi < MCH; ++mi) {
            uint32_t a[4];
            ldsm_x4(a, tA + (mc + mi) * 16 * Dp + ks * 16);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mi][nt], a, b[nt][0], b[nt][1], acc[mi][nt]);
          }
        }
      }

#pragma unroll
      for (int mi = 0; mi < MCH; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cl = (mc + mi) * 16 + 8 * h + g;  // column in the tile
          const bool cm = tM[cl] != 0;
          const int col = c0 + cl;
          // rows 8 (q >> 1) + 2t + (q & 1) of the warp, in row order
          float v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = cm ? acc[mi][q >> 1][2 * h + (q & 1)] : MASKED_SIM;
          // row top-2, in column order: an equal value is a second best
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const bool gt = v[q] > best[q];
            second[q] = fmaxf(second[q], gt ? best[q] : v[q]);
            best[q] = gt ? v[q] : best[q];
            bidx[q] = gt ? col : bidx[q];
          }
          // column best over the warp's 32 rows, then its lowest row
          float m = fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])),
                          fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          int r = 32;  // >= 32 where this lane holds no row at the max
#pragma unroll
          for (int q = 7; q >= 0; --q) r = v[q] == m ? 8 * (q >> 1) + (q & 1) : r;
          r += 2 * t;
          r = min(r, __shfl_xor_sync(0xffffffffu, r, 1));
          r = min(r, __shfl_xor_sync(0xffffffffu, r, 2));
          if (t == 0) {
            tV[cl] = m;
            tI[cl] = warp * 32 + r;
          }
        }
    }
    if (tid < BN) sM2[(buf ^ 1) * BN + tid] = nextMask;
  }
  __syncthreads();
  merge_columns((ntiles - 1) & 1, (ntiles - 1) * BN);

  // merge the row state across the 8 lanes that share the rows (lane bits
  // 2-4): lower column on equal bests, the loser's best into the second
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float b = best[q], s = second[q];
    int i = bidx[q];
#pragma unroll
    for (int off = 4; off <= 16; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, off);
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      const bool take = ob > b || (ob == b && oi < i);
      s = take ? fmaxf(os, b) : fmaxf(s, ob);
      b = take ? ob : b;
      i = take ? oi : i;
    }
    const int row = r0 + warp * 32 + 8 * (q >> 1) + 2 * t + (q & 1);
    if (g == 0 && row < K1) {
      const size_t o = (size_t)p * K1 + row;
      args.best[o] = b;
      args.second[o] = s;
      args.bidx[o] = i;
    }
  }
}

// The column buffer's argmax across row tiles (the first on ties: the
// lowest row), the mutual check and the ratio test, one thread per row;
// the float operations are those of fused_matcher._finish, in its order.
__global__ void __launch_bounds__(FINISH_THREADS) fused_matcher_finish(
    const float* __restrict__ best, const float* __restrict__ second, const int* __restrict__ bidx,
    const float* __restrict__ colbest, const int* __restrict__ colidx,
    const uint8_t* __restrict__ m1, int K1, int K2, int nrt, float ratio2,
    int* __restrict__ match_idx, uint8_t* __restrict__ match_ok) {
  const int i = blockIdx.x * FINISH_THREADS + threadIdx.x;
  const int p = blockIdx.y;
  if (i >= K1) return;
  const size_t o = (size_t)p * K1 + i;
  const int c = bidx[o];
  const float* cb = colbest + (size_t)p * nrt * K2 + c;
  float bv = cb[0];
  int bt = 0;
  for (int r = 1; r < nrt; ++r) {
    const float v = cb[(size_t)r * K2];
    if (v > bv) {
      bv = v;
      bt = r;
    }
  }
  const bool mutual = colidx[((size_t)p * nrt + bt) * K2 + c] == i;
  const float b = best[o];
  const float d2b = fmaxf(__fsub_rn(2.f, __fmul_rn(2.f, b)), 0.f);
  const float d2s = fmaxf(__fsub_rn(2.f, __fmul_rn(2.f, second[o])), 1e-12f);
  const bool ok = m1[o] && mutual && b > -1e8f && d2b < __fmul_rn(ratio2, d2s);
  match_idx[o] = ok ? c : -1;
  match_ok[o] = ok;
}

static size_t smem_bytes(int Dpad, int BN) {
  return ((size_t)ROWS + 2 * BN) * (Dpad + 8) * sizeof(__nv_bfloat16) +
         2 * NWARPS * BN * (sizeof(float) + sizeof(int)) + 2 * BN + ROWS;
}

template <int KS>
static int launch(const MatcherArgs& a, int P, cudaStream_t stream) {
  constexpr int BN = KS > 0 ? 64 : 32;
  // the attributes are set once per device, for the largest D the
  // instantiation takes (a benign race: setting twice is harmless)
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(fused_matcher_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(KS > 0 ? 16 * KS : MAX_D, BN));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fused_matcher_kernel<KS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  const dim3 grid((a.K1 + ROWS - 1) / ROWS, P);
  fused_matcher_kernel<KS>
      <<<grid, NTHREADS, smem_bytes(KS > 0 ? 16 * KS : a.Dpad, BN), stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch_tiles(const MatcherArgs& a, int P, cudaStream_t s) {
  return a.D <= 16 ? launch<1>(a, P, s)
         : a.D <= 32 ? launch<2>(a, P, s)
         : a.D <= 64 ? launch<4>(a, P, s)
         : a.D <= 128 ? launch<8>(a, P, s)
                      : launch<0>(a, P, s);
}

static int launch_finish(const float* best, const float* second, const int* bidx,
                         const float* colbest, const int* colidx, const uint8_t* m1, int P,
                         int K1, int K2, float ratio2, int* match_idx, uint8_t* match_ok,
                         cudaStream_t s) {
  const dim3 grid((K1 + FINISH_THREADS - 1) / FINISH_THREADS, P);
  fused_matcher_finish<<<grid, FINISH_THREADS, 0, s>>>(best, second, bidx, colbest, colidx, m1, K1,
                                                        K2, (K1 + ROWS - 1) / ROWS, ratio2,
                                                        match_idx, match_ok);
  return (int)cudaGetLastError();
}

static bool bad_sizes(int P, int K1, int K2, int D) {
  return P <= 0 || P > 65535 || K1 <= 0 || K2 <= 0 || D <= 0 || (D % 8) != 0 || D > MAX_D;
}

// Launches the tile kernel and then the finish kernel on one stream.
// ratio2 is the ratio test's ratio squared, rounded to float32.
extern "C" int gtsfm_fused_matcher(const void* d1, const void* d2, const void* m1, const void* m2,
                                   int P, int K1, int K2, int D, float ratio2, void* best,
                                   void* second, void* bidx, void* colbest, void* colidx,
                                   void* match_idx, void* match_ok, void* stream) {
  if (bad_sizes(P, K1, K2, D)) return (int)cudaErrorInvalidValue;
  const MatcherArgs a{(const __nv_bfloat16*)d1, (const __nv_bfloat16*)d2, (const uint8_t*)m1,
                      (const uint8_t*)m2, K1, K2, D, (D + 15) & ~15, 0, (float*)best,
                      (float*)second, (int*)bidx, (float*)colbest, (int*)colidx};
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = launch_tiles(a, P, s);
  if (rc != 0) return rc;
  return launch_finish(a.best, a.second, a.bidx, a.colbest, a.colidx, a.m1, P, K1, K2, ratio2,
                       (int*)match_idx, (uint8_t*)match_ok, s);
}

// The tile kernel alone, for a split of desc1's rows over ranks: d1 and m1
// hold the K1 rows row0 .. row0 + K1 of the whole desc1 (row0 a multiple
// of ROWS, so the column buffer's row tiles are those of the whole), and
// colidx gets global rows.
extern "C" int gtsfm_fused_matcher_tiles(const void* d1, const void* d2, const void* m1,
                                         const void* m2, int P, int K1, int K2, int D, int row0,
                                         void* best, void* second, void* bidx, void* colbest,
                                         void* colidx, void* stream) {
  if (bad_sizes(P, K1, K2, D) || row0 < 0 || row0 % ROWS != 0) return (int)cudaErrorInvalidValue;
  const MatcherArgs a{(const __nv_bfloat16*)d1, (const __nv_bfloat16*)d2, (const uint8_t*)m1,
                      (const uint8_t*)m2, K1, K2, D, (D + 15) & ~15, row0, (float*)best,
                      (float*)second, (int*)bidx, (float*)colbest, (int*)colidx};
  return launch_tiles(a, P, (cudaStream_t)stream);
}

// The finish kernel alone, on the tile outputs of all K1 rows (gathered
// from the ranks of a split): the column buffer holds ceil(K1 / ROWS) tiles.
extern "C" int gtsfm_fused_matcher_finish(const void* best, const void* second, const void* bidx,
                                          const void* colbest, const void* colidx, const void* m1,
                                          int P, int K1, int K2, float ratio2, void* match_idx,
                                          void* match_ok, void* stream) {
  if (P <= 0 || P > 65535 || K1 <= 0 || K2 <= 0) return (int)cudaErrorInvalidValue;
  return launch_finish((const float*)best, (const float*)second, (const int*)bidx,
                       (const float*)colbest, (const int*)colidx, (const uint8_t*)m1, P, K1, K2,
                       ratio2, (int*)match_idx, (uint8_t*)match_ok, (cudaStream_t)stream);
}
