// Masked multi-head attention for Hopper (sm_90a): bf16 in, float32 scores,
// softmax and accumulators, bf16 out.
//
// Replaces the three Pallas TPU kernels of
// gtsfm_tpu/frontend/matchers/pallas_attention.py, which compute one
// function in three layouts:
//   _attn_kernel_2d (merged (K, h*dh) layout, heads as column slices),
//   _attn_kernel    (split (h, K, dh) layout),
//   _cross_kernel   (bidirectional cross attention from one score matrix;
//                    its column softmax of S is a row softmax of S^T, so the
//                    wrapper launches this kernel twice with the images'
//                    roles swapped, as the reference's merged route does).
// q, k, v and o are addressed through pair, row and head strides (in
// elements; the head dimension is contiguous), so every layout launches
// without a copy.
//
// It computes, per (pair, head, query row), what the reference's XLA
// formula (lightglue.py _attend) computes:
//   s = q . k / sqrt(dh)   (float32), s = -1e9 where the key is masked,
//   o = softmax(s) v       (float32 accumulation), o cast to bf16.
// A masked key scores -1e9 and still counts, so a fully masked key set
// gives the mean of v. Keys past Kk on a ragged last tile contribute
// nothing (-inf); query rows past Kq are computed and never written.
//
// What bounds it on an H100: at LightGlue's shape (K = 2048, dh = 64) one
// call is 4*K*K*dh flops per head against 4*K*dh bytes of q, k, v and o,
// about 1000 flops per byte, so it is compute-bound. The XLA formula
// writes the (h, Kq, Kk) float32 score tensor to device memory and reads
// it back several times (mask, softmax, cast, product). This kernel keeps
// each score tile in registers: one block of 4 warps per (pair, head,
// 64-row query tile); each warp owns 16 query rows, keeps their q
// fragments and their output accumulators in registers, and walks the
// key tiles (64 keys each, staged in shared memory, v transposed) with an
// online softmax (running max and sum, FlashAttention-2 style). Both
// products run on the tensor cores with mma.sync m16n8k16 (bf16 operands,
// float32 accumulation); the probabilities are rounded to bf16 for the
// second product, as the reference rounds its softmax to the working
// dtype. Not yet used: wgmma, TMA and a multi-stage copy pipeline.
//
// Shared memory stays under 48 KB for every dh (at most 36 KB at dh 128).
// Returns a cudaError_t as int: the launch error, or cudaErrorInvalidValue
// for arguments the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BQ 64  // query rows per block, 16 per warp
#define BK 64  // keys per tile
#define NWARPS 4
#define NTHREADS (32 * NWARPS)
#define LOG2E 1.4426950408889634f
// the reference's mask fill, -1e9, in the base-2 units the kernel works in
#define MASKED_S2 (-1e9f * LOG2E)

struct Strides {
  long long pair, row, head;
};

struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* mask;  // (P, Kk) row stride mask_pair, or null: all keys valid
  __nv_bfloat16* o;
  Strides sq, sk, sv, so;
  long long mask_pair;
  int Kq, Kk;
  float scale2;  // log2(e) / sqrt(dh)
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                         a3 (g+8, 2t+8..)
//   B (16x8, k x n):      b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C (16x8 float):       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
template <int DH>
__global__ void __launch_bounds__(NTHREADS) fused_attention_kernel(const AttnArgs args) {
  constexpr int KP = DH + 8;  // sK row pitch (bf16): +16 bytes keeps the
  constexpr int VP = BK + 8;  // fragment loads of a warp on 32 banks
  __shared__ __align__(16) __nv_bfloat16 sK[BK * KP];
  __shared__ __align__(16) __nv_bfloat16 sVt[DH * VP];  // v transposed: [d][key]
  __shared__ uint8_t sCode[BK];  // 0 valid, 1 masked (-1e9), 2 past Kk

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int head = blockIdx.y;
  const int pair = blockIdx.z;
  const int row0 = blockIdx.x * BQ + warp * 16;

  const __nv_bfloat16* qb = args.q + pair * args.sq.pair + head * args.sq.head;
  const __nv_bfloat16* kb = args.k + pair * args.sk.pair + head * args.sk.head;
  const __nv_bfloat16* vb = args.v + pair * args.sv.pair + head * args.sv.head;
  const uint8_t* mb = args.mask ? args.mask + pair * args.mask_pair : nullptr;

  // this warp's 16 query rows as A fragments, straight from device memory
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + ((r & 1) ? 8 : 0);
      const int col = kk * 16 + 2 * t + ((r & 2) ? 8 : 0);
      qf[kk][r] = row < args.Kq
                      ? *reinterpret_cast<const uint32_t*>(qb + row * args.sq.row + col)
                      : 0u;
    }

  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g+8, base-2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the sum

  for (int k0 = 0; k0 < args.Kk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with sK / sVt
    for (int i = tid; i < BK * (DH / 2); i += NTHREADS) {
      const int r = i / (DH / 2);
      const int c = 2 * (i - r * (DH / 2));
      const int key = k0 + r;
      uint32_t kw = 0u, vw = 0u;
      if (key < args.Kk) {
        kw = *reinterpret_cast<const uint32_t*>(kb + key * args.sk.row + c);
        vw = *reinterpret_cast<const uint32_t*>(vb + key * args.sv.row + c);
      }
      *reinterpret_cast<uint32_t*>(sK + r * KP + c) = kw;
      const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(&vw);
      sVt[c * VP + r] = v2.x;
      sVt[(c + 1) * VP + r] = v2.y;
    }
    if (tid < BK) {
      const int key = k0 + tid;
      sCode[tid] = key >= args.Kk ? 2 : (mb && !mb[key] ? 1 : 0);
    }
    __syncthreads();

    // s = q k^T for 16 rows x 64 keys: 8 column tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* kr = sK + (n * 8 + g) * KP + kk * 16 + 2 * t;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, running max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int code = sCode[n * 8 + 2 * t + (i & 1)];
        const float x = code == 0 ? s[n][i] * args.scale2 : (code == 1 ? MASKED_S2 : -INFINITY);
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // every tile holds at least one key < Kk, so the new max is finite
      const float m_new = fmaxf(m_run[h], mx[h]);
      corr[h] = exp2f(m_run[h] - m_new);  // 0 on the first tile
      m_run[h] = m_new;
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= corr[i >> 1];

    // p = exp(s - max), summed in float32, rounded to bf16 as A fragments
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = exp2f(s[n][i] - m_run[i >> 1]);
        l_run[i >> 1] += p[i];
      }
      pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);  // row g
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);  // row g+8
    }
    // A fragment order is (a0 row g, a1 row g+8) for keys 0..7 of the
    // 16-key step, then (a2, a3) for keys 8..15: n even gives a0/a1,
    // n odd a2/a3, as packed above.

    // acc += p v: B fragments from the transposed v tile
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const __nv_bfloat16* vr = sVt + (n * 8 + g) * VP + kk * 16 + 2 * t;
        mma_bf16(acc[n], pf[kk], *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / l;  // l >= 1: the row's max term contributes exp2(0)
  }
  __nv_bfloat16* ob = args.o + pair * args.so.pair + head * args.so.head;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row < args.Kq) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(ob + row * args.so.row + n * 8 + 2 * t) =
            pack_bf16(acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
    }
  }
}

template <int DH>
static cudaError_t launch(const AttnArgs& a, int P, int H, cudaStream_t stream) {
  const dim3 grid((a.Kq + BQ - 1) / BQ, H, P);
  fused_attention_kernel<DH><<<grid, NTHREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// strides: 13 int64 in elements: q (pair, row, head), k (...), v (...),
// o (...), then the mask's pair stride.
extern "C" int gtsfm_fused_attention(const void* q, const void* k, const void* v,
                                     const void* mask, void* o,
                                     const long long* strides, int P, int H,
                                     int Kq, int Kk, int dh, void* stream) {
  if (P <= 0 || P > 65535 || H <= 0 || H > 65535 || Kq <= 0 || Kk <= 0)
    return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.mask = (const uint8_t*)mask;
  a.o = (__nv_bfloat16*)o;
  Strides* s[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i) {
    s[i]->pair = strides[3 * i];
    s[i]->row = strides[3 * i + 1];
    s[i]->head = strides[3 * i + 2];
  }
  a.mask_pair = strides[12];
  a.Kq = Kq;
  a.Kk = Kk;
  a.scale2 = LOG2E / sqrtf((float)dh);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: return (int)launch<16>(a, P, H, st);
    case 32: return (int)launch<32>(a, P, H, st);
    case 64: return (int)launch<64>(a, P, H, st);
    case 128: return (int)launch<128>(a, P, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
