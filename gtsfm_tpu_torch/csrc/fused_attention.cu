// Masked multi-head attention for Hopper (sm_90a): TMA-fed key tiles and
// wgmma for both products. bf16 in, float32 scores, softmax and
// accumulators, bf16 out.
//
// Replaces the three Pallas TPU kernels of
// gtsfm_tpu/frontend/matchers/pallas_attention.py, which compute one
// function in three layouts:
//   #2 _attn_kernel_2d (:127, called at :174): merged (K, h*dh) layout,
//   #3 _cross_kernel   (:99, called at :215): bidirectional cross attention
//      from one score matrix; its column softmax of S is a row softmax of
//      S^T, so the wrapper launches this kernel twice with the images'
//      roles swapped, as the reference's merged route does,
//   #4 _attn_kernel    (:29, called at :74): split (h, K, dh) layout.
// q, k, v and o are read and written through 4-D TMA tensor maps over
// (dh, rows, heads, pairs) built from each view's strides, so every layout
// launches without a copy.
//
// Per (pair, head, query row) it computes what the reference's XLA formula
// (lightglue.py _attend) computes:
//   s = q . k / sqrt(dh)   (float32), s = -1e9 where the key is masked,
//   o = softmax(s) v       (float32 accumulation), o cast to bf16;
// the probabilities are rounded to bf16 for the second product and summed
// unrounded in float32 for the normalizer. The kernel works in base 2.
//
// What bounds it on an H100. At LightGlue's shape (K = 2048, dh = 64) a
// call is 4*K*K*dh tensor-core flops per head against 4*K*dh bytes of q, k,
// v and o, about 1000 flops per byte: compute-bound. Each score costs
// 4*dh = 256 tensor flops and one exp2, and the special-function unit
// does 16 exp2 per clock per SM against about 4,096 tensor flops, so at
// dh = 64 the exponentials take as long as both products, and the masking,
// row max and row sum add integer and comparison work (half rate) on top.
// The design keeps the tensor cores, the exp2 unit and the copies busy at
// the same time:
//
// Block: one per (pair, head, 128 query rows), 384 threads in three
// warpgroups. Warpgroups 0 and 1 are consumers, 64 query rows each
// (setmaxnreg 232); warpgroup 2 is the producer (setmaxnreg 40), of which
// one warp works: one lane issues every TMA load, all 32 lanes turn the
// key mask of each tile into per-thread flag bytes in shared memory.
// Pipeline: q is loaded once; key tiles come through a ring of as many
// stages as shared memory holds (6 at dh 64), each holding the k tile, the
// v tile and the tile's mask flags, guarded by mbarriers: full[s] (TMA
// bytes plus 32 producer arrivals) and empty[s] (one arrival per consumer
// warp).
// Products: S = Q K^T is wgmma m64n{BK}k16 with both operands in shared
// memory, K-major. O += P V is wgmma m64n{dh}k16 with P from registers (the
// S accumulator rounded to bf16 A fragments) and V from shared memory as
// the MN-major B operand (transpose flag), so v is never transposed by hand.
// Overlap: step j of a consumer retires P_{j-2} V_{j-2}, issues S_j and
// P_{j-1} V_{j-1}, and runs the softmax of tile j while the latter runs
// (FlashAttention-3's intra-warpgroup pipelining); the two consumers take
// turns to issue their products (named barriers), so one's softmax runs
// under the other's products.
//
// Tiles per DH (a swizzle row is min(dh, 64) columns; a tile of dh = 128 is
// stored as two panels of 64 columns):
//   dh   BK keys  swizzle  q (2 x 64 rows)  k + v per stage  stages  dynamic smem
//   16   128      32 B      4 KB             8 KB            8        72,968 B
//   32   128      64 B      8 KB            16 KB            8       142,600 B
//   64   128      128 B    16 KB            32 KB            6       215,752 B
//   128   64      128 B    32 KB            32 KB            6       232,136 B
// (each stage also holds 272 bytes of mask flags; the totals include the
// barriers and 1 KB of alignment slack); above 48 KB, so the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize once per dh and device.
//
// The mask rules. A masked key scores -1e9 (MASKED_S2 in base 2) and still
// counts, so a fully masked key set gives the mean of v; a key at or past
// Kk contributes nothing. TMA zero-fills the rows of a ragged last tile,
// and a zero-filled key would score 0, so a key is scored only when its
// "valid" flag is set (below Kk and kept by the mask); every other key
// scores -inf in the main path. A masked key's true term, exp2(MASKED_S2 -
// m), is 0 unless no valid key outscores -1e9 by more than about 100 (a
// fully masked key set); only then, detected per tile and warp, the
// consumer adds it from the "masked" flags. Query rows past Kq are loaded
// as zeros and computed; the TMA store clips at the o map's row bound,
// which is Kq for each (pair, head), so they are never written and every
// row below Kq is.
//
// Host side: the tensor maps are encoded with cuTensorMapEncodeTiled,
// fetched through cudaGetDriverEntryPoint(ByVersion), so the library needs
// no -lcuda; they reach the kernel as __grid_constant__ parameters. The C
// function returns 0, a cudaError_t (launch errors, cudaErrorInvalidValue
// for arguments the kernel does not take), or minus the CUresult of a
// failed encode (-1000 when the driver has no encoder).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LOG2E 1.4426950408889634f
// the reference's mask fill, -1e9, in the base-2 units the kernel works in
#define MASKED_S2 (-1e9f * LOG2E)

template <int DH>
struct Cfg {
  static constexpr int NC = 2;                  // consumer warpgroups, 64 query rows each
  static constexpr int QROWS = 64 * NC;         // query rows per block
  static constexpr int THREADS = 128 * (NC + 1);
  // registers per thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 of the
  // SM's 65,536, one block per SM
  static constexpr int REG_P = 40;
  static constexpr int REG_C = 232;
  static constexpr int PW = DH < 64 ? DH : 64;  // panel width, elements
  static constexpr int NP = DH / PW;            // panels per row
  static constexpr int SWZ = PW * 2;            // swizzle span, bytes: 32, 64, 128
  static constexpr int SWZ_MASK = SWZ / 16 - 1; // row bits XORed into the 16-byte chunk
  static constexpr uint64_t LAYOUT = SWZ == 128 ? 1 : (SWZ == 64 ? 2 : 3);  // wgmma B128/B64/B32
  static constexpr int BK = DH <= 64 ? 128 : 64;  // keys per tile
  static constexpr int QH_BYTES = 64 * DH * 2;   // one consumer's 64 query rows
  static constexpr int KV_BYTES = BK * DH * 2;   // one k or v tile
  // mask flags per stage: for each thread column t, BK/4 "valid" bytes at
  // 32 t and BK/4 "masked" bytes at 128 + 32 t; a word at 256 that says
  // whether the tile holds a masked key
  static constexpr int MASK_BYTES = 2 * 4 * 32 + 16;
  // as many stages as the 227 KB of shared memory hold, at most 8
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + MASK_BYTES;
  static constexpr int FIT = (232448 - NC * QH_BYTES - 1024 - 8 * 17) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int OFF_K = NC * QH_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_MASK = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_MASK + STAGES * MASK_BYTES;
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory");
};

struct KernelArgs {
  const uint8_t* mask;  // (P, Kk) row stride mask_pair, or null: all keys valid
  long long mask_pair;
  int Kq, Kk;
  float scale2;  // log2(e) / sqrt(dh)
};

// Where a consumer's pipeline step spends its clocks, in a build with
// -DGTSFM_ATTN_CLOCKS (scripts/attention_limits.py makes one; the library
// the wrapper loads has none). Phases: waiting for the stage and the turn,
// retiring P V, issuing the products, waiting for S, the softmax. Lane 0 of
// each consumer warp adds its sums to g_clocks[warpgroup][phase], and its
// step count to [5]. The clock reads order the code around them, so that
// build runs slower.
#ifdef GTSFM_ATTN_CLOCKS
__device__ unsigned long long g_clocks[2][8];

struct StepClocks {
  long long t[6];
  long long spent[6] = {0, 0, 0, 0, 0, 0};
  __device__ __forceinline__ void mark(int i) { t[i] = clock64(); }
  template <int N>
  __device__ __forceinline__ void end(float* s) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(s[i])::"memory");  // the softmax is done
    t[5] = clock64();
#pragma unroll
    for (int k = 0; k < 5; ++k) spent[k] += t[k + 1] - t[k];
    spent[5] += 1;
  }
  __device__ __forceinline__ void flush(int wg, int lane) {
    if (lane == 0)
      for (int k = 0; k < 6; ++k) atomicAdd(&g_clocks[wg][k], (unsigned long long)spent[k]);
  }
};

extern "C" int gtsfm_attention_clocks(unsigned long long* out, int reset) {
  static const unsigned long long zero[2][8] = {};
  return (int)(reset ? cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero))
                     : cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks)));
}
#else
struct StepClocks {
  __device__ __forceinline__ void mark(int) {}
  template <int N>
  __device__ __forceinline__ void end(float*) {}
  __device__ __forceinline__ void flush(int, int) {}
};
#endif

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// wait until the phase of the given parity has completed; a wait that
// lasts about ten seconds of clock ticks means a broken pipeline, and traps
// (the launch fails) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// named barriers shared by the two consumer warpgroups: one waits, the
// other arrives
__device__ __forceinline__ void named_sync_both(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across this point
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC8(d, i)                                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define REGS16 REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define REGS32                                                                                    \
  REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define REGS64                                                                                    \
  REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
         "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// D (64 x N, float32) (+)= A (64 x 16, shared, K-major) B (16 x N, shared,
// K-major); scale_d 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x N, float32) += A (64 x 16, bf16 registers) B (16 x N, shared,
// MN-major: the transpose flag)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

#define RS_ARGS "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" REGS8 "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0)
      : RS_ARGS);
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" REGS16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8)
      : RS_ARGS);
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : RS_ARGS);
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : RS_ARGS);
}

// ---------------------------------------------------------------------------
// the consumer's steps
// ---------------------------------------------------------------------------
// S (64 x BK) = Q (64 rows at sq) K^T (BK keys at sk): one wgmma per 16 of dh.
// A k-step inside a swizzled panel advances the start address by 32 bytes;
// the hardware applies the swizzle to the computed addresses.
template <int DH>
__device__ __forceinline__ void issue_scores(float* s, uint32_t sq, uint32_t sk) {
  using C = Cfg<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t col = (kk * 16) % C::PW * 2;
    const uint32_t panel = kk * 16 / C::PW;
    const uint64_t a = make_desc(sq + panel * 64 * C::SWZ + col, 16, 8 * C::SWZ, C::LAYOUT);
    const uint64_t b = make_desc(sk + panel * C::BK * C::SWZ + col, 16, 8 * C::SWZ, C::LAYOUT);
    wgmma_ss<C::BK>(s, a, b, kk > 0);
  }
}

// O (64 x DH) += P (64 x BK, registers) V (BK keys at sv): one wgmma per 16
// keys. V is MN-major: 8-key groups SBO apart, 64-column panels LBO apart.
template <int DH>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*p)[4], uint32_t sv) {
  using C = Cfg<DH>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    wgmma_rs<DH>(o, p[kk], make_desc(sv + kk * 16 * C::SWZ, C::BK * C::SWZ, 8 * C::SWZ, C::LAYOUT));
}

// Per-key flags of one tile, as this thread sees them: byte 2j+e of its
// 32-byte column is 0xFF when key 8j+2t+e is so flagged, else 0.
struct TileMask {
  uint32_t valid[8];  // keys below Kk that the mask keeps
  uint32_t any_masked;  // the tile holds a key below Kk that the mask drops
};

template <int BK>
__device__ __forceinline__ void load_mask(TileMask& tm, const uint8_t* mk, int t) {
#pragma unroll
  for (int i = 0; i < BK / 64; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(mk + 32 * t)[i];
    tm.valid[4 * i + 0] = u.x;
    tm.valid[4 * i + 1] = u.y;
    tm.valid[4 * i + 2] = u.z;
    tm.valid[4 * i + 3] = u.w;
  }
  tm.any_masked = *reinterpret_cast<const uint32_t*>(mk + 256);
}

// all ones where byte b of w is 0xFF, else 0 (prmt's sign replication)
__device__ __forceinline__ uint32_t byte_mask(uint32_t w, int b) {
  uint32_t d;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(d) : "r"(w), "r"((8 | b) * 0x1111));
  return d;
}

// Score, mask and exponentiate one tile in place. s is the wgmma
// accumulator of raw q.k: for column group j (8 keys), s[4j], s[4j+1] are
// row g, keys 8j+2t, 8j+2t+1; s[4j+2], s[4j+3] row g+8. Updates the
// running max m and this thread's share of the sum l (float32, unrounded)
// and returns the factor that rescales earlier tiles in corr.
//
// A valid key scores s * scale2 and a key past Kk -inf. A masked key
// scores MASKED_S2 and adds pm = exp2(MASKED_S2 - m) to its row: that term
// is 0 unless no valid key outscores -1e9 by more than about 100, as in a
// fully masked key set, so it is added only when some row of the warp has
// pm > 0.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* s, const TileMask& tm, const uint8_t* mk, int t, float scale2,
                                             float* m, float* l, float* corr) {
  float part[2][4];  // four partial maxima (then sums) per row keep the chains short
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) part[h][q] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t keep = byte_mask(tm.valid[j >> 1], 2 * (j & 1) + e);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = s[4 * j + 2 * h + e];
        x = __int_as_float((__float_as_int(x) & keep) | (~keep & 0xff800000u));  // -inf unless valid
        part[h][j & 3] = fmaxf(part[h][j & 3], x);
      }
    }
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(fmaxf(part[h][0], part[h][1]), fmaxf(part[h][2], part[h][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // scaling is monotonic, so mx * scale2 is the max of the scaled scores;
    // every tile holds a key below Kk, valid or masked, so m ends finite
    const float m_new = fmaxf(m[h], fmaxf(mx * scale2, tm.any_masked ? MASKED_S2 : -INFINITY));
    corr[h] = ex2(m[h] - m_new);  // 0 on the first tile
    m[h] = m_new;
    neg_m[h] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = ex2(fmaf(s[i], scale2, neg_m[(i >> 1) & 1]));
  if (tm.any_masked) {
    const float pm[2] = {ex2(MASKED_S2 - m[0]), ex2(MASKED_S2 - m[1])};
    if (__any_sync(0xffffffffu, pm[0] > 0.f || pm[1] > 0.f)) {
      uint32_t dropped[BK / 16];
#pragma unroll
      for (int i = 0; i < BK / 64; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(mk + 128 + 32 * t)[i];
        dropped[4 * i + 0] = u.x;
        dropped[4 * i + 1] = u.y;
        dropped[4 * i + 2] = u.z;
        dropped[4 * i + 3] = u.w;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t drop = byte_mask(dropped[j >> 1], 2 * (j & 1) + e);
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // a masked key's term is 0 so far
            float& x = s[4 * j + 2 * h + e];
            x = __int_as_float(__float_as_int(x) | (drop & __float_as_int(pm[h])));
          }
        }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) part[h][q] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) part[(i >> 1) & 1][(i >> 2) & 3] += s[i];
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ((part[h][0] + part[h][1]) + (part[h][2] + part[h][3]));
}

// The probabilities rounded to bf16 as A fragments: the 16-key step kk
// takes column groups 2kk (registers 0: row g, 1: row g+8) and 2kk+1
// (registers 2 and 3).
template <int BK>
__device__ __forceinline__ void to_fragments(const float* s, uint32_t (*p)[4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    p[j >> 1][(j & 1) * 2 + 0] = pack_bf16(s[4 * j + 0], s[4 * j + 1]);
    p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// One consumer warpgroup's pipeline over the key tiles. Step j waits for
// O += P_{j-2} V_{j-2} (issued one step earlier) and frees its stage,
// rescales O and forms P_{j-1} from the scores of tile j-1, issues
// S_j = Q K_j^T and O += P_{j-1} V_{j-1}, and runs the softmax of tile j
// once S_j has landed, while the P V product runs. No wait follows the
// softmax within the step, so the compiler cannot sink the softmax below
// one. Every register a wgmma reads or writes is written by other
// instructions only before its wgmma.fence or after the wait that retires
// it; otherwise ptxas serializes the products.
template <int DH>
struct Consumer {
  using C = Cfg<DH>;
  uint32_t base;
  const uint8_t* mask_base;
  uint32_t sq, bar_full, bar_empty;
  int n_tiles, wg, lane, t;
  float scale2;
  StepClocks clk;

  // wait for the P V product in flight, free its stage (tile j), rescale O
  // and form the A fragments of the probabilities in s
  __device__ __forceinline__ void retire_pv(int j, float* s, float* o, uint32_t (*p)[4], const float* corr) {
    wgmma_wait<0>();
    fence_regs<DH / 2>(o);
    fence_regs<C::BK / 4>(&p[0][0]);
    if (j >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * (j % C::STAGES));
    }
    // O holds the tiles before j+1 under the max before tile j+1: bring it
    // to the max after
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    to_fragments<C::BK>(s, p);
    fence_regs<DH / 2>(o);
    fence_regs<C::BK / 4>(&p[0][0]);
  }

  __device__ __forceinline__ void step(int j, float* s, float* o, uint32_t (*p)[4], TileMask& tm, float* m,
                                       float* l, float* corr) {
    const int st = j % C::STAGES;
    clk.mark(0);
    mbar_wait(bar_full + 8 * st, (j / C::STAGES) & 1);
    named_sync_both(8 + wg);
    clk.mark(1);
    retire_pv(j - 2, s, o, p, corr);
    clk.mark(2);
    fence_regs<C::BK / 2>(s);
    wgmma_fence();
    issue_scores<DH>(s, sq, base + C::OFF_K + st * C::KV_BYTES);
    wgmma_commit();
    issue_pv<DH>(o, p, base + C::OFF_V + ((j - 1) % C::STAGES) * C::KV_BYTES);
    wgmma_commit();
    if (wg < C::NC - 1 || j < n_tiles - 1) named_arrive(8 + (wg + 1) % C::NC);
    load_mask<C::BK>(tm, mask_base + st * C::MASK_BYTES, t);
    clk.mark(3);
    wgmma_wait<1>();  // the scores of tile j; P V of tile j-1 still runs
    fence_regs<C::BK / 2>(s);
    clk.mark(4);
    softmax_tile<C::BK>(s, tm, mask_base + st * C::MASK_BYTES, t, scale2, m, l, corr);
    clk.end<C::BK / 2>(s);
  }
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::THREADS, 1)
    fused_attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                           const KernelArgs args) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on a 1024-byte boundary, the period of the swizzle
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_full = base + C::OFF_BAR;              // STAGES barriers
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;      // STAGES barriers
  const uint32_t bar_q = bar_empty + 8 * C::STAGES;
  const int q0 = blockIdx.x * C::QROWS;
  const int head = blockIdx.y;
  const int pair = blockIdx.z;
  const int n_tiles = (args.Kk + C::BK - 1) / C::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes (+ TMA bytes)
      mbar_init(bar_empty + 8 * s, 4 * C::NC);  // one per consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * C::NC) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::REG_P));
    if (threadIdx.x >= 128 * C::NC + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(bar_q, C::NC * C::QH_BYTES);
      for (int w = 0; w < C::NC; ++w)
        for (int pn = 0; pn < C::NP; ++pn)
          tma_load(base + w * C::QH_BYTES + pn * 64 * C::SWZ, &tq, bar_q, pn * C::PW, q0 + 64 * w, head, pair);
    }
    // each lane handles keys lane + 32 r of a tile; the mask bytes of tile
    // j+1 are loaded while the warp waits for tile j's stage
    constexpr int R = C::BK / 32;
    const uint8_t* mrow = args.mask ? args.mask + pair * args.mask_pair : nullptr;
    uint32_t ahead[R];
    auto fetch = [&](int j) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int key = j * C::BK + lane + 32 * r;
        ahead[r] = (mrow && key < args.Kk) ? __ldg(mrow + key) : 1u;
      }
    };
    fetch(0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % C::STAGES;
      uint32_t valid[R];
#pragma unroll
      for (int r = 0; r < R; ++r) valid[r] = ahead[r];
      if (j + 1 < n_tiles) fetch(j + 1);
      if (j >= C::STAGES) mbar_wait(bar_empty + 8 * st, ((j / C::STAGES) - 1) & 1);
      uint8_t* mk = sm + C::OFF_MASK + st * C::MASK_BYTES;
      bool masked = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * r;  // key i of the tile: column group i/8, thread column (i%8)/2
        const int key = j * C::BK + i;
        const int at = 32 * ((i & 7) >> 1) + 2 * (i >> 3) + (i & 1);
        mk[at] = key < args.Kk && valid[r] ? 0xFF : 0;
        mk[128 + at] = key < args.Kk && !valid[r] ? 0xFF : 0;
        masked |= key < args.Kk && !valid[r];
      }
      masked = __any_sync(0xffffffffu, masked);
      if (lane == 0) *reinterpret_cast<uint32_t*>(mk + 256) = masked;
      __syncwarp();
      if (lane == 0) {
        const uint32_t bar = bar_full + 8 * st;
        mbar_expect_tx(bar, 2 * C::KV_BYTES);
        for (int pn = 0; pn < C::NP; ++pn) {
          tma_load(base + C::OFF_K + st * C::KV_BYTES + pn * C::BK * C::SWZ, &tk, bar, pn * C::PW, j * C::BK,
                   head, pair);
          tma_load(base + C::OFF_V + st * C::KV_BYTES + pn * C::BK * C::SWZ, &tv, bar, pn * C::PW, j * C::BK,
                   head, pair);
        }
      } else {
        mbar_arrive(bar_full + 8 * st);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::REG_C));
    // broadcast from lane 0, so the compiler sees it as warp-uniform and
    // keeps the wgmma descriptors built from it in uniform registers
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t sq = base + wg * C::QH_BYTES;
    const uint8_t* mask_base = sm + C::OFF_MASK;
    TileMask tm;

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float s[C::BK / 2];
    uint32_t p[C::BK / 16][4];
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of rows g, g+8
    float corr[2];
    Consumer<DH> cs{base, mask_base, sq, bar_full, bar_empty, n_tiles, wg, lane, t, args.scale2};

    mbar_wait(bar_q, 0);
    mbar_wait(bar_full, 0);
    wgmma_fence();
    issue_scores<DH>(s, sq, base + C::OFF_K);
    wgmma_commit();
    load_mask<C::BK>(tm, mask_base, t);
    wgmma_wait<0>();
    fence_regs<C::BK / 2>(s);
    softmax_tile<C::BK>(s, tm, mask_base, t, args.scale2, m, l, corr);

    // The two consumers take turns to issue their products (named barriers
    // 8 and 9), so one's softmax runs while the other's products do.
    // Consumer 1 lets consumer 0 go first and skips its last hand-over.
    if (wg == C::NC - 1 && n_tiles > 1) named_arrive(8);
    for (int j = 1; j < n_tiles; ++j) cs.step(j, s, o, p, tm, m, l, corr);
    cs.clk.flush(wg, lane);
    fence_regs<C::BK / 2>(s);
    cs.retire_pv(n_tiles - 2, s, o, p, corr);
    wgmma_fence();
    issue_pv<DH>(o, p, base + C::OFF_V + ((n_tiles - 1) % C::STAGES) * C::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DH / 2>(o);

    // epilogue: O / l as bf16 into this warpgroup's (now free) q tile, in
    // the map's swizzled layout, then one TMA store clipped at Kq
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = l[h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      inv[h] = 1.f / x;  // >= 1: the row's max term contributes exp2(0)
    }
    named_sync(1 + wg);  // every warp's last product has read q
    uint8_t* so = sm + wg * C::QH_BYTES;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g + 8 * h;
        const int col = 8 * j + 2 * t;
        uint32_t off = (col / C::PW) * 64 * C::SWZ + row * C::SWZ + (col % C::PW) * 2;
        off ^= ((off >> 7) & C::SWZ_MASK) << 4;
        *reinterpret_cast<uint32_t*>(so + off) = pack_bf16(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
      }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + wg);
    if ((threadIdx.x & 127) == 0 && q0 + 64 * wg < args.Kq) {
      for (int pn2 = 0; pn2 < C::NP; ++pn2)
        tma_store(&to, sq + pn2 * 64 * C::SWZ, pn2 * C::PW, q0 + 64 * wg, head, pair);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// One map from the wrapper's layout: dims (dh, rows, heads, pairs), byte
// strides of rows, heads, pairs, box (columns, rows). Returns 0 or the
// CUresult.
static int encode(CUtensorMap* map, const void* ptr, const long long* lay, int swz) {
  const cuuint64_t dims[4] = {(cuuint64_t)lay[0], (cuuint64_t)lay[1], (cuuint64_t)lay[2], (cuuint64_t)lay[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)lay[4], (cuuint64_t)lay[5], (cuuint64_t)lay[6]};
  const cuuint32_t box[4] = {(cuuint32_t)lay[7], (cuuint32_t)lay[8], 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle mode =
      swz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : (swz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  return (int)encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, mode, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
static int launch(const void* const* ptrs, const long long* layout, const KernelArgs& a, int P, int H,
                  cudaStream_t stream) {
  using C = Cfg<DH>;
  // the wrapper's boxes must be the tiles this dh was compiled for
  const long long rows[4] = {64, C::BK, C::BK, 64};  // q, k, v, o
  for (int i = 0; i < 4; ++i)
    if (layout[9 * i + 7] != C::PW || layout[9 * i + 8] != rows[i]) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const int rc = encode(&maps[i], ptrs[i], layout + 9 * i, C::SWZ);
    if (rc != 0) return -rc;
  }
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(fused_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  const dim3 grid((a.Kq + C::QROWS - 1) / C::QROWS, H, P);
  fused_attention_kernel<DH><<<grid, C::THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

// layout: 37 int64: for q, k, v, o in turn, the map's dims (dh, rows,
// heads, pairs), byte strides (rows, heads, pairs) and box (columns, rows);
// then the mask's pair stride in elements.
extern "C" int gtsfm_fused_attention(const void* q, const void* k, const void* v, const void* mask, void* o,
                                     const long long* layout, int P, int H, int Kq, int Kk, int dh,
                                     void* stream) {
  if (P <= 0 || P > 65535 || H <= 0 || H > 65535 || Kq <= 0 || Kk <= 0) return (int)cudaErrorInvalidValue;
  const long long want[4][4] = {{dh, Kq, H, P}, {dh, Kk, H, P}, {dh, Kk, H, P}, {dh, Kq, H, P}};
  for (int i = 0; i < 4; ++i)
    for (int d = 0; d < 4; ++d)
      if (layout[9 * i + d] != want[i][d]) return (int)cudaErrorInvalidValue;
  if (!encoder()) return -1000;
  // the encoder needs the device's context current on this thread, which the
  // runtime binds at its first call here
  static thread_local bool bound = false;
  if (!bound) {
    const cudaError_t e = cudaFree(nullptr);
    if (e != cudaSuccess) return (int)e;
    bound = true;
  }
  KernelArgs a;
  a.mask = (const uint8_t*)mask;
  a.mask_pair = layout[36];
  a.Kq = Kq;
  a.Kk = Kk;
  a.scale2 = LOG2E / sqrtf((float)dh);
  const void* ptrs[4] = {q, k, v, o};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: return launch<16>(ptrs, layout, a, P, H, st);
    case 32: return launch<32>(ptrs, layout, a, P, H, st);
    case 64: return launch<64>(ptrs, layout, a, P, H, st);
    case 128: return launch<128>(ptrs, layout, a, P, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
