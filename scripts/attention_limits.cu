// Throughput of the instructions the attention kernel's softmax issues, on
// one SM's worth of threads per block: each thread runs `iters` rounds of 8
// independent operations and block 0's thread 0 reports the clock ticks.
// Built and run by scripts/attention_limits.py.

#include <cuda_runtime.h>
#include <stdint.h>

template <int OP>
__global__ void throughput(float* out, int iters, long long* ticks) {
  float a[8];
  uint32_t u[8];
  for (int i = 0; i < 8; ++i) {
    a[i] = -0.001f * (threadIdx.x + i);
    u[i] = threadIdx.x * 77 + i;
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (OP == 0) asm volatile("ex2.approx.ftz.f32 %0, %0;" : "+f"(a[i]));
      if (OP == 1) asm volatile("max.f32 %0, %0, %1;" : "+f"(a[i]) : "f"(a[(i + 1) & 7]));
      if (OP == 2) asm volatile("lop3.b32 %0, %0, %1, 0xff800000, 0xEA;" : "+r"(u[i]) : "r"(u[(i + 3) & 7]));
      if (OP == 3) asm volatile("fma.rn.f32 %0, %0, 0f3F000001, 0f3E000000;" : "+f"(a[i]));
      if (OP == 4) asm volatile("prmt.b32 %0, %0, 0, 0x9999;" : "+r"(u[i]));
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += a[i] + (float)u[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) ticks[blockIdx.x] = t1 - t0;
}

// op: 0 ex2.approx.ftz.f32, 1 max.f32, 2 lop3.b32, 3 fma.rn.f32, 4 prmt.b32
extern "C" int attention_limits_throughput(int op, float* out, long long* ticks, int blocks, int threads,
                                           int iters) {
  switch (op) {
    case 0: throughput<0><<<blocks, threads>>>(out, iters, ticks); break;
    case 1: throughput<1><<<blocks, threads>>>(out, iters, ticks); break;
    case 2: throughput<2><<<blocks, threads>>>(out, iters, ticks); break;
    case 3: throughput<3><<<blocks, threads>>>(out, iters, ticks); break;
    case 4: throughput<4><<<blocks, threads>>>(out, iters, ticks); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaDeviceSynchronize();
}
