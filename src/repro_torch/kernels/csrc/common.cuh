// Type helpers shared by the kernels: every kernel computes in fp32 and
// reads or writes fp32 or bf16.
#pragma once
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the masked score of the JAX package
constexpr float LOG2E = 1.4426950408889634f;

// 2^x, flushing results below 2^-126 to 0 (a probability or a decay below
// that range matters to nothing the kernels compute); exp2f's range
// handling took about a fifth of K2's backward kernels' time on an H100
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the sum over the 4 lanes of a quad (an mma accumulator row's columns)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

}  // namespace
