// The wgmma pieces that K2's bf16 kernels share (flash_attention.cu's
// forward, flash_attention_bwd.cu's two backward kernels): descriptors of
// the 128-byte-swizzled tiles that TMA writes, the score product A B^T over
// hd from two K-major tiles, the product of a score tile's bf16 fragments
// (registers) against an MN-major tile, and the slot of an accumulator's
// column block among those fragments.
#pragma once
#include <stdint.h>

#include "hopper.cuh"

namespace {

// k16 step kk of a K-major operand (rows of 128 bytes, its 64-column blocks
// `blk` bytes apart), and k16 step c of an MN-major one (k along its
// 128-byte rows, its 64-column blocks `blk` bytes apart)
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int blk, int kk) {
  return hopper::make_desc(tile + (kk / 4) * blk + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int blk, int c) {
  return hopper::make_desc(tile + c * 2048, blk, 1024);
}

// d (=) A B^T over hd: A 64 rows, B N (64 or 128) rows, both K-major tiles
// in shared memory; m64nN, HD / 16 k16 steps
template <int HD, int N>
__device__ __forceinline__ void score_product(float (&d)[N / 2], const unsigned char* a, int a_blk,
                                              const unsigned char* b, int b_blk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (N == 64)
      hopper::wgmma_ss_n64<0>(d, kmajor(a, a_blk, kk), kmajor(b, b_blk, kk), kk > 0);
    else
      hopper::wgmma_ss_n128<0, 0>(d, kmajor(a, a_blk, kk), kmajor(b, b_blk, kk), kk > 0);
  }
}

// acc (+)= A B: A 64 x K from registers (K / 16 k16 steps of bf16 pairs), B
// the MN-major K-row tile: N = HD
template <int HD, int K>
__device__ __forceinline__ void rs_product(float (&acc)[HD / 2], const uint32_t (&a)[K / 4],
                                           const unsigned char* b, int b_blk) {
#pragma unroll
  for (int c = 0; c < K / 16; ++c) {
    const uint32_t a4[4] = {a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3]};
    if constexpr (HD == 64) hopper::wgmma_rs_n64<1>(acc, a4, mnmajor(b, b_blk, c), 1);
    else hopper::wgmma_rs_n128<1>(acc, a4, mnmajor(b, b_blk, c), 1);
  }
}

// The A fragment slot of accumulator column block j, row half hh: a product
// over the accumulator's columns takes its bf16 pairs from registers.
__device__ __forceinline__ constexpr int frag(int j, int hh) { return 4 * (j / 2) + 2 * (j % 2) + hh; }

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

}  // namespace
