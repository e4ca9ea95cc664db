// The last launch of every route of K4's backward (ssd_scan_bwd.cu,
// ssd_scan_bwd_tc.cu): the partials summed in a fixed order, one thread an
// output element, so two runs give the same bits.
#pragma once
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int REDUCE_THREADS = 256;

// dB and dC (b, S, N) in T: the `parts` partials of each batch row ((b,
// parts, S, N) in PT, fp32 or bf16: one per head, pair or group of heads)
// summed in order in fp32;
// dA (H,): the (b, H, nk) partials summed over the batch rows, then their
// nk parts (one, or one a sub-chunk or pass), in order.  With `pre` (the
// wgmma route's): ddt (b, S, H) += A (tot - pre), dcum's state terms summed
// over the sequence (tot, (b, H)) less their sum over the rows before
// (pre, (b, S, H)): the part of da that the forward pass holds.
template <typename T, typename PT>
__global__ void __launch_bounds__(REDUCE_THREADS)
ssd_bwd_reduce_kernel(const PT* __restrict__ dBh, const PT* __restrict__ dCh,
                      const float* __restrict__ dAh, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA, int nb, int S, int parts, int H, int N, int nk,
                      const float* __restrict__ pre, const float* __restrict__ tot,
                      const float* __restrict__ A, float* __restrict__ ddt) {
  const size_t idx = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (pre && idx < (size_t)nb * S * H) {
    const int h = (int)(idx % H);
    const size_t b = idx / ((size_t)S * H);
    ddt[idx] = fmaf(A[h], tot[b * H + h] - pre[idx], ddt[idx]);
  }
  const size_t plane = (size_t)S * N;
  if (idx < (size_t)nb * plane) {
    const size_t b = idx / plane, sn = idx % plane;
    float sb = 0.f, sc = 0.f;
#pragma unroll 8
    for (int p = 0; p < parts; ++p) {  // the loads of 8 partials in flight at once
      const size_t off = (b * parts + p) * plane + sn;
      sb += to_float(dBh[off]);
      sc += to_float(dCh[off]);
    }
    dB[idx] = from_float<T>(sb);
    dC[idx] = from_float<T>(sc);
  }
  if (idx < (size_t)H) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b)
      for (int k = 0; k < nk; ++k) s += dAh[((size_t)b * H + idx) * nk + k];
    dA[idx] = s;
  }
}

template <typename T, typename PT = float>
int launch_reduce(const PT* dBh, const PT* dCh, const float* dAh, void* dB, void* dC,
                  void* dA, int nb, int S, int parts, int H, int N, int nk,
                  cudaStream_t stream, const float* pre = nullptr, const float* tot = nullptr,
                  const void* A = nullptr, void* ddt = nullptr) {
  size_t threads = (size_t)nb * S * N;
  if (threads < (size_t)H) threads = H;
  if (pre && threads < (size_t)nb * S * H) threads = (size_t)nb * S * H;
  ssd_bwd_reduce_kernel<T, PT><<<(unsigned)((threads + REDUCE_THREADS - 1) / REDUCE_THREADS),
                             REDUCE_THREADS, 0, stream>>>(
      dBh, dCh, dAh, static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA), nb, S,
      parts, H, N, nk, pre, tot, static_cast<const float*>(A), static_cast<float*>(ddt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
