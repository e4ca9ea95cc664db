// The last launch of every route of K4's backward (ssd_scan_bwd.cu,
// ssd_scan_bwd_tc.cu): the partials summed in a fixed order, one thread an
// output element, so two runs give the same bits.
#pragma once
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int REDUCE_THREADS = 256;

// dB and dC (b, S, N) in T: the `parts` partials of each batch row ((b,
// parts, S, N) fp32: one per head, pair or group of heads) summed in order;
// dA (H,): the (b, H, nk) partials summed over the batch rows, then their
// nk parts (one, or one a sub-chunk), in order
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
                      const float* __restrict__ dAh, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA, int nb, int S, int parts, int H, int N, int nk) {
  const size_t idx = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const size_t plane = (size_t)S * N;
  if (idx < (size_t)nb * plane) {
    const size_t b = idx / plane, sn = idx % plane;
    float sb = 0.f, sc = 0.f;
#pragma unroll 8
    for (int p = 0; p < parts; ++p) {  // the loads of 8 partials in flight at once
      const size_t off = (b * parts + p) * plane + sn;
      sb += dBh[off];
      sc += dCh[off];
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

template <typename T>
int launch_reduce(const float* dBh, const float* dCh, const float* dAh, void* dB, void* dC,
                  void* dA, int nb, int S, int parts, int H, int N, int nk,
                  cudaStream_t stream) {
  const size_t total = (size_t)nb * S * N;
  const size_t threads = total > (size_t)H ? total : (size_t)H;
  ssd_bwd_reduce_kernel<T><<<(unsigned)((threads + REDUCE_THREADS - 1) / REDUCE_THREADS),
                             REDUCE_THREADS, 0, stream>>>(
      dBh, dCh, dAh, static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA), nb, S,
      parts, H, N, nk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
