// streamed_matmul: out(M,N) = x(M,K) @ w(K,N), fp32 accumulation, output in
// x's type (bf16 or fp32).
//
// Replaces the TPU kernel kernels/streamed_matmul.py:streamed_matmul
// (_matmul_kernel) of the JAX package.
//
// What bounds it on an H100: at decode (M = batch, 8) each call streams its
// whole weight matrix from device memory once and does 2*M operations per
// weight element, far below the ~295 operations per byte where the tensor
// cores become the limit, so it is bound by bytes.  At prefill (M = B*S, in
// the thousands) it is bound by tensor-core operations.
//
// What the design does about it: one block per 64x64 output tile walks K in
// 32-wide steps through shared memory; bf16 tiles go through the tensor cores
// (mma.sync via nvcuda::wmma) into fp32 accumulators, with 16-byte loads where
// the shapes and pointers allow.  The weight may be given transposed (w_t=1:
// w is the transpose of a contiguous (N,K) array), so the tied unembedding
// reads the (vocab, d) embedding table in place instead of copying it.  Ragged
// edges are masked, so any M, N, K is taken.  When the output tiles alone
// would leave most SMs idle (decode: M = 8 and N = 896 is 14 tiles), the
// caller splits K over blockIdx.z: each split writes an fp32 partial tile to
// a workspace and a second pass sums them.  fp32 runs on the CUDA cores
// (plain FMA tiles): it exists for parity runs, not for speed.  No TMA,
// wgmma or multi-stage pipeline yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------- bf16 path
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 128;    // 4 warps, 2x2 over the tile, 32x32 each
constexpr int LDA = BK + 8;     // x tile [BM][LDA], k contiguous
constexpr int LDB = BN + 8;     // w tile [BK][LDB], n contiguous (w_t = 0)
constexpr int LDBT = BK + 8;    // w tile [BN][LDBT], k contiguous (w_t = 1)
constexpr int LDC = BN + 4;     // fp32 staging of the output tile
constexpr int SMEM_AB = (BM * LDA + (BK * LDB > BN * LDBT ? BK * LDB : BN * LDBT)) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM_BYTES = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

template <bool VEC>
__device__ __forceinline__ void load_x_tile(const __nv_bfloat16* __restrict__ x,
                                            __nv_bfloat16* As, int M, int K,
                                            int m0, int k0) {
  if (VEC) {
    for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K)
        val = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
      *reinterpret_cast<uint4*>(As + r * LDA + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r * LDA + c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk]
                                           : __float2bfloat16(0.f);
    }
  }
}

template <bool WT, bool VEC>
__device__ __forceinline__ void load_w_tile(const __nv_bfloat16* __restrict__ w,
                                            __nv_bfloat16* Bs, int N, int K,
                                            int k0, int n0) {
  if (!WT) {  // w row-major (K, N): tile rows along k, n contiguous
    if (VEC) {
      for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gk < K && gn < N)
          val = *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
        *reinterpret_cast<uint4*>(Bs + r * LDB + c) = val;
      }
    } else {
      for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const int gk = k0 + r, gn = n0 + c;
        Bs[r * LDB + c] = (gk < K && gn < N) ? w[(size_t)gk * N + gn]
                                             : __float2bfloat16(0.f);
      }
    }
  } else {  // w = transpose of row-major (N, K): tile rows along n, k contiguous
    if (VEC) {
      for (int i = threadIdx.x; i < BN * BK / 8; i += THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + c;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gn < N && gk < K)
          val = *reinterpret_cast<const uint4*>(w + (size_t)gn * K + gk);
        *reinterpret_cast<uint4*>(Bs + r * LDBT + c) = val;
      }
    } else {
      for (int i = threadIdx.x; i < BN * BK; i += THREADS) {
        const int r = i / BK, c = i % BK;
        const int gn = n0 + r, gk = k0 + c;
        Bs[r * LDBT + c] = (gn < N && gk < K) ? w[(size_t)gn * K + gk]
                                              : __float2bfloat16(0.f);
      }
    }
  }
}

template <bool WT, bool VEC>
__global__ void __launch_bounds__(THREADS)
matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                   int M, int N, int K, int k_per_split) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  using BLayout = typename std::conditional<WT, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_x_tile<VEC>(x, As, M, K, m0, k0);
    load_w_tile<WT, VEC>(w, Bs, N, K, k0, n0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (WT)
          wmma::load_matrix_sync(b[j], Bs + (wn + j * 16) * LDBT + kk, LDBT);
        else
          wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn + j * 16, LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    if (ws) ws[((size_t)blockIdx.z * M + gm) * N + gn] = Cs[r * LDC + c];
    else out[(size_t)gm * N + gn] = __float2bfloat16(Cs[r * LDC + c]);
  }
}

// ---------------------------------------------------------------- fp32 path
constexpr int FBM = 64, FBN = 64, FBK = 16, FTHREADS = 256;

template <bool WT>
__global__ void __launch_bounds__(FTHREADS)
matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, float* __restrict__ ws, int M, int N,
                  int K, int k_per_split) {
  __shared__ float As[FBK][FBM + 1];  // k-major: As[k][m]
  __shared__ float Bs[FBK][FBN + 1];  // Bs[k][n]
  const int n0 = blockIdx.x * FBN, m0 = blockIdx.y * FBM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  for (int k0 = k_begin; k0 < k_end; k0 += FBK) {
    for (int i = threadIdx.x; i < FBM * FBK; i += FTHREADS) {
      const int r = i / FBK, c = i % FBK;  // r along m, c along k
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < FBK * FBN; i += FTHREADS) {
      int r, c;  // r along k, c along n
      if (WT) { r = i % FBK; c = i / FBK; } else { r = i / FBN; c = i % FBN; }
      const int gk = k0 + r, gn = n0 + c;
      float val = 0.f;
      if (gk < K && gn < N) val = WT ? w[(size_t)gn * K + gk] : w[(size_t)gk * N + gn];
      Bs[r][c] = val;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm >= M || gn >= N) continue;
      if (ws) ws[((size_t)blockIdx.z * M + gm) * N + gn] = acc[i][j];
      else out[(size_t)gm * N + gn] = acc[i][j];
    }
}

// Sums the split-K partials ws (splits, M, N) into out.
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                                     size_t MN, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += ws[z * MN + i];
    out[i] = from_float<T>(sum);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  w_t: 0 = w row-major (K, N); 1 = w is the
// transpose of a row-major (N, K) array.  x and out are row-major.  With
// splits > 1, K is cut into that many ranges and ws is fp32 scratch of
// splits * M * N elements.  Returns the cudaError_t of the launches.
extern "C" int streamed_matmul(const void* x, const void* w, void* out, void* ws,
                               int M, int N, int K, int w_t, int splits, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = splits > 1 ? static_cast<float*>(ws) : nullptr;
  if (splits < 1 || (splits > 1 && ws == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    const int k_per = ((K + BK - 1) / BK + splits - 1) / splits * BK;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
    const bool vec = K % 8 == 0 && (w_t || N % 8 == 0) && aligned16(x) && aligned16(w);
    auto xb = static_cast<const __nv_bfloat16*>(x);
    auto wb = static_cast<const __nv_bfloat16*>(w);
    auto ob = static_cast<__nv_bfloat16*>(out);
    if (w_t && vec) matmul_bf16_kernel<true, true><<<grid, THREADS, 0, s>>>(xb, wb, ob, wsf, M, N, K, k_per);
    else if (w_t) matmul_bf16_kernel<true, false><<<grid, THREADS, 0, s>>>(xb, wb, ob, wsf, M, N, K, k_per);
    else if (vec) matmul_bf16_kernel<false, true><<<grid, THREADS, 0, s>>>(xb, wb, ob, wsf, M, N, K, k_per);
    else matmul_bf16_kernel<false, false><<<grid, THREADS, 0, s>>>(xb, wb, ob, wsf, M, N, K, k_per);
  } else if (dtype == 0) {
    const int k_per = ((K + FBK - 1) / FBK + splits - 1) / splits * FBK;
    const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, splits);
    auto xf = static_cast<const float*>(x);
    auto wf = static_cast<const float*>(w);
    auto of = static_cast<float*>(out);
    if (w_t) matmul_f32_kernel<true><<<grid, FTHREADS, 0, s>>>(xf, wf, of, wsf, M, N, K, k_per);
    else matmul_f32_kernel<false><<<grid, FTHREADS, 0, s>>>(xf, wf, of, wsf, M, N, K, k_per);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits == 1) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t MN = (size_t)M * N;
  const int blocks = (int)((MN + 255) / 256 < 1024 ? (MN + 255) / 256 : 1024);
  if (dtype == 1)
    splitk_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(wsf, static_cast<__nv_bfloat16*>(out), MN, splits);
  else
    splitk_reduce_kernel<float><<<blocks, 256, 0, s>>>(wsf, static_cast<float*>(out), MN, splits);
  return static_cast<int>(cudaGetLastError());
}
