// flash_attention: causal (or full) softmax(q k^T / sqrt(hd)) v for prefill,
// with grouped-query heads read in place.
//
// Replaces the TPU kernel kernels/flash_attention.py:flash_attention
// (_flash_kernel) of the JAX package.
//
// Layout: q and out (B, S, H, hd), k and v (B, S, KV, hd), all contiguous;
// query head h reads KV head h / (H / KV), so no broadcast copy of the KV
// heads is made.  Positions are absolute and start at 0 for q and kv.
//
// What bounds it on an H100: at prefill lengths (S = 512, hd = 64) each
// (q, kv) pair costs 4*hd operations on 4*hd bytes of tile traffic that stays
// in shared memory, so it is bound by operations, on the CUDA cores here.
//
// What the design does about it: one block per (q tile of 64 rows, q head,
// batch row) keeps the online-softmax state (m, l, acc) in fp32 registers and
// walks K/V in 32-key tiles staged in shared memory, so q, k and v are each
// read from device memory once per block and the (S, S) score matrix is never
// written.  Causal blocks stop the kv loop at the diagonal instead of masking
// the tiles above it.  Two threads share one query row and split head_dim
// into interleaved float2 pairs, so a warp's shared-memory reads are
// broadcasts.  Products run on the CUDA cores in fp32; tensor cores (wgmma)
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int FQ = 64;            // query rows per block
constexpr int FK = 32;            // keys per shared-memory tile
constexpr int THREADS = 2 * FQ;   // two threads per query row

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             int KV, float scale, int causal) {
  constexpr int NP = HD / 4;  // float2 pairs per thread: dims 4i + 2*half + {0,1}
  __shared__ __align__(16) float Ks[FK][HD];
  __shared__ __align__(16) float Vs[FK][HD];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const int kvh = h / (H / KV);
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qpos = q0 + row;
  const bool valid = qpos < S;

  float qr[2 * NP], acc[2 * NP];
  const size_t qoff = (((size_t)b * S + qpos) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      qr[2 * i + e] = valid ? to_float(q[qoff + 4 * i + 2 * half + e]) : 0.f;
      acc[2 * i + e] = 0.f;
    }
  float m = NEG_INF, l = 0.f;

  const int kend = causal ? min(S, q0 + FQ) : S;
  for (int k0 = 0; k0 < kend; k0 += FK) {
    for (int i = threadIdx.x; i < FK * HD; i += THREADS) {
      const int r = i / HD, c = i % HD;
      const int gk = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (gk < S) {
        const size_t off = (((size_t)b * S + gk) * KV + kvh) * HD + c;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      Ks[r][c] = kv;
      Vs[r][c] = vv;
    }
    __syncthreads();

    float s[FK];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float2 kk = *reinterpret_cast<const float2*>(&Ks[j][4 * i + 2 * half]);
        part = fmaf(qr[2 * i], kk.x, part);
        part = fmaf(qr[2 * i + 1], kk.y, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const int gk = k0 + j;
      float sj = part * scale;
      if (gk >= S || (causal && gk > qpos)) sj = NEG_INF;
      s[j] = sj;
      mt = fmaxf(mt, sj);
    }
    const float mn = fmaxf(m, mt);
    const float r = expf(m - mn);
    l *= r;
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i) acc[i] *= r;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      const float p = expf(s[j] - mn);
      l += p;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float2 vv = *reinterpret_cast<const float2*>(&Vs[j][4 * i + 2 * half]);
        acc[2 * i] = fmaf(p, vv.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(p, vv.y, acc[2 * i + 1]);
      }
    }
    m = mn;
    __syncthreads();
  }

  if (valid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[qoff + 4 * i + 2 * half + e] = from_float<T>(acc[2 * i + e] * inv);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* out, int B, int S,
            int H, int KV, int causal, float scale, cudaStream_t s) {
  const dim3 grid((S + FQ - 1) / FQ, H, B);
  flash_kernel<T, HD><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KV, scale, causal);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; hd: 64 or 128.  Returns the cudaError_t of the
// launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int KV, int hd,
                               int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) launch<float, 64>(q, k, v, out, B, S, H, KV, causal, scale, s);
  else if (dtype == 0 && hd == 128) launch<float, 128>(q, k, v, out, B, S, H, KV, causal, scale, s);
  else if (dtype == 1 && hd == 64) launch<__nv_bfloat16, 64>(q, k, v, out, B, S, H, KV, causal, scale, s);
  else if (dtype == 1 && hd == 128) launch<__nv_bfloat16, 128>(q, k, v, out, B, S, H, KV, causal, scale, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
