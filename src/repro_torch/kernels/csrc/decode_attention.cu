// decode_attention: one query token per (batch row, head) against the KV
// cache, softmax over cache positions < length, split over the sequence.
//
// Replaces the TPU kernel kernels/decode_attention.py:decode_attention
// (_decode_kernel) of the JAX package.
//
// Layout: q and out (B, H, hd); the cache k, v (B, S, KV, hd) is read in
// place, with no transpose.  length is a runtime int (1 <= length <= S).
//
// What bounds it on an H100: each cache element is read once and used for
// 2*G operations (G query heads per KV head), so it is bound by the bytes
// of the first `length` cache rows.
//
// What the design does about it: the sequence is split into 64-key chunks
// and the grid runs over (chunk, KV head, batch row), so B*KV = 16 pairs
// still give hundreds of blocks at a 1k cache.  The G query heads that share
// a KV head are processed by the same block, so each K and V row is read from
// device memory once.  Each block writes a partial (m, l, acc) in fp32 to
// scratch that the caller allocates; a second small kernel merges the chunks.
// Only chunks below `length` are launched.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int DCHUNK = 64;   // keys per block
constexpr int DWARPS = 4;
constexpr int DTHREADS = 32 * DWARPS;
constexpr int MAXG = 8;      // query heads per KV head

template <typename T, int HD>
__global__ void __launch_bounds__(DTHREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ o_part,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    int S, int H, int KV, int length, int n_splits, float scale) {
  static_assert(DCHUNK == 64, "phase 2 gives each lane two keys");
  constexpr int PER = HD / 32;  // dims per lane: lane*PER .. lane*PER+PER-1
  __shared__ float Ss[MAXG][DCHUNK];
  __shared__ float Ms[MAXG], Ls[MAXG];
  __shared__ float Acc[DWARPS][MAXG][HD];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, h0 = kvh * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = split * DCHUNK;

  float qr[MAXG][PER];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < PER; ++e)
      qr[g][e] = g < G ? to_float(q[((size_t)b * H + h0 + g) * HD + lane * PER + e]) : 0.f;

  // scores: warp w takes keys w, w+4, ...; lanes split head_dim
  for (int jj = warp; jj < DCHUNK; jj += DWARPS) {
    const int j = j0 + jj;
    if (j < length) {
      const T* kr = k + (((size_t)b * S + j) * KV + kvh) * HD + lane * PER;
      float kv[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) kv[e] = to_float(kr[e]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < PER; ++e) part = fmaf(qr[g][e], kv[e], part);
          part = warp_sum(part);
          if (lane == 0) Ss[g][jj] = part * scale;
        }
      }
    } else if (lane < G) {
      Ss[lane][jj] = NEG_INF;
    }
  }
  __syncthreads();

  // chunk softmax statistics, one warp per query head
  for (int g = warp; g < G; g += DWARPS) {
    const float a = Ss[g][lane], c = Ss[g][lane + 32];
    const float mx = warp_max(fmaxf(a, c));
    const float pa = expf(a - mx), pc = expf(c - mx);
    Ss[g][lane] = pa;
    Ss[g][lane + 32] = pc;
    const float sum = warp_sum(pa + pc);
    if (lane == 0) {
      Ms[g] = mx;
      Ls[g] = sum;
    }
  }
  __syncthreads();

  // p @ v: the same key split as the scores, then a sum over the warps
  float acc[MAXG][PER];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[g][e] = 0.f;
  for (int jj = warp; jj < DCHUNK; jj += DWARPS) {
    const int j = j0 + jj;
    if (j < length) {
      const T* vr = v + (((size_t)b * S + j) * KV + kvh) * HD + lane * PER;
      float vv[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) vv[e] = to_float(vr[e]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float p = Ss[g][jj];
#pragma unroll
          for (int e = 0; e < PER; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G)
#pragma unroll
      for (int e = 0; e < PER; ++e) Acc[warp][g][lane * PER + e] = acc[g][e];
  __syncthreads();

  for (int i = threadIdx.x; i < G * HD; i += DTHREADS) {
    const int g = i / HD, d = i % HD;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) sum += Acc[w][g][d];
    const size_t r = ((size_t)b * H + h0 + g) * n_splits + split;
    o_part[r * HD + d] = sum;
    if (d == 0) {
      m_part[r] = Ms[g];
      l_part[r] = Ls[g];
    }
  }
}

// One block per (batch row, head), one thread per head_dim element.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ o_part,
                                      const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      T* __restrict__ out, int n_splits, int HD) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* mp = m_part + (size_t)bh * n_splits;
  const float* lp = l_part + (size_t)bh * n_splits;
  float M = NEG_INF;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, mp[s]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(mp[s] - M);
    L = fmaf(lp[s], w, L);
    o = fmaf(o_part[((size_t)bh * n_splits + s) * HD + d], w, o);
  }
  out[(size_t)bh * HD + d] = from_float<T>(o / fmaxf(L, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* o_part,
           float* m_part, float* l_part, int B, int S, int H, int KV, int length,
           int n_splits, float scale, cudaStream_t s) {
  const dim3 grid(n_splits, KV, B);
  decode_split_kernel<T, HD><<<grid, DTHREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      o_part, m_part, l_part, S, H, KV, length, n_splits, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * H, HD, 0, s>>>(o_part, m_part, l_part,
                                                static_cast<T*>(out), n_splits, HD);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_chunk() { return DCHUNK; }
extern "C" int decode_attention_max_group() { return MAXG; }

// dtype: 0 = fp32, 1 = bf16; hd: 64 or 128; H / KV <= MAXG;
// n_splits = ceil(length / DCHUNK).  o_part (B, H, n_splits, hd), m_part and
// l_part (B, H, n_splits) are fp32 scratch.  Returns the cudaError_t of the
// launches.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* out, void* o_part, void* m_part,
                                void* l_part, int B, int S, int H, int KV, int hd,
                                int length, int n_splits, float scale, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, out, op, mp, lp, B, S, H, KV, length, n_splits, scale, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, out, op, mp, lp, B, S, H, KV, length, n_splits, scale, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, op, mp, lp, B, S, H, KV, length, n_splits, scale, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, op, mp, lp, B, S, H, KV, length, n_splits, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
