// flash_attention_bwd: the gradients dq, dk, dv of o = softmax(q k^T * scale,
// causal or not) v given dO, with grouped-query heads read in place.  Not
// causal, the Skv keys may be more or fewer than the Sq queries (whisper's
// encoder and cross-attention); causal, Sq = Skv.  No sliding-window band.
//
// The TPU kernel it serves is kernels/flash_attention.py:flash_attention
// (_flash_kernel) of the JAX package, which has no backward kernel: the JAX
// package trains through its jnp attention (models/attention.py:
// chunked_attention) and XLA's autodiff.  The port's model calls the
// forward kernel for every attention, so its trainer needs this one.
//
// Layout: q, o, dO, dq (B, Sq, H, hd); k, v, dk, dv (B, Skv, KV, hd); all
// contiguous, fp32 or bf16; query head h reads KV head h / (H / KV).  stats
// (2, B, H, Sq) fp32 is scratch: the rows' log2-sum-exp2 of the scaled
// scores and D = rowsum(dO o), written by the first kernel for the second.
//
// With P = softmax(S), S = q k^T * scale:
//   dv = P^T dO,  dP = dO v^T,  dS = P (dP - D),
//   dq = dS k * scale,  dk = dS^T q * scale.
//
// What bounds it on an H100: five products of 2 * Sq * Skv * hd operations
// per (b, h) (halved when causal) against q, k, v, o, dO and the gradients
// read or written once: operations at prefill lengths.
//
// What the design does about it: it is the simple first kernel, right before
// fast.  Two launches and no atomics, so its sums are deterministic:
//   (a) flash_bwd_dq_kernel, one block per (query tile of 64 rows, head,
//       batch row): D of its rows from dO and o; a first walk over the key
//       tiles recomputes each row's running max and sum (fp32, exp2); a
//       second walk forms P, dP and dS per 64-key tile and accumulates dq.
//       It writes dq and its rows' statistics.
//   (b) flash_bwd_dkdv_kernel, one block per (key tile of 64 keys, KV head,
//       batch row): K and V stay in shared memory while the block walks the
//       G query heads of its KV head and their query tiles, rebuilds P from
//       the statistics and accumulates dv += P^T dO and dk += dS^T q, so the
//       sum over the group needs no second pass.
// Every product runs on the CUDA cores in fp32 from tiles converted to fp32
// in shared memory (a 4 x 4 register tile of scores per thread, float4 reads
// along hd); bf16 inputs are read as bf16 and the gradients rounded once at
// the store.  Causal: (a) stops at the diagonal tile and (b) starts there.
// Keys >= Skv are masked (their rows are zero-filled and would score 0, not
// -inf), and query rows >= Sq contribute nothing to dk and dv.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BT = 64;         // query rows and keys per tile
constexpr int BWD_THREADS = 256;
constexpr int LDP = BT + 4;    // row stride of the 64 x 64 score tiles

template <int HD>
struct BwdTiles {
  static constexpr int LD = HD + 4;  // row stride of a (64, hd) tile
  static constexpr int TILE = BT * LD;
  static constexpr int DQ_SMEM = (4 * TILE + BT * LDP + BT) * 4;
  static constexpr int DKV_SMEM = (4 * TILE + 2 * BT * LDP + 2 * BT) * 4;
};

// rows [r0, r0 + 64) of head h of a (B, S, NH, HD) tensor, as fp32, zeros past S
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b,
                                          int r0, int S, int NH, int h) {
  constexpr int LD = BwdTiles<HD>::LD;
  for (int idx = threadIdx.x; idx < BT * HD; idx += BWD_THREADS) {
    const int r = idx / HD, d = idx % HD, row = r0 + r;
    dst[r * LD + d] = row < S ? to_float(src[(((size_t)b * S + row) * NH + h) * HD + d]) : 0.f;
  }
}

// s[r][c] = A[ty*4 + r] . Bm[tx + 16c] over hd, both (64, hd) tiles
template <int HD>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, float s[4][4], int ty,
                                         int tx) {
  constexpr int LD = BwdTiles<HD>::LD;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(A + (ty * 4 + r) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[r][c] += a[r].x * bv[c].x + a[r].y * bv[c].y + a[r].z * bv[c].z + a[r].w * bv[c].w;
  }
}

// sum and max over the 16 threads (tx) that share a row group
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void fma4(float* acc, float a, float4 v) {
  acc[0] += a * v.x;
  acc[1] += a * v.y;
  acc[2] += a * v.z;
  acc[3] += a * v.w;
}

// acc (4 rows of a thread, HD/16 dims: tx*4 + {0..3}, +64 for hd 128) to
// rows [r0 + ty*4, +4) of head h of a (B, S, NH, HD) tensor, times mul
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (*acc)[HD / 16],
                                           float mul, int b, int r0, int S, int NH, int h,
                                           int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= S) continue;
    T* out = dst + (((size_t)b * S + row) * NH + h) * HD;
#pragma unroll
    for (int e = 0; e < HD / 16; ++e) out[(e / 4) * 64 + tx * 4 + e % 4] = from_float<T>(acc[r][e] * mul);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ stats, int B, int Sq, int Skv, int H, int KV,
                    float scale, int causal) {
  using Tl = BwdTiles<HD>;
  constexpr int LD = Tl::LD;
  constexpr int NE = HD / 16;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* dOs = Qs + Tl::TILE;
  float* Ks = dOs + Tl::TILE;
  float* Vs = Ks + Tl::TILE;
  float* dSt = Vs + Tl::TILE;  // [key][query row]
  float* Ds = dSt + BT * LDP;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const float sl2 = scale * 1.4426950408889634f;

  load_tile<T, HD>(Qs, q, b, q0, Sq, H, h);
  load_tile<T, HD>(dOs, dout, b, q0, Sq, H, h);
  __syncthreads();
  for (int r = warp; r < BT; r += BWD_THREADS / 32) {  // D = rowsum(dO o)
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
      const T* orow = o + (((size_t)b * Sq + row) * H + h) * HD;
      for (int d = lane; d < HD; d += 32) acc += dOs[r * LD + d] * to_float(orow[d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) Ds[r] = acc;
  }

  const int n_tiles = (Skv + BT - 1) / BT;
  const int end = causal ? min(n_tiles, (int)blockIdx.x + 1) : n_tiles;
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  float s[4][4], dp[4][4];
  // walk 1: the rows' max and sum of exp2 of the scaled scores
  for (int t = 0; t < end; ++t) {
    __syncthreads();
    load_tile<T, HD>(Ks, k, b, t * BT, Skv, KV, kvh);
    __syncthreads();
    tile_dot<HD>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = t * BT + tx + 16 * c;
        s[r][c] = (key < Skv && (!causal || key <= row)) ? s[r][c] * sl2 : -INFINITY;
        tmax = fmaxf(tmax, s[r][c]);
      }
      const float mn = fmaxf(m[r], group_max(tmax));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += exp2f(s[r][c] - mn);
      l[r] = l[r] * exp2f(m[r] - mn) + group_sum(sum);
      m[r] = mn;
    }
  }
  float lse[4], dr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lse[r] = m[r] + log2f(l[r]);
    dr[r] = Ds[ty * 4 + r];
  }

  // walk 2: P, dP and dS per key tile; dq += dS k
  float acc[4][NE];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[r][e] = 0.f;
  for (int t = 0; t < end; ++t) {
    __syncthreads();
    load_tile<T, HD>(Ks, k, b, t * BT, Skv, KV, kvh);
    load_tile<T, HD>(Vs, v, b, t * BT, Skv, KV, kvh);
    __syncthreads();
    tile_dot<HD>(Qs, Ks, s, ty, tx);
    tile_dot<HD>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = t * BT + tx + 16 * c;
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = q0 + ty * 4 + r;
        const bool valid = key < Skv && (!causal || key <= row);
        const float p = valid ? exp2f(s[r][c] * sl2 - lse[r]) : 0.f;
        ds[r] = p * (dp[r][c] - dr[r]);
      }
      *reinterpret_cast<float4*>(dSt + (tx + 16 * c) * LDP + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float4 dsv = *reinterpret_cast<const float4*>(dSt + j * LDP + ty * 4);
      const float dsr[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
      for (int half = 0; half < NE / 4; ++half) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + j * LD + half * 64 + tx * 4);
#pragma unroll
        for (int r = 0; r < 4; ++r) fma4(&acc[r][half * 4], dsr[r], kv);
      }
    }
  }
  store_rows<T, HD>(dq, acc, scale, b, q0, Sq, H, h, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      if (row < Sq) {
        const size_t i = ((size_t)b * H + h) * Sq + row;
        stats[i] = lse[r];
        stats[(size_t)B * H * Sq + i] = dr[r];
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout, T* __restrict__ dk,
                      T* __restrict__ dv, const float* __restrict__ stats, int B, int Sq,
                      int Skv, int H, int KV, float scale, int causal) {
  using Tl = BwdTiles<HD>;
  constexpr int LD = Tl::LD;
  constexpr int NE = HD / 16;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + Tl::TILE;
  float* Qs = Vs + Tl::TILE;
  float* dOs = Qs + Tl::TILE;
  float* Ps = dOs + Tl::TILE;  // [query row][key]
  float* dSs = Ps + BT * LDP;  // [query row][key]
  float* Ls = dSs + BT * LDP;
  float* Ds = Ls + BT;

  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * BT;
  const int G = H / KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float sl2 = scale * 1.4426950408889634f;

  load_tile<T, HD>(Ks, k, b, k0, Skv, KV, kvh);
  load_tile<T, HD>(Vs, v, b, k0, Skv, KV, kvh);
  float adk[4][NE], adv[4][NE];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < NE; ++e) adk[r][e] = adv[r][e] = 0.f;

  const int n_tiles = (Sq + BT - 1) / BT;
  const int start = causal ? blockIdx.x : 0;  // earlier rows see none of these keys
  float s[4][4], dp[4][4];
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int t = start; t < n_tiles; ++t) {
      const int r0 = t * BT;
      __syncthreads();
      load_tile<T, HD>(Qs, q, b, r0, Sq, H, h);
      load_tile<T, HD>(dOs, dout, b, r0, Sq, H, h);
      if (tid < BT) {
        const int row = r0 + tid;
        const size_t i = ((size_t)b * H + h) * Sq + row;
        Ls[tid] = row < Sq ? stats[i] : 0.f;
        Ds[tid] = row < Sq ? stats[(size_t)B * H * Sq + i] : 0.f;
      }
      __syncthreads();
      tile_dot<HD>(Qs, Ks, s, ty, tx);
      tile_dot<HD>(dOs, Vs, dp, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rr = ty * 4 + r, row = r0 + rr;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + tx + 16 * c;
          const bool valid = row < Sq && key < Skv && (!causal || key <= row);
          const float p = valid ? exp2f(s[r][c] * sl2 - Ls[rr]) : 0.f;
          Ps[rr * LDP + tx + 16 * c] = p;
          dSs[rr * LDP + tx + 16 * c] = p * (dp[r][c] - Ds[rr]);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < BT; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + i * LDP + ty * 4);
        const float4 dsv = *reinterpret_cast<const float4*>(dSs + i * LDP + ty * 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
        const float dsr[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
        for (int half = 0; half < NE / 4; ++half) {
          const float4 ov = *reinterpret_cast<const float4*>(dOs + i * LD + half * 64 + tx * 4);
          const float4 qv = *reinterpret_cast<const float4*>(Qs + i * LD + half * 64 + tx * 4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            fma4(&adv[r][half * 4], pr[r], ov);
            fma4(&adk[r][half * 4], dsr[r], qv);
          }
        }
      }
    }
  }
  store_rows<T, HD>(dk, adk, scale, b, k0, Skv, KV, kvh, ty, tx);
  store_rows<T, HD>(dv, adv, 1.f, b, k0, Skv, KV, kvh, ty, tx);
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               void* dq, void* dk, void* dv, float* stats, int B, int Sq, int Skv, int H,
               int KV, int causal, float scale, cudaStream_t stream) {
  using Tl = BwdTiles<HD>;
  static hopper::SmemRaised raised_dq, raised_dkdv;
  cudaError_t err = hopper::allow_smem(flash_bwd_dq_kernel<T, HD>, Tl::DQ_SMEM, raised_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hopper::allow_smem(flash_bwd_dkdv_kernel<T, HD>, Tl::DKV_SMEM, raised_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, HD><<<dim3((Sq + BT - 1) / BT, H, B), BWD_THREADS, Tl::DQ_SMEM, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq), stats, B, Sq, Skv, H, KV,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, HD>
      <<<dim3((Skv + BT - 1) / BT, KV, B), BWD_THREADS, Tl::DKV_SMEM, stream>>>(
          qt, kt, vt, dot, static_cast<T*>(dk), static_cast<T*>(dv), stats, B, Sq, Skv, H, KV,
          scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; hd: 64 or 128; Sq != Skv not causal only.
// stats: fp32 scratch of 2 * B * H * Sq.  Returns the cudaError_t of the
// launches, or cudaErrorInvalidValue for what the kernels do not take.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* stats,
                                   int B, int Sq, int Skv, int H, int KV, int hd, int causal,
                                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if ((causal && Sq != Skv) || Sq < 1 || Skv < 1 || KV < 1 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && hd == 64)
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, o, dout, dq, dk, dv, st, B, Sq, Skv, H, KV,
                                         causal, scale, s);
  if (dtype == 1 && hd == 128)
    return launch_bwd<__nv_bfloat16, 128>(q, k, v, o, dout, dq, dk, dv, st, B, Sq, Skv, H, KV,
                                          causal, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_bwd<float, 64>(q, k, v, o, dout, dq, dk, dv, st, B, Sq, Skv, H, KV, causal,
                                 scale, s);
  if (dtype == 0 && hd == 128)
    return launch_bwd<float, 128>(q, k, v, o, dout, dq, dk, dv, st, B, Sq, Skv, H, KV, causal,
                                  scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
