// flash_attention_bwd: the gradients dq, dk, dv of o = softmax(q k^T * scale,
// causal or not) v given dO, with grouped-query heads read in place.  Not
// causal, the Skv keys may be more or fewer than the Sq queries (whisper's
// encoder and cross-attention); causal, query row r sits at position q_offset
// + r among the Skv >= q_offset + Sq keys (q_offset 0 and Sq = Skv for a whole
// sequence, a query shard of a sequence-sharded attention otherwise) and
// attends keys j <= q_offset + r.  Under a sliding window w (causal only;
// hymba's band) it attends keys q_offset + r - w < j <= q_offset + r.
//
// The TPU kernel it serves is kernels/flash_attention.py:flash_attention
// (_flash_kernel) of the JAX package, which has no backward kernel: the JAX
// package trains through its jnp attention (models/attention.py:
// chunked_attention) and XLA's autodiff.  The port's model calls the
// forward kernel for every attention, so its trainer needs this one.
//
// Layout: q, o, dO, dq (B, Sq, H, hd); k, v, dk, dv (B, Skv, KV, hd); all
// contiguous, fp32 or bf16; query head h reads KV head h / (H / KV).
//
// With P = softmax(S), S = q k^T * scale:
//   dv = P^T dO,  dP = dO v^T,  dS = P (dP - D),  D = rowsum(dO o),
//   dq = dS k * scale,  dk = dS^T q * scale.
//
// What bounds it on an H100: five products of 2 * Sq * Skv * hd operations
// per (b, h) (halved when causal) against q, k, v, o, dO and the gradients
// read or written once: tensor-core operations at prefill lengths.  Under
// a window each query row attends at most w keys, and the kernels visit only
// the tiles of the band.
//
// What the design does about it (bf16, close to FlashAttention-3's backward
// without its atomics): every product is a wgmma from tiles that TMA loads
// in place (4D maps over the tensors, 128-byte swizzle), in two launches, so
// the sums are deterministic:
//   (a) flash_bwd_dq_wgmma_kernel, one block per (query tile of 128 rows,
//       head, batch row), the longest causal tiles first.  A producer warp
//       loads the Q and dO tiles once and streams 64-key K and V tiles
//       through a ring of 2 stages; two consumer warpgroups own 64 rows
//       each, form D = rowsum(dO o) in fp32 (written for (b)), and per key
//       tile S = Q K^T and dP = dO V^T (both operands K-major in shared
//       memory), P = exp2(S scale log2(e) - lse) from the row's
//       log2-sum-exp2 that the forward wrote, dS = P (dP - D) rounded to
//       bf16 in registers, and dQ += dS K (dS the register A operand, K an
//       MN-major B: the forward's P.V).
//   (b) flash_bwd_dkdv_wgmma_kernel, one block per (key tile of 64 keys, KV
//       head, batch row).  TMA loads K and V once; a producer warpgroup
//       streams the (query tile of 64 rows, head) items of the KV head's
//       group, with each tile's lse and D, through a ring of 4 stages, from
//       the diagonal tile when causal.  Two consumer warpgroups take the
//       items in turn and compute the transposed products, so that P^T and
//       dS^T land in the accumulator layout and feed the next product from
//       registers: S^T = K Q^T, P^T = exp2(S^T scale log2(e) - lse) (lse
//       along the columns), dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T -
//       D), dK += dS^T Q.  At the end the second warpgroup's dK and dV go
//       through shared memory and the first adds them to its own, in that
//       order, so the sum over the group needs no second pass.  setmaxnreg
//       gives the consumers 240 registers (hd 128: dK and dV alone are 128
//       fp32 a thread) and the producer 24.
// The band (BAND, a template flag of both bf16 kernels, so that the causal
// instances are built without its code and keep their registers): in (a) a
// block's key loop, and its producer's loads, start at the tile of key q0 -
// w + 1 and a warpgroup skips the tiles below its rows' band; in (b) a key
// tile's query items end at the tile of its last key's last query row, k0 +
// 63 + w - 1.  The tiles that cross the band's low edge are masked as the
// diagonal one is, and the lse the forward wrote is the band's.
// q_offset moves every such bound by the offset: in (a) the block's and each
// warpgroup's key tiles end at the tile of key q_offset + the last row, in (b)
// a key tile's query items start at the tile of row k0 - q_offset (none when
// that is past Sq, and then the block stores zero dk and dv) and, under a
// window, end at the tile of row k0 + 63 + w - 1 - q_offset.
// P and dS are rounded to bf16 for their products, as the forward rounds P;
// the statistics, D and every sum stay fp32; each gradient is rounded once,
// at the store.  Only the tiles on the causal diagonal and at the ragged
// edges are masked: keys >= Skv (TMA's zero fill scores 0, not -inf) in
// (a), and in (b) query rows >= Sq, whose zero-filled Q scores 0 and whose P
// would be exp2(-lse), not 0.  Keys >= Skv in (b) are rows of dk and dv that
// are never stored.
//
// fp32 stays on the CUDA cores (flash_bwd_dq_kernel, flash_bwd_dkdv_kernel),
// the parity route: (a) rebuilds each row's running max
// and sum in a first walk over the key tiles, forms D and dq and writes the
// rows' statistics (2, B, H, Sq) for (b); (b) keeps K and V in shared
// memory while it walks the group's heads and their query tiles.  Every
// product there runs in fp32 from tiles converted to fp32 in shared memory
// (a 4 x 4 register tile of scores per thread, float4 reads along hd).
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
                    float scale, int causal, int window, int q_offset) {
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
  const int end = causal ? min(n_tiles, (q_offset + q0 + BT - 1) / BT + 1) : n_tiles;
  const int beg = window ? max(0, q_offset + q0 - window + 1) / BT : 0;  // the band's first tile
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  float s[4][4], dp[4][4];
  // walk 1: the rows' max and sum of exp2 of the scaled scores
  for (int t = beg; t < end; ++t) {
    __syncthreads();
    load_tile<T, HD>(Ks, k, b, t * BT, Skv, KV, kvh);
    __syncthreads();
    tile_dot<HD>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q_offset + q0 + ty * 4 + r;  // its position among the keys
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = t * BT + tx + 16 * c;
        s[r][c] = (key < Skv && (!causal || key <= row) && (!window || row - key < window))
                      ? s[r][c] * sl2 : -INFINITY;
        tmax = fmaxf(tmax, s[r][c]);
      }
      const float mn = fmaxf(m[r], group_max(tmax));
      // a row with no key yet (its band starts in a later tile) adds 0
      const float base = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += exp2f(s[r][c] - base);
      l[r] = l[r] * exp2f(m[r] - base) + group_sum(sum);
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
  for (int t = beg; t < end; ++t) {
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
        const int row = q_offset + q0 + ty * 4 + r;
        const bool valid =
            key < Skv && (!causal || key <= row) && (!window || row - key < window);
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
                      int Skv, int H, int KV, float scale, int causal, int window,
                      int q_offset) {
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

  // earlier rows see none of these keys, nor (under a window) later ones
  const int start = causal ? max(0, k0 - q_offset) / BT : 0;
  const int last = k0 + BT - 1 + window - 1 - q_offset;  // the band's last row
  const int n_tiles = window ? (last < 0 ? 0 : min((Sq + BT - 1) / BT, last / BT + 1))
                             : (Sq + BT - 1) / BT;
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
        const int rr = ty * 4 + r, row = r0 + rr, arow = q_offset + row;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + tx + 16 * c;
          const bool valid = row < Sq && key < Skv && (!causal || key <= arow) &&
                             (!window || arow - key < window);
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
               int KV, int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
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
      scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, HD>
      <<<dim3((Skv + BT - 1) / BT, KV, B), BWD_THREADS, Tl::DKV_SMEM, stream>>>(
          qt, kt, vt, dot, static_cast<T*>(dk), static_cast<T*>(dv), stats, B, Sq, Skv, H, KV,
          scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- bf16 path, wgmma
constexpr int DQ_ROWS = 128;                     // (a): query rows per block
constexpr int KT = 64;                           // keys per tile; (a)'s key tiles, (b)'s block
constexpr int QT = 64;                           // (b): query rows per item
constexpr int DQ_STAGES = 2, DKV_STAGES = 4;     // (b): two stages per consumer warpgroup
constexpr int DQ_THREADS = 2 * 128 + 32;         // two consumer warpgroups, a producer warp
constexpr int DKV_THREADS = 3 * 128;             // two consumer warpgroups, a producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 168 * DKV_THREADS,
              "setmaxnreg must stay within the registers the block was launched with");

// 2^x, flushing results below 2^-126 to 0 (P is a probability: nothing
// below that range matters); exp2f's range handling took about a fifth of
// both kernels' time on an H100 (chip_smoke's K2-backward shapes)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct WgTiles {
  static constexpr int ATOMS = HD / 64;         // 64-wide column blocks of hd
  static constexpr int ATOM64 = 64 * 128;       // one block of a 64-row tile, in bytes
  static constexpr int ATOM128 = 128 * 128;     // of a 128-row tile
  static constexpr int T64 = ATOMS * ATOM64;
  static constexpr int T128 = ATOMS * ATOM128;
  // (a): Q and dO of 128 rows, the ring of K and V tiles, D of the rows
  static constexpr int DQ_STAGE = 2 * T64;
  static constexpr int DQ_SMEM =
      2 * T128 + DQ_STAGES * DQ_STAGE + DQ_ROWS * 4 + (1 + 2 * DQ_STAGES) * 8 + 1024;
  // (b): K and V of 64 keys, the ring of Q, dO, lse and D of 64 query rows
  static constexpr int VEC = QT * 4;            // lse, then D: one TMA box each
  static constexpr int DKV_STAGE = (2 * T64 + 2 * VEC + 1023) / 1024 * 1024;
  static constexpr int DKV_SMEM = 2 * T64 + DKV_STAGES * DKV_STAGE + (1 + 2 * DKV_STAGES) * 8 + 1024;
  static_assert(DKV_STAGES * DKV_STAGE >= 2 * 64 * HD * 4,
                "the ring holds the second warpgroup's dK and dV at the end");
  static_assert(DKV_SMEM <= 232448 && DQ_SMEM <= 232448,
                "more shared memory than a block may have");
};

// A's k16 step kk of a K-major 64-row slice (rows of 128 bytes, 64-column
// blocks `atom` bytes apart), and the MN-major B of k16 step c of a 64-row
// tile whose 64-column blocks are 64 * 128 bytes apart.
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int atom, int kk) {
  return hopper::make_desc(tile + (kk / 4) * atom + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int c) {
  return hopper::make_desc(tile + c * 2048, 64 * 128, 1024);
}

// acc (+)= A(64 x 64 of k, registers: four k16 steps of bf16 pairs) B, B the
// MN-major 64-row tile: N = HD.
template <int HD>
__device__ __forceinline__ void rs_product(float (&acc)[HD / 2], const uint32_t (&a)[16],
                                           const unsigned char* b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t a4[4] = {a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3]};
    if constexpr (HD == 64) hopper::wgmma_rs_n64<1>(acc, a4, mnmajor(b, c), 1);
    else hopper::wgmma_rs_n128<1>(acc, a4, mnmajor(b, c), 1);
  }
}

// d (=) A B^T over hd, both 64-row K-major tiles (A's column blocks a_atom
// bytes apart, B's 64 * 128): m64n64, HD / 16 k16 steps.
template <int HD>
__device__ __forceinline__ void ss_product(float (&d)[32], const unsigned char* a, int a_atom,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hopper::wgmma_ss_n64<0>(d, kmajor(a, a_atom, kk), kmajor(b, 64 * 128, kk), kk > 0);
}

// The bf16 A fragments (four k16 steps) of a 64 x 64 accumulator: a product
// over its columns takes them from registers.
__device__ __forceinline__ void to_a_fragments(uint32_t (&a)[16], const float (&d)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      a[4 * (j / 2) + 2 * (j % 2) + hh] = hopper::pack_bf16(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// rows row_a, row_a + 8 of head h of a (B, S, NH, HD) bf16 tensor from an
// m64nHD accumulator, times mul; rows >= S are not stored
template <int HD>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ dst, const float (&acc)[HD / 2],
                                          float mul, int b, int row_a, int S, int NH, int h,
                                          int lane) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_a + 8 * hh;
    if (row >= S) continue;
    __nv_bfloat16* out = dst + (((size_t)b * S + row) * NH + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * mul, acc[4 * j + 2 * hh + 1] * mul);
  }
}

template <int HD, bool BAND>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ dstat, int ld, __nv_bfloat16* __restrict__ dq,
                          int Sq, int Skv, int H, int KV, float scale_log2, float scale,
                          int causal, int window, int q_offset) {
  using namespace hopper;
  using T = WgTiles<HD>;
  if (!BAND) window = 0;  // folds the band's code away: the causal kernel keeps its registers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* dos = smem + T::T128;
  unsigned char* kvs = smem + 2 * T::T128;  // stage s: K at s * DQ_STAGE, V after it
  float* Ds = reinterpret_cast<float*>(kvs + DQ_STAGES * T::DQ_STAGE);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Ds + DQ_ROWS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_ROWS;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int a0 = q_offset + q0;  // the block's first row's position among the keys
  const int ntiles = ((causal ? min(Skv, a0 + DQ_ROWS) : Skv) + KT - 1) / KT;
  const int t_lo = window ? max(0, a0 - window + 1) / KT : 0;  // the band's first tile
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {  // producer warp: one thread issues every load
    if (threadIdx.x == 2 * 128) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&domap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_arrive_expect_tx(qbar, 2 * T::T128);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a) {
        tma_load_4d(qs + a * T::ATOM128, &qmap, qbar, 64 * a, h, q0, b);
        tma_load_4d(dos + a * T::ATOM128, &domap, qbar, 64 * a, h, q0, b);
      }
      for (int t = t_lo; t < ntiles; ++t) {
        const int n = t - t_lo, s = n % DQ_STAGES;  // n: the block's n-th tile
        if (n >= DQ_STAGES) mbar_wait(&empty[s], ((n / DQ_STAGES) + 1) & 1);
        unsigned char* ks = kvs + s * T::DQ_STAGE;
        mbar_arrive_expect_tx(&full[s], T::DQ_STAGE);
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load_4d(ks + a * T::ATOM64, &kmap, &full[s], 64 * a, kvh, t * KT, b);
          tma_load_4d(ks + T::T64 + a * T::ATOM64, &vmap, &full[s], 64 * a, kvh, t * KT, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wgi: query rows r0 .. r0 + 63
  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int r0 = q0 + wgi * 64, ar0 = q_offset + r0;  // ar0: r0's position among the keys
  const int my_tiles = ((causal ? min(Skv, ar0 + 64) : Skv) + KT - 1) / KT;
  const int my_lo = window ? max(0, ar0 - window + 1) / KT : 0;
  const int row_a = r0 + warp * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
  const size_t bh = (size_t)b * H + h;
  {  // D of the warpgroup's rows, two threads a row, 16-byte loads of dO and o
    const int row = r0 + tid / 2;
    float acc = 0.f;
    if (row < Sq) {
      const size_t base = (((size_t)b * Sq + row) * H + h) * HD + (tid % 2) * (HD / 2);
      const uint4* d4 = reinterpret_cast<const uint4*>(dout + base);
      const uint4* o4 = reinterpret_cast<const uint4*>(o + base);
#pragma unroll
      for (int i = 0; i < HD / 16; ++i) {
        const uint4 x = d4[i], y = o4[i];
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xp[e]), yf = __bfloat1622float2(yp[e]);
          acc += xf.x * yf.x + xf.y * yf.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) {
      Ds[wgi * 64 + tid / 2] = acc;
      if (row < Sq) dstat[bh * ld + row] = acc;
    }
  }
  named_bar_sync(1 + wgi, 128);
  float dr[2], lr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_a + 8 * hh;
    dr[hh] = Ds[row - q0];
    lr[hh] = row < Sq ? lse[bh * ld + row] : 0.f;
  }

  const unsigned char* qw = qs + wgi * 64 * 128;
  const unsigned char* dow = dos + wgi * 64 * 128;
  float acc[HD / 2];  // dQ: acc[4 j + 2 hh + e] = dQ[row_a + 8 hh][8 j + 2 (lane % 4) + e]
  zero(acc);
  mbar_wait(qbar, 0);
  for (int t = t_lo; t < ntiles; ++t) {
    const int n = t - t_lo, s = n % DQ_STAGES;
    mbar_wait(&full[s], (n / DQ_STAGES) & 1);
    if (t >= my_lo && t < my_tiles) {
      const unsigned char* ks = kvs + s * T::DQ_STAGE;
      const unsigned char* vs = ks + T::T64;
      float sc[32], dp[32];
      zero(sc);
      zero(dp);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      ss_product<HD>(sc, qw, T::ATOM128, ks);  // S = Q K^T
      wgmma_commit();
      ss_product<HD>(dp, dow, T::ATOM128, vs);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      const int k0 = t * KT;
      const bool edge = (causal && k0 + KT > ar0) || k0 + KT > Skv ||
                        (window && k0 < ar0 + 64 - window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const int key = k0 + 8 * j + 2 * (lane % 4) + e, row = q_offset + row_a + 8 * hh;
            const bool valid = !edge || (key < Skv && (!causal || key <= row) &&
                                         (!window || row - key < window));
            sc[i] = valid ? ex2(sc[i] * scale_log2 - lr[hh]) : 0.f;  // P
          }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dr[(i / 2) % 2]);  // dS
      uint32_t da[16];
      to_a_fragments(da, dp);
      fence_regs(acc);
      wgmma_fence();
      rs_product<HD>(acc, da, ks);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_acc<HD>(dq, acc, scale, b, row_a, Sq, H, h, lane);
}

template <int HD, bool BAND>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap domap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap lmap,
                            const __grid_constant__ CUtensorMap dmap,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int Sq, int Skv, int H, int KV, float scale_log2, float scale,
                            int causal, int window, int q_offset) {
  using namespace hopper;
  using T = WgTiles<HD>;
  if (!BAND) window = 0;  // folds the band's code away: the causal kernel keeps its registers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = smem;
  unsigned char* vs = smem + T::T64;
  unsigned char* ring = smem + 2 * T::T64;  // stage s: Q, dO, lse, D at s * DKV_STAGE
  uint64_t* kbar = reinterpret_cast<uint64_t*>(ring + DKV_STAGES * T::DKV_STAGE);
  uint64_t* full = kbar + 1;
  uint64_t* empty = full + DKV_STAGES;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;  // causal: longest first
  const int k0 = kt * KT, G = H / KV;
  // earlier query tiles see none of these keys
  const int start = causal ? max(0, k0 - q_offset) / QT : 0;
  // nor, under a window, those past the tile of the last key's last query row
  const int last = k0 + KT - 1 + window - 1 - q_offset;
  const int end = window ? (last < 0 ? 0 : min((Sq + QT - 1) / QT, last / QT + 1))
                         : (Sq + QT - 1) / QT;
  const int per_head = max(0, end - start);
  const int items = G * per_head;  // item n: head kvh G + n / per_head, tile start + n % per_head
  if (threadIdx.x == 0) {
    mbar_init(kbar, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the warps of the one warpgroup that takes the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * 128) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&domap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      tma_prefetch_map(&lmap);
      tma_prefetch_map(&dmap);
      mbar_arrive_expect_tx(kbar, 2 * T::T64);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a) {
        tma_load_4d(ks + a * T::ATOM64, &kmap, kbar, 64 * a, kvh, k0, b);
        tma_load_4d(vs + a * T::ATOM64, &vmap, kbar, 64 * a, kvh, k0, b);
      }
      for (int n = 0; n < items; ++n) {
        const int s = n % DKV_STAGES;
        if (n >= DKV_STAGES) mbar_wait(&empty[s], ((n / DKV_STAGES) + 1) & 1);
        const int h = kvh * G + n / per_head, q0 = (start + n % per_head) * QT;
        unsigned char* st = ring + s * T::DKV_STAGE;
        mbar_arrive_expect_tx(&full[s], 2 * T::T64 + 2 * T::VEC);
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load_4d(st + a * T::ATOM64, &qmap, &full[s], 64 * a, h, q0, b);
          tma_load_4d(st + T::T64 + a * T::ATOM64, &domap, &full[s], 64 * a, h, q0, b);
        }
        tma_load_2d(st + 2 * T::T64, &lmap, &full[s], q0, b * H + h);
        tma_load_2d(st + 2 * T::T64 + T::VEC, &dmap, &full[s], q0, b * H + h);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  // consumer warpgroup wg takes items wg, wg + 2, ...: stages wg and wg + 2
  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int key_a = k0 + warp * 16 + lane / 4;  // this thread's keys: key_a, key_a + 8
  float dka[HD / 2], dva[HD / 2];  // dK, dV: [4 j + 2 hh + e] = [key_a + 8 hh][8 j + 2 (lane % 4) + e]
  zero(dka);
  zero(dva);
  mbar_wait(kbar, 0);
  for (int n = wg; n < items; n += 2) {
    const int s = n % DKV_STAGES;
    const int qt = start + n % per_head, q0 = qt * QT;
    const unsigned char* qs = ring + s * T::DKV_STAGE;
    const unsigned char* dos = qs + T::T64;
    const float* ls = reinterpret_cast<const float*>(qs + 2 * T::T64);
    const float* Dv = ls + QT;
    mbar_wait(&full[s], (n / DKV_STAGES) & 1);
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    ss_product<HD>(st, ks, T::ATOM64, qs);  // S^T = K Q^T
    wgmma_commit();
    ss_product<HD>(dpt, vs, T::ATOM64, dos);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    const bool edge = (causal && k0 + KT - 1 > q_offset + q0) || q0 + QT > Sq ||
                      (window && q_offset + q0 + QT - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e, col = 8 * j + 2 * (lane % 4) + e;
          const int query = q0 + col, key = key_a + 8 * hh, aq = q_offset + query;
          const bool valid = !edge || (query < Sq && (!causal || key <= aq) &&
                                       (!window || aq - key < window));
          st[i] = valid ? ex2(st[i] * scale_log2 - ls[col]) : 0.f;  // P^T
        }
    uint32_t pa[16];
    to_a_fragments(pa, st);
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i)  // dS^T, D along the columns
      dpt[i] = st[i] * (dpt[i] - Dv[8 * (i / 4) + 2 * (lane % 4) + i % 2]);
    uint32_t da[16];
    to_a_fragments(da, dpt);
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    rs_product<HD>(dva, pa, dos);  // dV += P^T dO
    rs_product<HD>(dka, da, qs);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // the group's sum: the second warpgroup's dK and dV through the ring
  // (every load has landed and been read), added to the first's in that order
  float* red = reinterpret_cast<float*>(ring);
  named_bar_sync(1, 256);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      red[i * 128 + tid] = dka[i];
      red[(HD / 2 + i) * 128 + tid] = dva[i];
    }
  }
  named_bar_sync(1, 256);
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    dka[i] += red[i * 128 + tid];
    dva[i] += red[(HD / 2 + i) * 128 + tid];
  }
  store_acc<HD>(dk, dka, scale, b, key_a, Skv, KV, kvh, lane);
  store_acc<HD>(dv, dva, 1.f, b, key_a, Skv, KV, kvh, lane);
}

template <int HD, bool BAND>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, int ld, void* dq, void* dk, void* dv,
                     float* dstat, int B, int Sq, int Skv, int H, int KV, int causal,
                     int window, int q_offset, float scale, cudaStream_t stream) {
  using T = WgTiles<HD>;
  static hopper::SmemRaised raised_dq, raised_dkdv;
  CUtensorMap q128, do128, q64, do64, kmap, vmap, lmap, dmap;
  const uint64_t qdims[4] = {HD, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t qstr[3] = {HD * 2, (uint64_t)H * HD * 2, (uint64_t)Sq * H * HD * 2};
  const uint32_t box128[4] = {64, 1, DQ_ROWS, 1}, box64[4] = {64, 1, 64, 1};
  const uint64_t kdims[4] = {HD, (uint64_t)KV, (uint64_t)Skv, (uint64_t)B};
  const uint64_t kstr[3] = {HD * 2, (uint64_t)KV * HD * 2, (uint64_t)Skv * KV * HD * 2};
  // lse and D: rows of Sq floats, ld apart; a box of 64 (zeros past Sq)
  const uint64_t sdims[2] = {(uint64_t)Sq, (uint64_t)B * H}, sstr[1] = {(uint64_t)ld * 4};
  const uint32_t sbox[2] = {QT, 1};
  if (!hopper::make_map_bf16(&q128, q, 4, qdims, qstr, box128) ||
      !hopper::make_map_bf16(&do128, dout, 4, qdims, qstr, box128) ||
      !hopper::make_map_bf16(&q64, q, 4, qdims, qstr, box64) ||
      !hopper::make_map_bf16(&do64, dout, 4, qdims, qstr, box64) ||
      !hopper::make_map_bf16(&kmap, k, 4, kdims, kstr, box64) ||
      !hopper::make_map_bf16(&vmap, v, 4, kdims, kstr, box64) ||
      !hopper::make_map(&lmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lse, 2, sdims, sstr, sbox,
                        CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper::make_map(&dmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dstat, 2, sdims, sstr, sbox,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      hopper::allow_smem(flash_bwd_dq_wgmma_kernel<HD, BAND>, T::DQ_SMEM, raised_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hopper::allow_smem(flash_bwd_dkdv_wgmma_kernel<HD, BAND>, T::DKV_SMEM, raised_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float sl2 = scale * LOG2E;
  flash_bwd_dq_wgmma_kernel<HD, BAND>
      <<<dim3((Sq + DQ_ROWS - 1) / DQ_ROWS, H, B), DQ_THREADS, T::DQ_SMEM, stream>>>(
          q128, do128, kmap, vmap, static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(dout), lse, dstat, ld,
          static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, KV, sl2, scale, causal, window,
          q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_wgmma_kernel<HD, BAND>
      <<<dim3((Skv + KT - 1) / KT, KV, B), DKV_THREADS, T::DKV_SMEM, stream>>>(
          q64, do64, kmap, vmap, lmap, dmap, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, KV, sl2, scale, causal, window,
          q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; hd: 64 or 128; window: 0 (none) or w > 0 with
// causal; q_offset >= 0, with q_offset + Sq <= Skv causal, 0 not causal.  lse: the forward's rows'
// log2-sum-exp2 (of the band under a window), fp32 (B, H, ld), ld >= Sq a
// multiple of 4 (16-byte rows for TMA), read by the bf16 kernels; the fp32
// kernels rebuild it.  stats: fp32 scratch, bf16: D (B, H, ld); fp32: the
// rows' statistics (2, B, H, Sq).  bf16 tensors must be 16-byte aligned
// (TMA).  Returns the cudaError_t of the launches, or cudaErrorInvalidValue
// for what the kernels do not take.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* dk,
                                   void* dv, void* stats, int B, int Sq, int Skv, int H, int KV,
                                   int hd, int causal, int window, int q_offset, int ld,
                                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  const float* ls = static_cast<const float*>(lse);
  if ((causal && q_offset + Sq > Skv) || q_offset < 0 || (q_offset && !causal) || Sq < 1 ||
      Skv < 1 || KV < 1 || H % KV || ld < Sq || ld % 4 || window < 0 || (window && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
#define BWD_WG_ARGS \
  q, k, v, o, dout, ls, ld, dq, dk, dv, st, B, Sq, Skv, H, KV, causal, window, q_offset, scale, s
  if (dtype == 1 && hd == 64)
    return window ? launch_bwd_wgmma<64, true>(BWD_WG_ARGS)
                  : launch_bwd_wgmma<64, false>(BWD_WG_ARGS);
  if (dtype == 1 && hd == 128)
    return window ? launch_bwd_wgmma<128, true>(BWD_WG_ARGS)
                  : launch_bwd_wgmma<128, false>(BWD_WG_ARGS);
#undef BWD_WG_ARGS
  if (dtype == 0 && hd == 64)
    return launch_bwd<float, 64>(q, k, v, o, dout, dq, dk, dv, st, B, Sq, Skv, H, KV, causal,
                                 window, q_offset, scale, s);
  if (dtype == 0 && hd == 128)
    return launch_bwd<float, 128>(q, k, v, o, dout, dq, dk, dv, st, B, Sq, Skv, H, KV, causal,
                                  window, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
