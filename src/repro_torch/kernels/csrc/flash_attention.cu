// flash_attention: causal (or full) softmax(q k^T / sqrt(hd)) v for prefill,
// with grouped-query heads read in place, and a sliding-window band: with
// window w > 0 (causal only) query row r attends keys r - w < j <= r.  Not
// causal, the Skv keys may be more or fewer than the Sq queries (a
// cross-attention); causal, the Sq queries sit at positions q_offset ..
// q_offset + Sq - 1 of the Skv >= q_offset + Sq keys (q_offset 0 and Sq = Skv
// for a whole sequence; a query shard of a sequence-sharded attention, which
// attends the keys of every shard, otherwise).
//
// Replaces the TPU kernel kernels/flash_attention.py:flash_attention
// (_flash_kernel) of the JAX package.
//
// Layout: q and out (B, Sq, H, hd), k and v (B, Skv, KV, hd), all contiguous;
// query head h reads KV head h / (H / KV), so no broadcast copy of the KV
// heads is made.  Key positions start at 0, query row r sits at q_offset + r:
// causal, it attends keys j <= q_offset + r, and under a window also j >
// q_offset + r - w.  The band is the mask of the JAX package's
// models/attention.py:_banded_attention; the offset is its q_positions of a
// sequence shard (_flash_full's seq mode).
//
// What bounds it on an H100: at prefill lengths (S = 512, hd = 64) each
// (q, kv) pair costs 4*hd operations on 4*hd bytes of tile traffic that stays
// in shared memory, so it is bound by tensor-core operations, and only wgmma
// reaches their full rate.
//
// What the design does about it (bf16, flash_wgmma_kernel, close to
// FlashAttention-3's forward without fp8): one block per (q tile of 128
// rows, q head, batch row), the longest causal tiles launched first.  A
// producer warp loads the q tile once by TMA and streams 64-key K and V
// tiles through a ring of F_STAGES shared-memory stages (4D tensor maps
// over the tensors in place, 128-byte swizzle, a full and an empty mbarrier
// per stage).  Two consumer warpgroups own 64 query rows each: S = Q K^T by
// wgmma m64n64k16 with both operands K-major in shared memory; the online
// softmax runs in fp32 on the accumulator fragments (a row's max and sum
// across the four threads that hold it by two shuffles, exp2 with
// log2(e)/sqrt(hd) folded into the scale); P is rounded to bf16 in registers
// and fed back as wgmma's register A operand against V, an MN-major B
// operand in shared memory.  Causal blocks stop the key loop at the
// diagonal, and a warpgroup skips the tiles above its own; only the diagonal
// tile and the tile holding key Skv-1 are masked (TMA zero-fills keys beyond
// Skv, which would score 0, not -inf).  Query rows beyond Sq are not stored.
// Under a window the key loop of a block (and the producer's loads) starts
// at the tile holding key q0 - w + 1, and a warpgroup skips the tiles below
// its own band's first: a block visits at most (128 + w) / 64 + 1 tiles
// whatever S is, and the tiles that cross the band's low edge are masked as
// the diagonal one is.  A row whose first visited tiles lie wholly below its
// band keeps the running max at -1e30 there; its first key inside the band
// rescales what those tiles summed by exp2(-1e30 - m) = 0.  The band is a
// template flag of the bf16 kernel (BAND), so the causal kernel is built
// without its code and keeps its registers.
// fp32 (flash_kernel) stays on the CUDA cores: two threads share one query
// row and walk K/V in 32-key tiles; it exists for parity runs.
// Under grad the forward also writes each row's log2-sum-exp2 of the scaled
// scores, fp32 (B, H, lse_ld), for the backward kernels
// (flash_attention_bwd.cu): a template flag (LSE) of both kernels, from the
// row max and sum they already hold at the end, so the serving kernels are
// built without it and keep their registers.  Under a window (BAND and LSE
// together) the sum holds the band's keys only: the tiles wholly below a
// row's band summed exp2(0) per key at a running max of -1e30, and its first
// key inside the band rescaled that sum by exp2(-1e30 - m) = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int FQ = 64;            // query rows per block
constexpr int FK = 32;            // keys per shared-memory tile
constexpr int THREADS = 2 * FQ;   // two threads per query row

template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
             int lse_ld, int Sq, int Skv, int H, int KV, float scale, int causal,
             int window, int q_offset) {
  constexpr int NP = HD / 4;  // float2 pairs per thread: dims 4i + 2*half + {0,1}
  __shared__ __align__(16) float Ks[FK][HD];
  __shared__ __align__(16) float Vs[FK][HD];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const int kvh = h / (H / KV);
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qpos = q0 + row;
  const int apos = q_offset + qpos;  // the row's position among the keys
  const bool valid = qpos < Sq;

  float qr[2 * NP], acc[2 * NP];
  const size_t qoff = (((size_t)b * Sq + qpos) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      qr[2 * i + e] = valid ? to_float(q[qoff + 4 * i + 2 * half + e]) : 0.f;
      acc[2 * i + e] = 0.f;
    }
  float m = NEG_INF, l = 0.f;

  const int kend = causal ? min(Skv, q_offset + q0 + FQ) : Skv;
  const int kbeg = window ? max(0, q_offset + q0 - window + 1) / FK * FK : 0;
  for (int k0 = kbeg; k0 < kend; k0 += FK) {
    for (int i = threadIdx.x; i < FK * HD; i += THREADS) {
      const int r = i / HD, c = i % HD;
      const int gk = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (gk < Skv) {
        const size_t off = (((size_t)b * Skv + gk) * KV + kvh) * HD + c;
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
      if (gk >= Skv || (causal && gk > apos) || (window && gk <= apos - window)) sj = NEG_INF;
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
    if (LSE && half == 0)
      lse[((size_t)b * H + h) * lse_ld + qpos] = (m + logf(l)) * 1.4426950408889634f;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[qoff + 4 * i + 2 * half + e] = from_float<T>(acc[2 * i + e] * inv);
  }
}

template <typename T, int HD, bool LSE>
void launch(const void* q, const void* k, const void* v, void* out, float* lse, int lse_ld,
            int B, int Sq, int Skv, int H, int KV, int causal, int window, int q_offset,
            float scale, cudaStream_t s) {
  const dim3 grid((Sq + FQ - 1) / FQ, H, B);
  flash_kernel<T, HD, LSE><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, lse_ld, Sq, Skv, H, KV, scale, causal, window, q_offset);
}

// ------------------------------------------------------- bf16 path, wgmma
constexpr int F_BQ = 128, F_BKV = 64, F_STAGES = 2, F_CONSUMERS = 2;
constexpr int F_THREADS = F_CONSUMERS * 128 + 32;  // and one producer warp

template <int HD>
struct FlashTiles {
  static constexpr int ATOMS = HD / 64;           // 64-wide column blocks of hd
  static constexpr int Q_ATOM = F_BQ * 128;       // bytes of one block of the q tile
  static constexpr int KV_ATOM = F_BKV * 128;
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;
  static constexpr int STAGE = 2 * KV_BYTES;      // K then V
  static constexpr int SMEM = Q_BYTES + F_STAGES * STAGE + (1 + 2 * F_STAGES) * 8 + 1024;
};

template <int HD, bool BAND, bool LSE>
__global__ void __launch_bounds__(F_THREADS, HD == 64 ? 2 : 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int lse_ld,
                   int Sq, int Skv, int H, int KV, float scale_log2, int causal, int window,
                   int q_offset) {
  using namespace hopper;
  using T = FlashTiles<HD>;
  if (!BAND) window = 0;  // folds the band's code away: the causal kernel keeps its registers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* kvs = smem + T::Q_BYTES;  // stage s: K at s * STAGE, V after it
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kvs + F_STAGES * T::STAGE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + F_STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * F_BQ;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int a0 = q_offset + q0;  // the block's first row's position among the keys
  const int kv_end = causal ? min(Skv, a0 + F_BQ) : Skv;
  const int ntiles = (kv_end + F_BKV - 1) / F_BKV;
  const int t_lo = window ? max(0, a0 - window + 1) / F_BKV : 0;  // the band's first tile
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F_CONSUMERS * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == F_CONSUMERS) {  // producer warp: one thread issues every load
    if (threadIdx.x == F_CONSUMERS * 128) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_arrive_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a)
        tma_load_4d(qs + a * T::Q_ATOM, &qmap, qbar, 64 * a, h, q0, b);
      for (int t = t_lo; t < ntiles; ++t) {
        const int n = t - t_lo, s = n % F_STAGES;  // n: the block's n-th tile
        if (n >= F_STAGES) mbar_wait(&empty[s], ((n / F_STAGES) + 1) & 1);
        unsigned char* ks = kvs + s * T::STAGE;
        mbar_arrive_expect_tx(&full[s], T::STAGE);
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load_4d(ks + a * T::KV_ATOM, &kmap, &full[s], 64 * a, kvh, t * F_BKV, b);
          tma_load_4d(ks + T::KV_BYTES + a * T::KV_ATOM, &vmap, &full[s], 64 * a, kvh,
                      t * F_BKV, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wgi: query rows r0 .. r0 + 63
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r0 = q0 + wgi * 64, ar0 = q_offset + r0;  // ar0: r0's position among the keys
  const int my_tiles = ((causal ? min(Skv, ar0 + 64) : Skv) + F_BKV - 1) / F_BKV;
  const int my_lo = window ? max(0, ar0 - window + 1) / F_BKV : 0;
  const int row_a = r0 + warp * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
  const unsigned char* qw = qs + wgi * 64 * 128;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int t = t_lo; t < ntiles; ++t) {
    const int n = t - t_lo, s = n % F_STAGES;
    mbar_wait(&full[s], (n / F_STAGES) & 1);
    if (t >= my_lo && t < my_tiles) {
      const unsigned char* ks = kvs + s * T::STAGE;
      const unsigned char* vs = ks + T::KV_BYTES;
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da = make_desc(qw + (kk / 4) * T::Q_ATOM + (kk % 4) * 32, 16, 1024);
        const uint64_t db = make_desc(ks + (kk / 4) * T::KV_ATOM + (kk % 4) * 32, 16, 1024);
        wgmma_ss_n64<0>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const int k0 = t * F_BKV;
      const bool edge = (causal && k0 + F_BKV > ar0) || k0 + F_BKV > Skv ||
                        (window && k0 < ar0 + 64 - window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = sc[4 * j + 2 * hh + e] * scale_log2;
            if (edge) {
              const int key = k0 + 8 * j + 2 * (lane % 4) + e;
              const int row = q_offset + row_a + 8 * hh;
              if (key >= Skv || (causal && key > row) || (window && key <= row - window))
                v = NEG_INF;
            }
            sc[4 * j + 2 * hh + e] = v;
            mx[hh] = fmaxf(mx[hh], v);
          }
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float mn = fmaxf(m[hh], mx[hh]);
        corr[hh] = exp2f(m[hh] - mn);
        m[hh] = mn;
        l[hh] *= corr[hh];
      }
      uint32_t pa[16];  // P as wgmma's A fragments, four k16 steps of keys
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float p0 = exp2f(sc[4 * j + 2 * hh] - m[hh]);
          const float p1 = exp2f(sc[4 * j + 2 * hh + 1] - m[hh]);
          l[hh] += p0 + p1;
          pa[4 * (j / 2) + 2 * (j % 2) + hh] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[4 * j + i] *= corr[i / 2];
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t a4[4] = {pa[4 * c], pa[4 * c + 1], pa[4 * c + 2], pa[4 * c + 3]};
        const uint64_t db = make_desc(vs + c * 2048, T::KV_ATOM, 1024);
        if constexpr (HD == 64) wgmma_rs_n64<1>(o, a4, db, 1);
        else wgmma_rs_n128<1>(o, a4, db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_a + 8 * hh;
    if (row >= Sq) continue;
    if (LSE && lane % 4 == 0) lse[((size_t)b * H + h) * lse_ld + row] = m[hh] + log2f(l[hh]);
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
  }
}

template <int HD, bool BAND, bool LSE>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                 int lse_ld, int B, int Sq, int Skv, int H, int KV, int causal, int window,
                 int q_offset, float scale, cudaStream_t stream) {
  using T = FlashTiles<HD>;
  static hopper::SmemRaised raised;
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[4] = {HD, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t qstr[3] = {HD * 2, (uint64_t)H * HD * 2, (uint64_t)Sq * H * HD * 2};
  const uint32_t qbox[4] = {64, 1, F_BQ, 1};
  const uint64_t kdims[4] = {HD, (uint64_t)KV, (uint64_t)Skv, (uint64_t)B};
  const uint64_t kstr[3] = {HD * 2, (uint64_t)KV * HD * 2, (uint64_t)Skv * KV * HD * 2};
  const uint32_t kbox[4] = {64, 1, F_BKV, 1};
  if (!hopper::make_map_bf16(&qmap, q, 4, qdims, qstr, qbox) ||
      !hopper::make_map_bf16(&kmap, k, 4, kdims, kstr, kbox) ||
      !hopper::make_map_bf16(&vmap, v, 4, kdims, kstr, kbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      hopper::allow_smem(flash_wgmma_kernel<HD, BAND, LSE>, T::SMEM, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + F_BQ - 1) / F_BQ, H, B);
  flash_wgmma_kernel<HD, BAND, LSE><<<grid, F_THREADS, T::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), lse, lse_ld, Sq, Skv, H, KV,
      scale * 1.4426950408889634f, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; hd: 64 or 128; window: 0 (none) or w > 0 with
// causal; q_offset >= 0, with q_offset + Sq <= Skv causal, 0 not causal
// (every key attended); Skv >= 1.  lse: null, or fp32 (B, H,
// lse_ld), lse_ld >= Sq, for each row's log2-sum-exp2 (of its band under a
// window).  bf16
// tensors must be 16-byte aligned (TMA).  Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue for what the kernels do not take.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int Sq, int Skv, int H,
                               int KV, int hd, int causal, int window, int q_offset,
                               int lse_ld, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (window < 0 || (window && !causal) || q_offset < 0 || (q_offset && !causal) ||
      (causal && q_offset + Sq > Skv) || Skv < 1 || (ls && lse_ld < Sq))
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_ARGS q, k, v, out, ls, lse_ld, B, Sq, Skv, H, KV, causal
  if (dtype == 1 && hd == 64)
    return window ? (ls ? launch_wgmma<64, true, true>(FLASH_ARGS, window, q_offset, scale, s)
                        : launch_wgmma<64, true, false>(FLASH_ARGS, window, q_offset, scale, s))
           : ls   ? launch_wgmma<64, false, true>(FLASH_ARGS, 0, q_offset, scale, s)
                  : launch_wgmma<64, false, false>(FLASH_ARGS, 0, q_offset, scale, s);
  if (dtype == 1 && hd == 128)
    return window ? (ls ? launch_wgmma<128, true, true>(FLASH_ARGS, window, q_offset, scale, s)
                        : launch_wgmma<128, true, false>(FLASH_ARGS, window, q_offset, scale, s))
           : ls   ? launch_wgmma<128, false, true>(FLASH_ARGS, 0, q_offset, scale, s)
                  : launch_wgmma<128, false, false>(FLASH_ARGS, 0, q_offset, scale, s);
  if (dtype == 0 && hd == 64) {
    if (ls) launch<float, 64, true>(FLASH_ARGS, window, q_offset, scale, s);
    else launch<float, 64, false>(FLASH_ARGS, window, q_offset, scale, s);
  } else if (dtype == 0 && hd == 128) {
    if (ls) launch<float, 128, true>(FLASH_ARGS, window, q_offset, scale, s);
    else launch<float, 128, false>(FLASH_ARGS, window, q_offset, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_ARGS
  return static_cast<int>(cudaGetLastError());
}
