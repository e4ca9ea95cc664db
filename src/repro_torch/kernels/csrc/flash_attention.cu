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
// What bounds it on an H100: each attended (q, kv) pair costs 4 hd
// tensor-core operations (S = Q K^T and P V) on tiles that stay in shared
// memory, so at prefill lengths it is bound by tensor operations, and only
// wgmma reaches their full rate.  Each pair also costs one exp2 on the MUFU,
// 16 a clock an SM: at hd 64 that is the tensor cores' own rate per pair
// (4096 operations a clock an SM over 256), at hd 128 half of it.  A kernel
// that runs the softmax and the products in turn pays for both.
//
// What the design does about it (bf16, flash_wgmma_kernel, after
// FlashAttention-3's forward without fp8): one block per (head, batch row, q
// tile of 128 rows), causal q tiles longest first across every head, not
// causal a head's q tiles together (so that they share its K and V in L2).
// The block is two warpgroups and no producer warp: a ninth warp would hold
// every thread to 168 registers, and a producer warpgroup that hands its
// registers over by setmaxnreg leaves ptxas at 168 all the same (hd 128
// spilled).  The second warpgroup's first thread loads the q tile once by
// TMA and streams K and V tiles of KN keys through a ring of STAGES (4D
// tensor maps over the tensors in place, 128-byte swizzle, a full and an
// empty mbarrier per stage); it refills a stage after a release of its own
// where both warpgroups are done with it (mbarrier.test_wait: try_wait would
// hold it, and its warpgroup, for a while when the answer is no), and waits
// only for a tile it needs itself.  Each warpgroup owns 64 query rows and
// walks every key tile of the block (those past its rows or below its band
// masked whole), pipelined: S = Q K^T of tile t (wgmma m64nKN, both operands
// K-major in shared memory) and O += P V of tile t - 1 (P from registers as
// wgmma's A operand, V an MN-major B) are issued together, and the softmax
// of tile t runs while P V is still on the tensor cores; O is rescaled once
// P V has landed.  Tiles are 128 keys at hd 128, one block an SM, where the
// two warpgroups issue their products in turn (named barriers, ping-pong),
// so that one's products run while the other's softmax runs; and 64 keys at
// hd 64, where S, P and O then fit the 128 registers a thread of two blocks
// an SM may have, and the four warpgroups of the two blocks run one
// another's products during a softmax (and hide one another's loads,
// prologue and epilogue).  At hd 64, 128-key tiles fit 128 registers only
// with spills or serialized wgmma, and at one block an SM they were slower
// at the 512-token causal prefills (PERF.md §6).  The softmax keeps the
// running max, the sum and O in fp32: a row's max and sum in four partials
// a thread and across the four threads that hold it by two shuffles, P =
// exp2(S scale log2(e) - m) by one FFMA ahead of each exp2, P rounded to
// bf16 once.  Only the tiles that cross the diagonal, the band's low edge
// or key Skv - 1 take the mask, which scores the keys a row does not attend
// -inf (TMA zero-fills keys beyond Skv, which would score 0).  Under a
// window the key loop of a block (and its loads) starts at the tile holding
// key q0 - w + 1: a block visits at most (128 + w) / KN + 1 tiles whatever
// S is.  The band is a template flag (BAND), so
// the causal kernel is built without its code.  At the end each warpgroup
// writes its O, normalised and rounded once to bf16, over its own rows of
// the q tile (which no product reads any more) and stores them by TMA, one
// store a column block: rows past Sq are not written.
// fp32 (flash_kernel) stays on the CUDA cores: two threads share one query
// row and walk K/V in 32-key tiles; it exists for parity runs.
// Under grad the forward also writes each row's log2-sum-exp2 of the scaled
// scores, fp32 (B, H, lse_ld), for the backward kernels
// (flash_attention_bwd.cu): a template flag (LSE) of both kernels, from the
// row max and sum they already hold at the end, so the serving kernels are
// built without it and keep their registers.  Under a window (BAND and LSE
// together) the sum holds the band's keys only: the keys below a row's band
// score -inf and add nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash_tiles.cuh"
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
constexpr int F_BQ = 128;           // query rows per block, 64 per warpgroup
constexpr int F_THREADS = 2 * 128;  // two warpgroups, one of whose threads also issues the loads
constexpr int F_LOADER = 128;       // that thread

// The q tile (each warpgroup's O over its own rows at the end) and the
// ring of K and V tiles of KN keys
template <int HD>
struct FwdTiles {
  static constexpr int ATOMS = HD / 64;         // 64-wide column blocks of hd
  // keys per tile: at hd 64 64, so that a thread's S, P and O fit the 128
  // registers of two blocks an SM; at hd 128 (one block an SM) 128
  static constexpr int KN = HD == 64 ? 64 : 128;
  static constexpr int BLOCKS = HD == 64 ? 2 : 1;  // blocks an SM
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int Q_BLK = F_BQ * 128;      // one column block of the q tile, bytes
  static constexpr int K_BLK = KN * 128;
  static constexpr int Q_TILE = ATOMS * Q_BLK;
  static constexpr int K_TILE = ATOMS * K_BLK;
  static constexpr int STAGE = 2 * K_TILE;      // K, then V
  static constexpr int SMEM = Q_TILE + STAGES * STAGE + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// The online softmax of one key tile in place over a warpgroup's m64nKN
// scores, the thread's rows row_a, row_a + 8 (positions q_offset + row_a
// ..) against keys k0 ..: the running max m (of the scaled scores, log2
// domain) rises to the tile's, corr is exp2 of the fall, P = exp2(S
// scale_log2 - m) by one FFMA ahead of each exp2, and l = l corr + the
// thread's share of the row's P.  MASK (a tile on the causal diagonal, the
// band's low edge or past Skv) scores the keys the rows do not attend -inf,
// so that they add nothing, even to a row that has met no key yet (m then
// stays NEG_INF and the first key it attends rescales by exp2(NEG_INF - m)
// = 0 what came before, which is 0).
template <bool MASK, int KN>
__device__ __forceinline__ void softmax_tile(float (&sc)[KN / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale_log2, int lane,
                                             int row_a, int k0, int Skv, int causal, int window,
                                             int q_offset) {
  const float masked = __uint_as_float(0xff800000u);  // -inf
  float mx[2][4], sum[2][4];  // four partials a row, for the pipes' latency
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      mx[hh][u] = masked;
      sum[hh][u] = 0.f;
    }
#pragma unroll
  for (int j = 0; j < KN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e;
        if (MASK) {
          const int key = k0 + 8 * j + 2 * (lane % 4) + e, row = q_offset + row_a + 8 * hh;
          if (key >= Skv || (causal && key > row) || (window && row - key >= window))
            sc[i] = masked;
        }
        mx[hh][2 * (j % 2) + e] = fmaxf(mx[hh][2 * (j % 2) + e], sc[i]);
      }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float x = fmaxf(fmaxf(mx[hh][0], mx[hh][1]), fmaxf(mx[hh][2], mx[hh][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float mn = fmaxf(m[hh], x * scale_log2);
    corr[hh] = ex2(m[hh] - mn);
    m[hh] = mn;
  }
#pragma unroll
  for (int j = 0; j < KN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e;
        sc[i] = ex2(fmaf(sc[i], scale_log2, -m[hh]));
        sum[hh][2 * (j % 2) + e] += sc[i];
      }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l[hh] = l[hh] * corr[hh] + ((sum[hh][0] + sum[hh][1]) + (sum[hh][2] + sum[hh][3]));
}

// One block per (head, batch row, q tile of 128 rows): the loader fills a
// ring of STAGES key tiles; each warpgroup walks the block's key tiles with
// S of tile t and P V of tile t - 1 in flight while it runs the softmax,
// the two taking turns at the tensor cores, and stores its O through its
// rows of the q tile by TMA.
template <int HD, bool BAND, bool LSE>
__global__ void __launch_bounds__(F_THREADS, FwdTiles<HD>::BLOCKS)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, float* __restrict__ lse,
                   int lse_ld, int Sq, int Skv, int H, int KV, float scale_log2, int causal,
                   int window, int q_offset) {
  using namespace hopper;
  using T = FwdTiles<HD>;
  constexpr int KN = T::KN, STAGES = T::STAGES;
  if (!BAND) window = 0;  // folds the band's code away: the causal kernel keeps its registers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* kvs = smem + T::Q_TILE;  // stage s: K at s * STAGE, V after it
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kvs + STAGES * T::STAGE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  // causal: (head, batch row, q tile), the longest q tiles first across all
  // heads; not causal (every q tile as long): (q tile, head, batch row), a
  // head's q tiles together, so that they find its K and V in L2
  const int h = causal ? blockIdx.x : blockIdx.y, b = causal ? blockIdx.y : blockIdx.z;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.x) * F_BQ;
  const int kvh = h / (H / KV);
  const int a0 = q_offset + q0;  // the block's first row's position among the keys
  const int ntiles = ((causal ? min(Skv, a0 + F_BQ) : Skv) + KN - 1) / KN;
  const int t_lo = window ? max(0, a0 - window + 1) / KN : 0;  // the band's first tile
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);  // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The loader (the second warpgroup's first thread: in ping-pong that
  // warpgroup releases a tile after the first) loads key tile `next` into
  // its stage once both warpgroups are done with the tile STAGES before it:
  // after a release of its own only where the stage is free already (a
  // test, not a wait), waiting only for a tile it needs itself.
  int next = t_lo;
  auto refill = [&](int upto, bool block) {
    for (; next < ntiles && next <= upto; ++next) {
      const int n = next - t_lo, s = n % STAGES;
      if (n >= STAGES) {
        const uint32_t parity = ((n / STAGES) + 1) & 1;
        if (block) mbar_wait(&empty[s], parity);
        else if (!mbar_test_wait(&empty[s], parity)) break;
      }
      unsigned char* ks = kvs + s * T::STAGE;
      mbar_arrive_expect_tx(&full[s], T::STAGE);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a) {
        tma_load_4d(ks + a * T::K_BLK, &kmap, &full[s], 64 * a, kvh, next * KN, b);
        tma_load_4d(ks + T::K_TILE + a * T::K_BLK, &vmap, &full[s], 64 * a, kvh, next * KN, b);
      }
    }
  };
  if (threadIdx.x == F_LOADER) {
    tma_prefetch_map(&qmap);
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
    tma_prefetch_map(&omap);
    mbar_arrive_expect_tx(qbar, T::Q_TILE);
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a) tma_load_4d(qs + a * T::Q_BLK, &qmap, qbar, 64 * a, h, q0, b);
    refill(t_lo + STAGES - 1, false);
  }

  // warpgroup wgi: query rows r0 .. r0 + 63, against every key tile of the
  // block (the tiles past a warpgroup's rows, or below its band, are masked
  // whole: both take the same turns)
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = q0 + wgi * 64, ar0 = q_offset + r0;  // ar0: r0's position among the keys
  const int row_a = r0 + warp * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
  unsigned char* qw = qs + wgi * 64 * 128;
  auto stage = [&](int t) { return kvs + ((t - t_lo) % STAGES) * T::STAGE; };
  auto wait_tile = [&](int t) {
    if (threadIdx.x == F_LOADER) refill(t, true);
    __syncwarp();
    mbar_wait(&full[(t - t_lo) % STAGES], ((t - t_lo) / STAGES) & 1);
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(t - t_lo) % STAGES]);
    if (threadIdx.x == F_LOADER) refill(ntiles - 1, false);
    __syncwarp();
  };
  // Ping-pong, at one block an SM (two blocks an SM interleave four
  // warpgroups without it): a warpgroup issues its products only after the
  // other has
  // issued its own (named barrier 3 + wgi: its 128 threads wait, the
  // other's 128 arrive), so that one's products run on the tensor cores
  // while the other's softmax runs.  The first warpgroup goes first; each
  // issues ntiles - t_lo + 1 times, and the second skips its last
  // hand-over, which no one waits for.
  constexpr bool PINGPONG = T::BLOCKS == 1;
  auto turn = [&]() {
    if (PINGPONG) named_bar_sync(3 + wgi, 256);
  };
  auto hand_over = [&](bool last) {
    if (PINGPONG && !(last && wgi == 1)) named_bar_arrive(3 + (wgi ^ 1), 256);
  };

  float o[HD / 2];  // O: o[4 j + 2 hh + e] = O[row_a + 8 hh][8 j + 2 (lane % 4) + e]
  float sc[KN / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pa[KN / 4];  // P as wgmma's A fragments, KN / 16 k16 steps of keys
  zero(o);
  zero(sc);
  auto scores = [&](int t) {  // S = Q K^T of tile t, one commit group
    fence_regs(sc);
    fence_regs(o);
    wgmma_fence();
    score_product<HD, KN>(sc, qw, T::Q_BLK, stage(t), T::K_BLK);
    wgmma_commit();
  };
  auto softmax = [&](int t) {
    const int k0 = t * KN;
    if ((causal && k0 + KN - 1 > ar0) || k0 + KN > Skv || (window && k0 <= ar0 + 63 - window))
      softmax_tile<true, KN>(sc, m, l, corr, scale_log2, lane, row_a, k0, Skv, causal, window,
                             q_offset);
    else
      softmax_tile<false, KN>(sc, m, l, corr, scale_log2, lane, row_a, k0, Skv, causal, window,
                              q_offset);
  };
  auto pack = [&]() {  // P rounded once to bf16
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) pa[frag(j, hh)] = pack_bf16(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]);
  };
  auto pv = [&](int t) {  // O += P V of tile t, one commit group
    rs_product<HD, KN>(o, pa, stage(t) + T::K_TILE, T::K_BLK);
    wgmma_commit();
  };

  if (wgi == 1) hand_over(false);
  mbar_wait(qbar, 0);
  wait_tile(t_lo);
  turn();
  scores(t_lo);
  hand_over(false);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(t_lo);
  pack();
  for (int t = t_lo + 1; t < ntiles; ++t) {
    wait_tile(t);
    turn();
    scores(t);  // the tensor cores take S of tile t, then P V of tile t - 1,
    pv(t - 1);  // while the softmax of tile t waits only for S
    hand_over(false);
    wgmma_wait<1>();
    fence_regs(sc);
    softmax(t);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(t - 1);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i / 2) % 2];
    pack();
  }
  turn();
  fence_regs(o);
  wgmma_fence();
  pv(ntiles - 1);
  hand_over(true);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  release(ntiles - 1);

  // the rows' sums over their quad, the lse, and O normalised and rounded
  // once to bf16 into this warpgroup's rows of the q tile (no wgmma reads
  // them any more), in the tile's 128-byte swizzle, then one TMA store of
  // the 64 rows (rows past Sq are not written)
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = quad_sum(l[hh]);
    inv[hh] = 1.f / fmaxf(l[hh], 1e-30f);
    const int row = row_a + 8 * hh;
    if (LSE && lane % 4 == 0 && row < Sq)
      lse[((size_t)b * H + h) * lse_ld + row] = m[hh] + log2f(l[hh]);
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + lane / 4 + 8 * hh;  // r % 8 = lane / 4
      unsigned char* dst = qw + (j / 8) * T::Q_BLK + r * 128 + ((j % 8) ^ (lane / 4)) * 16;
      *reinterpret_cast<uint32_t*>(dst + 4 * (lane % 4)) =
          pack_bf16(o[4 * j + 2 * hh] * inv[hh], o[4 * j + 2 * hh + 1] * inv[hh]);
    }
  fence_proxy_async();
  named_bar_sync(1 + wgi, 128);
  if (tid == 0) {
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a) tma_store_4d(&omap, qw + a * T::Q_BLK, 64 * a, h, r0, b);
    bulk_commit();
    bulk_wait_read<0>();  // the shared memory read; the writes complete with the grid
  }
}

template <int HD, bool BAND, bool LSE>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                 int lse_ld, int B, int Sq, int Skv, int H, int KV, int causal, int window,
                 int q_offset, float scale, cudaStream_t stream) {
  using T = FwdTiles<HD>;
  static hopper::SmemRaised raised;
  CUtensorMap qmap, kmap, vmap, omap;
  const uint64_t qdims[4] = {HD, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t qstr[3] = {HD * 2, (uint64_t)H * HD * 2, (uint64_t)Sq * H * HD * 2};
  const uint32_t qbox[4] = {64, 1, F_BQ, 1};
  const uint32_t obox[4] = {64, 1, 64, 1};  // a warpgroup's rows
  const uint64_t kdims[4] = {HD, (uint64_t)KV, (uint64_t)Skv, (uint64_t)B};
  const uint64_t kstr[3] = {HD * 2, (uint64_t)KV * HD * 2, (uint64_t)Skv * KV * HD * 2};
  const uint32_t kbox[4] = {64, 1, T::KN, 1};
  if (!hopper::make_map_bf16(&qmap, q, 4, qdims, qstr, qbox) ||
      !hopper::make_map_bf16(&kmap, k, 4, kdims, kstr, kbox) ||
      !hopper::make_map_bf16(&vmap, v, 4, kdims, kstr, kbox) ||
      !hopper::make_map_bf16(&omap, out, 4, qdims, qstr, obox))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      hopper::allow_smem(flash_wgmma_kernel<HD, BAND, LSE>, T::SMEM, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (Sq + F_BQ - 1) / F_BQ;
  const dim3 grid = causal ? dim3(H, B, nq) : dim3(nq, H, B);
  flash_wgmma_kernel<HD, BAND, LSE><<<grid, F_THREADS, T::SMEM, stream>>>(
      qmap, kmap, vmap, omap, lse, lse_ld, Sq, Skv, H, KV, scale * LOG2E, causal, window,
      q_offset);
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
