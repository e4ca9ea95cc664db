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
// the thousands) it is bound by tensor-core operations, and only wgmma
// reaches the tensor cores' full rate.
//
// What the design does about it.  Prefill (bf16, M >= 64, 16-byte strides:
// matmul_wgmma_kernel, redesigned for the training step's products):
// persistent blocks, at most one per SM, walk the output's 128 x BN tiles
// (BN 128, or 256 where the host's plan says so) in a static order that
// rasterises groups of 16 tile rows column by column, so the blocks running
// at once share their column tiles of w (or dy) in L2 instead of re-reading
// them once per tile row.  A producer warp keeps a ring of stages filled by
// TMA (x and w tiles 64 deep in k, 128-byte swizzled; 4 stages of 32 KB at
// BN 128, 3 of 48 KB at BN 256) with a full and an empty mbarrier per
// stage, the ring's phases carried across tiles, so it loads the next
// tile's stages while the consumers finish the current one.  Two consumer
// warpgroups each run wgmma m64n128k16 (or m64n256k16) over a 64-row strip
// into fp32 registers, one k step's wgmmas in flight while the next is
// issued; the epilogue rounds to bf16 into a store tile apart from the ring
// (swizzled as TMA reads it) and one thread a warpgroup TMA-stores it
// (N % 8 != 0: stores from registers), so the next tile's first wgmmas
// start without waiting for the store.  x is read row-major or, for a
// backward's dw = x^T dy, as the transpose of the row-major x (x_t: an
// MN-major A, 64 x 64 boxes along M, transpose bit set), with no copy; w
// row-major (an MN-major B) or as the transpose of an (N, K) array (the tied
// unembedding, a backward's dx = dy w^T: K-major).  Where the output's tiles
// fall short of the SMs (a dw's d_in x d_out, a narrow projection) the plan
// cuts K into runs, the blocks of a cluster (at most 8), as many as keep
// every cluster running at once; each block writes its fp32 partial tile
// over its quiet ring (the producer waits for the merge on such tiles),
// and after a cluster barrier sums its share of the tile's rows over every
// block's partial, in rank order, through distributed shared memory: no
// workspace, no atomics, two calls give the same bits.  TMA zero-fills the
// ragged edges of M, N and K (inside an expert's rank-3 map: a grouped dw's
// capacity C needs no pad) and the store clips them.  The 128-wide tile
// sums K in chains of 4096 (G_CHAIN), the wide one K <= 16384 in one.
// Registers (ptxas): 167-168 a thread at BN 128 (the chains' sum), 166-168
// at BN 256, no spill; dynamic shared memory 164,928 bytes at BN 128 (ring
// 128 KB, store tile 32 KB), 214,064 at BN 256 (ring 144 KB, store tile
// 64 KB): one block an SM either way; the split's 68 or 132 KB partial
// lies over the ring rather than beside it, which keeps BN 256 within the
// 227 KB a block may use.  Measured (tools/k1_ab.py, the parent and this
// design alternating in one call, NVIDIA H100 80GB HBM3 at 700 W, L2
// flushed): the train paths' products at 4096 rows went from 1.29-2.26x
// torch.matmul's sums to 1.06-1.35x (qwen2_0_5b's forward 3.80 -> 1.79 ms,
// its dw 3.36 ms + 0.29 of x^T copies -> 1.98); a dw of 7-49 output tiles
// 0.0288-0.0319 -> 0.0165-0.0259 ms (torch.matmul 0.0134-0.0191); the
// served prefills' sums 1.35-1.77x -> 1.10-1.32x; K1's device ms a train
// step (tools/train_ab.py) qwen2_0_5b 39.2 -> 29.8.  Per shape in PERF.md.
// Decode (bf16, M < 64, the same TMA rules: matmul_decode_kernel): the
// operands are swapped, out^T (N x M) = w^T . x^T, so the weight fills
// wgmma's 64-row A and the batch rows are its N, in groups of 8
// (m64n8k16): the tied embedding's .t() is a K-major A, a row-major w an
// MN-major A (transpose bit), x a K-major B whose rows past M TMA
// zero-fills.  One block per 64 output columns and a range of K: a producer
// warp keeps a ring of D_STAGES (4) 64 x 64 weight tiles in flight, and up
// to five blocks share an SM, so an SM keeps up to 160 KB of weight in
// flight.  Where the
// column tiles alone are fewer than the SMs, the K ranges of one column
// tile form a thread-block cluster (at most 8); after a cluster barrier each
// block sums a share of the tile over all blocks' fp32 partials through
// distributed shared memory and writes bf16.  One launch per call, with no
// workspace: the tied unembeddings (2376 and 788 column tiles) need no
// split.  The host's plan (kernels/streamed_matmul.py) picks the split.
// Other bf16 (what TMA cannot take, such as K % 8 != 0: matmul_bf16_kernel):
// one block per 64x64 output tile walks K in 32-wide steps through shared
// memory, loaded element by element (its strides or addresses are not
// 16-byte multiples), with wmma (mma.sync) into fp32 accumulators; when the output tiles
// alone would leave most SMs idle, the caller splits K over blockIdx.z: each
// split writes an fp32 partial tile to a workspace and a second pass sums
// them.  The weight may be given transposed (w_t=1: w is the transpose of a
// contiguous (N,K) array), so the tied unembedding reads the (vocab, d)
// embedding table in place instead of copying it.
// fp32 (matmul_f32_ring_kernel; the MoE router, which the JAX package
// keeps in fp32, and every fp32 parity product): FFMA on the CUDA cores,
// tiles shaped to M, operands staged by TMA in a ring, K split over a
// cluster where the tiles fall short of the SMs, x^T read in place (its
// header below).  fp32 that TMA cannot map (K % 4 != 0, a misaligned
// tensor: matmul_f32_kernel) loads element by element and splits K over two
// launches, as the wmma kernel does.
// Grouped (the experts of an MoE layer, models/moe.py's _expert_ffn):
// out (E, M, N) = x (E, M, K) @ w (E, K, N) per expert in one launch, where
// a loop over experts would launch E times per projection.  The prefill and
// the element-wise fp32 kernels take a grid dimension over the experts
// (template flag G); the bf16 tensor maps are rank 3, so a box stays inside
// one expert and its ragged rows or k read zero, not the next expert's.  At
// a decode step every expert's C = 8 capacity rows are a decode product of
// its own, so the step reads every expert's weights once, as the JAX
// capacity design does: matmul_grouped_decode_kernel, persistent blocks
// with equal shares of the (expert, column tile, k step) work (its header
// below).  A training step's backward is two more grouped products per
// projection (kernels/ops.py's _GroupedMatmul): dx = dy w^T, which reads
// each expert's w in place as the transpose (w_t, as the tied unembedding
// is read), and dw = x^T dy, which reads each expert's x in place as the
// transpose (x_t), its capacity the product's K.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

// The wmma kernel takes only products that TMA cannot (a stride not a
// multiple of 16 bytes, a misaligned tensor), so its loads are per element.
__device__ __forceinline__ void load_x_tile(const __nv_bfloat16* __restrict__ x,
                                            __nv_bfloat16* As, int M, int K, int m0, int k0) {
  for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    const int gm = m0 + r, gk = k0 + c;
    As[r * LDA + c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : __float2bfloat16(0.f);
  }
}

template <bool WT>
__device__ __forceinline__ void load_w_tile(const __nv_bfloat16* __restrict__ w,
                                            __nv_bfloat16* Bs, int N, int K, int k0, int n0) {
  if (!WT) {  // w row-major (K, N): tile rows along k, n contiguous
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r * LDB + c] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : __float2bfloat16(0.f);
    }
  } else {  // w = transpose of row-major (N, K): tile rows along n, k contiguous
    for (int i = threadIdx.x; i < BN * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gn = n0 + r, gk = k0 + c;
      Bs[r * LDBT + c] = (gn < N && gk < K) ? w[(size_t)gn * K + gk] : __float2bfloat16(0.f);
    }
  }
}

template <bool WT>
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
    load_x_tile(x, As, M, K, m0, k0);
    load_w_tile<WT>(w, Bs, N, K, k0, n0);
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

// ------------------------------------------------------- bf16 path, wgmma
constexpr int G_BM = 128, G_BK = 64;  // BK: one 128-byte swizzle row
constexpr int G_CONSUMERS = 2;           // warpgroups, 64 rows each
constexpr int G_THREADS = G_CONSUMERS * 128 + 32;  // and one producer warp
constexpr int G_A_BYTES = G_BM * G_BK * 2;         // 128 rows of 128 B
constexpr int G_BOX = 64 * 128;  // a 64 x 64 bf16 box of 128-byte swizzled rows
constexpr int G_GROUP_M = 16;    // tile rows a raster group spans
// The tensor cores' fp32 accumulation does not round to nearest: its error
// grows with the length of one accumulation chain, past about one bf16
// rounding of the output at K ~ 30,000 on an H100 (torch.matmul's too).  The
// 128-wide tile moves its accumulator into an fp32 sum in registers (rounded
// to nearest) every G_CHAIN k steps (4096 of K); the 256-wide tile has no
// registers for that second sum and takes K <= 16384 only (the host's plan,
// kernels/streamed_matmul.py:WIDE_MAX_K).
constexpr int G_CHAIN = 64;

// A tile of 128 rows by BN (128 or 256) columns: the ring's stages (4 of
// 32 KB, or 3 of 48 KB), the bf16 store tile (per consumer warpgroup 64
// rows x BN columns as BN / 64 boxes of 64 x 64, what the TMA store reads)
// and a split unit's fp32 partial tile, rows padded against bank
// conflicts, which lies over the ring (quiet while the cluster merges).
template <int BN>
struct Prefill {
  static constexpr int STAGES = BN == 128 ? 4 : 3;
  static constexpr int B_BYTES = BN * G_BK * 2;
  static constexpr int STAGE = G_A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int OUT_WG = 64 * BN * 2;
  static constexpr int OUT = G_CONSUMERS * OUT_WG;
  static constexpr int PSTRIDE = BN + 8;
  static constexpr int SMEM = RING + OUT + 2 * STAGES * 8 + 1024;  // + alignment
  static_assert(G_BM * PSTRIDE * 4 <= RING, "the partial tile fits the ring");
};

struct Tile {
  int e, m0, n0;
};

// Work unit t of E x tiles_m x tiles_n output tiles: expert-major, then
// groups of G_GROUP_M tile rows walked column by column, so the blocks
// running at once share a few column tiles of w in L2.
__device__ __forceinline__ Tile tile_of(int t, int tiles_m, int tiles_n, int bn) {
  const int per_e = tiles_m * tiles_n, r = t % per_e;
  const int group = G_GROUP_M * tiles_n, first = (r / group) * G_GROUP_M;
  const int rows = min(tiles_m - first, G_GROUP_M), q = r % group;
  return {t / per_e, (first + q % rows) * G_BM, (q / rows) * bn};
}

// The A tile of k step k0: x (M, K) rows in one 128 x 64 box, or (XT) x^T
// read in place from a row-major (K, M), m contiguous, in two 64 (m) x 64 (k)
// boxes, one per consumer warpgroup.  G: expert c.e of a rank-3 map.
template <bool XT, bool G>
__device__ __forceinline__ void load_a(unsigned char* a, const CUtensorMap* map, uint64_t* bar,
                                       const Tile& c, int k0) {
  using namespace hopper;
  if (XT) {
    if (G) {
      tma_load_3d(a, map, bar, c.m0, k0, c.e);
      tma_load_3d(a + G_A_BYTES / 2, map, bar, c.m0 + 64, k0, c.e);
    } else {
      tma_load_2d(a, map, bar, c.m0, k0);
      tma_load_2d(a + G_A_BYTES / 2, map, bar, c.m0 + 64, k0);
    }
  } else if (G) {
    tma_load_3d(a, map, bar, k0, c.m0, c.e);
  } else {
    tma_load_2d(a, map, bar, k0, c.m0);
  }
}

// The B tile: w's (N, K) rows (WT) in one BN x 64 box, or its (K, N) rows,
// n contiguous, in BN / 64 boxes of 64 (k) x 64 (n).
template <bool WT, bool G, int BN>
__device__ __forceinline__ void load_b(unsigned char* b, const CUtensorMap* map, uint64_t* bar,
                                       const Tile& c, int k0) {
  using namespace hopper;
  if (WT) {
    if (G) tma_load_3d(b, map, bar, k0, c.n0, c.e);
    else tma_load_2d(b, map, bar, k0, c.n0);
    return;
  }
#pragma unroll
  for (int q = 0; q < BN / 64; ++q) {
    if (G) tma_load_3d(b + q * G_BOX, map, bar, c.n0 + 64 * q, k0, c.e);
    else tma_load_2d(b + q * G_BOX, map, bar, c.n0 + 64 * q, k0);
  }
}

// Block `rank` of a split's cluster sums its share of the tile (every
// splits-th run of four columns) over every block's fp32 partial, in rank
// order, and stores it as bf16.  All the block's threads take part.
template <int BN>
__device__ __forceinline__ void merge_partials(const float* part, __nv_bfloat16* out,
                                               const Tile& c, int M, int N, int splits,
                                               int rank) {
  using namespace hopper;
  for (int i = rank * G_THREADS + threadIdx.x; i < G_BM * (BN / 4); i += splits * G_THREADS) {
    const int r = i / (BN / 4), col = (i % (BN / 4)) * 4;
    const int gm = c.m0 + r, gn = c.n0 + col;
    if (gm >= M || gn >= N) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {
      if (q >= splits) break;
      const float4 v = ld_dsmem_f32x4(part + r * Prefill<BN>::PSTRIDE + col, q);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    __nv_bfloat16* o = out + (size_t)gm * N + gn;
    if (N % 4 == 0) {  // gn + 3 < N, 8-byte aligned
      *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    } else {
      const float s[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int k = 0; k < 4 && gn + k < N; ++k) o[k] = __float2bfloat16(s[k]);
    }
  }
}

// Persistent: gridDim.x / splits clusters of `splits` blocks walk the E x
// tiles_m x tiles_n output tiles (tile_of's order), cluster c taking tiles
// c, c + clusters, ...; block `rank` of a cluster sums k steps rank x
// steps_per_split .. + steps_per_split - 1 of each (all of them when
// splits = 1).  XT: x is read as the transpose of a row-major (K, M) (dw =
// x^T dy); WT: w as the transpose of a row-major (N, K); G: a grouped
// product, rank-3 maps over the experts.  tma_out: N % 8 == 0, the output
// stored by TMA from a shared-memory tile through omap; otherwise from
// registers.
template <bool XT, bool WT, bool G, int BN>
__global__ void __launch_bounds__(G_THREADS, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap omap,
                    __nv_bfloat16* __restrict__ out, int E, int M, int N, int K, int splits,
                    int steps_per_split, int tma_out) {
  using namespace hopper;
  using P = Prefill<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* otile = smem + P::RING;
  float* part = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::RING + P::OUT);
  uint64_t* empty = full + P::STAGES;

  const int tiles_m = (M + G_BM - 1) / G_BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = E * tiles_m * tiles_n;
  const int rank = splits > 1 ? (int)cluster_rank() : 0;
  const int cluster = blockIdx.x / splits, clusters = gridDim.x / splits;
  const int k_first = rank * steps_per_split;
  const int nsteps = min(steps_per_split, (K + G_BK - 1) / G_BK - k_first);
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G_CONSUMERS * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wgi == G_CONSUMERS) {  // producer warp: one thread issues every load
    if (lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
    }
    int it = 0;  // k steps loaded so far, over every unit: the ring's phase
    for (int t = cluster; t < tiles; t += clusters) {
      if (lane == 0) {
        const Tile c = tile_of(t, tiles_m, tiles_n, BN);
        for (int j = 0; j < nsteps; ++j, ++it) {
          const int s = it % P::STAGES;
          if (it >= P::STAGES) mbar_wait(&empty[s], ((it / P::STAGES) + 1) & 1);
          unsigned char* a = smem + s * P::STAGE;
          mbar_arrive_expect_tx(&full[s], P::STAGE);
          load_a<XT, G>(a, &xmap, &full[s], c, (k_first + j) * G_BK);
          load_b<WT, G, BN>(a + G_A_BYTES, &wmap, &full[s], c, (k_first + j) * G_BK);
        }
      }
      // a split unit: the producer loads the next unit only after the
      // merge, whose partial lies over the ring
      if (splits > 1) {
        const Tile c = tile_of(t, tiles_m, tiles_n, BN);
        __syncwarp();
        cluster_sync();
        merge_partials<BN>(part, out + (size_t)c.e * M * N, c, M, N, splits, rank);
        cluster_sync();
      }
    }
    return;
  }

  // consumer warpgroup wgi: rows m0 + 64 wgi .. + 63 of each tile
  float acc[BN / 2];
  float sum[BN / 2];  // the chains' sum (the 128-wide tile only)
  const int warp = (threadIdx.x % 128) / 32, wg_thread = threadIdx.x % 128;
  unsigned char* mine = otile + wgi * P::OUT_WG;
  int it = 0;
  for (int t = cluster; t < tiles; t += clusters) {
    const Tile c = tile_of(t, tiles_m, tiles_n, BN);
    // the 128-wide tile sums K in chains of G_CHAIN steps, the wide one in one
    const int chain = BN == 128 ? G_CHAIN : nsteps;
    for (int j0 = 0; j0 < nsteps; j0 += chain) {
      const int j1 = min(nsteps, j0 + chain);
      for (int j = j0; j < j1; ++j, ++it) {
        const int s = it % P::STAGES;
        mbar_wait(&full[s], (it / P::STAGES) & 1);
        const unsigned char* a = smem + s * P::STAGE + wgi * (G_A_BYTES / G_CONSUMERS);
        const unsigned char* b = smem + s * P::STAGE + G_A_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G_BK / 16; ++kk) {
          // x^T: the warpgroup's 64 m of one box, MN-major, a k16 step 16
          // rows of 128 B on
          const uint64_t da = XT ? make_desc(a + kk * 2048, G_A_BYTES / 2, 1024)
                                 : make_desc(a + kk * 32, 16, 1024);
          const uint64_t db = WT ? make_desc(b + kk * 32, 16, 1024)
                                 : make_desc(b + kk * 2048, G_BOX, 1024);
          if constexpr (BN == 128)
            wgmma_ss_n128<XT ? 1 : 0, WT ? 0 : 1>(acc, da, db, j > j0 || kk > 0);
          else
            wgmma_ss_n256<XT ? 1 : 0, WT ? 0 : 1>(acc, da, db, j > j0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's wgmmas are done: free its stage
        fence_regs(acc);
        if (j > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % P::STAGES]);
      }
      if constexpr (BN == 128) {
        if (j1 < nsteps) {  // a chain ends: its wgmmas done, it joins the sum
          wgmma_wait<0>();
          fence_regs(acc);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) sum[i] = j0 == 0 ? acc[i] : sum[i] + acc[i];
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % P::STAGES]);
    if constexpr (BN == 128) {
      if (nsteps > chain) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += sum[i];
      }
    }

    // acc[4 j + 2 h + e] = D[64 wgi + 16 warp + lane / 4 + 8 h][8 j + 2 (lane % 4) + e]
    const int r = 16 * warp + lane / 4;
    if (splits > 1) {
      // the partial lies over stages the other warpgroup may still read
      named_bar_sync(3, G_CONSUMERS * 128);
      float* p = part + (64 * wgi + r) * P::PSTRIDE + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(p + 8 * h * P::PSTRIDE + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      fence_proxy_async();  // before TMA writes the ring again
      cluster_sync();
      merge_partials<BN>(part, out + (size_t)c.e * M * N, c, M, N, splits, rank);
      fence_proxy_async();
      cluster_sync();
    } else if (tma_out) {
      // the store tile is free once the previous unit's store has read it
      if (wg_thread == 0) bulk_wait_read<0>();
      named_bar_sync(1 + wgi, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;  // row & 7 == lane / 4: conflict-free
          *reinterpret_cast<uint32_t*>(mine + (j / 8) * G_BOX + row * 128 +
                                       (((j % 8) ^ (row & 7)) << 4) + (lane % 4) * 4) =
              pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      fence_proxy_async();
      named_bar_sync(1 + wgi, 128);
      if (wg_thread == 0 && c.m0 + 64 * wgi < M) {
        for (int q = 0; q < BN / 64 && c.n0 + 64 * q < N; ++q) {
          if (G) tma_store_3d(&omap, mine + q * G_BOX, c.n0 + 64 * q, c.m0 + 64 * wgi, c.e);
          else tma_store_2d(&omap, mine + q * G_BOX, c.n0 + 64 * q, c.m0 + 64 * wgi);
        }
        bulk_commit();
      }
    } else {
      __nv_bfloat16* o0 = out + (size_t)c.e * M * N;
      const int row0 = c.m0 + wgi * 64 + r;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c.n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= M || col >= N) continue;
          __nv_bfloat16* o = o0 + (size_t)row * N + col;
          if (col + 1 < N && (N % 2) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          } else {
            o[0] = __float2bfloat16(acc[4 * j + 2 * h]);
            if (col + 1 < N) o[1] = __float2bfloat16(acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
  if (tma_out && wg_thread == 0) bulk_wait<0>();  // the last store, before the block ends
}

// ------------------------------------------------ bf16 decode path, wgmma
// A block's weight tile: 64 output columns (wgmma's 64 rows of A) by 64 k
// (one 128-byte swizzle row); the host's plan reads it through
// streamed_matmul_decode_tile().
constexpr int D_TILE = 64;
// Ring depth: 4 stages keep a block near 40 KB of shared memory (one group
// of 8 rows), so five blocks fit an SM; at 8 stages (75 KB) only two fit,
// and plans of more than two blocks per SM ran in two waves.
constexpr int D_STAGES = 4;
constexpr int D_THREADS = 128 + 32;      // one consumer warpgroup, one producer warp
constexpr int D_PSTRIDE = D_TILE + 4;    // fp32 partial rows, padded against bank conflicts

template <int NG>  // groups of 8 batch rows
struct DecodeTiles {
  static constexpr int A_BYTES = D_TILE * D_TILE * 2;  // w tile, 8 KB
  static constexpr int B_BYTES = NG * 8 * D_TILE * 2;  // x tile, 1 KB per group
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int PART = NG * 8 * D_PSTRIDE * 4;
  static constexpr int SMEM = D_STAGES * STAGE + PART + 2 * D_STAGES * 8 + 1024;
};

template <bool WT, int NG>
__global__ void __launch_bounds__(D_THREADS)
matmul_decode_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K,
                     int steps_per_split) {
  using namespace hopper;
  using T = DecodeTiles<NG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* part = reinterpret_cast<float*>(smem + D_STAGES * T::STAGE);  // [8 NG][D_PSTRIDE]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + NG * 8 * D_PSTRIDE);
  uint64_t* empty = full + D_STAGES;

  const int n0 = blockIdx.y * D_TILE;
  const int i0 = blockIdx.x * steps_per_split;
  const int nsteps = min(steps_per_split, (K + D_TILE - 1) / D_TILE - i0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < D_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {  // producer warp: one thread issues every load
    if (lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % D_STAGES;
        if (i >= D_STAGES) mbar_wait(&empty[s], ((i / D_STAGES) + 1) & 1);
        unsigned char* a = smem + s * T::STAGE;
        const int k0 = (i0 + i) * D_TILE;
        mbar_arrive_expect_tx(&full[s], T::STAGE);
        if (WT) tma_load_2d(a, &wmap, &full[s], k0, n0);  // (N, K) rows: 64 n of 64 k
        else tma_load_2d(a, &wmap, &full[s], n0, k0);     // (K, N) rows: 64 k of 64 n
        tma_load_2d(a + T::A_BYTES, &xmap, &full[s], k0, 0);  // x rows 0 .. 8 NG - 1
      }
    }
    __syncwarp();
  } else {
    float acc[NG][4];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
    for (int i = 0; i < nsteps; ++i) {
      const int s = i % D_STAGES;
      mbar_wait(&full[s], (i / D_STAGES) & 1);
      const unsigned char* a = smem + s * T::STAGE;
      const unsigned char* xb = a + T::A_BYTES;
#pragma unroll
      for (int g = 0; g < NG; ++g) fence_regs(acc[g]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D_TILE / 16; ++kk) {
        const uint64_t da = WT ? make_desc(a + kk * 32, 16, 1024)
                               : make_desc(a + kk * 2048, T::A_BYTES, 1024);
#pragma unroll
        for (int g = 0; g < NG; ++g)
          wgmma_ss_n8<WT ? 0 : 1, 0>(acc[g], da, make_desc(xb + g * 1024 + kk * 32, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's wgmmas are done: free its stage
#pragma unroll
      for (int g = 0; g < NG; ++g) fence_regs(acc[g]);
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % D_STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < NG; ++g) fence_regs(acc[g]);
    // acc[g][2 h + e] = out^T[n0 + 16 warp + lane / 4 + 8 h][8 g + 2 (lane % 4) + e]
    const int col = 16 * warp + lane / 4, row = 2 * (lane % 4);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) part[(8 * g + row + e) * D_PSTRIDE + col + 8 * h] = acc[g][2 * h + e];
  }

  // Block `rank` of the cluster sums every splits-th share of the tile's
  // rows < M over all blocks' partials and writes it; the second barrier
  // keeps each block's shared memory alive until the others have read it.
  __syncwarp();
  cluster_sync();
  const int splits = gridDim.x, rank = cluster_rank();
  const int rows = min(M, 8 * NG);
  for (int i = rank * D_THREADS + threadIdx.x; i < rows * D_TILE; i += splits * D_THREADS) {
    const int r = i / D_TILE, c = i % D_TILE;
    if (n0 + c >= N) continue;
    const float* p = part + r * D_PSTRIDE + c;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < splits) sum += ld_dsmem_f32(p, q);
    out[(size_t)r * N + n0 + c] = __float2bfloat16(sum);
  }
  cluster_sync();
}

// Groups of 8 batch rows that the decode kernels run for M rows (N = 8 per
// wgmma): 1, 2, 4 or 8.
int row_groups(int M) { return M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8; }

template <bool WT, int NG>
cudaError_t launch_decode(const CUtensorMap& xmap, const CUtensorMap& wmap, void* out, int M,
                          int N, int K, int splits, int steps_per_split, cudaStream_t s) {
  static hopper::SmemRaised raised;
  const dim3 grid(splits, (N + D_TILE - 1) / D_TILE);
  return hopper::launch_cluster(matmul_decode_kernel<WT, NG>, raised, grid, D_THREADS,
                                DecodeTiles<NG>::SMEM, splits, s, xmap, wmap,
                                static_cast<__nv_bfloat16*>(out), M, N, K, steps_per_split);
}

template <bool WT>
cudaError_t launch_decode_groups(const CUtensorMap& xmap, const CUtensorMap& wmap, void* out,
                                 int M, int N, int K, int splits, int steps, cudaStream_t s) {
  switch (row_groups(M)) {
    case 1: return launch_decode<WT, 1>(xmap, wmap, out, M, N, K, splits, steps, s);
    case 2: return launch_decode<WT, 2>(xmap, wmap, out, M, N, K, splits, steps, s);
    case 4: return launch_decode<WT, 4>(xmap, wmap, out, M, N, K, splits, steps, s);
    default: return launch_decode<WT, 8>(xmap, wmap, out, M, N, K, splits, steps, s);
  }
}

// ----------------------------------- bf16 grouped decode path, persistent
// The experts of an MoE layer at a decode step (every expert's C < 64
// capacity rows a decode product of its own, whatever they hold).  The work
// is I = E x strips items, each one expert's GD_STRIP x 64 output columns
// (its weight rows read 512 bytes at a time, not 128: fewer DRAM row
// openings a byte; a strip's tiles past N neither loaded nor multiplied)
// over its K in S = ceil(K / 64) steps.  G persistent blocks (all
// resident: one an SM with a ring of about 200 KB, or two with half that,
// BPS; the host picks G so that G divides I where a G near the slots does)
// take R = I / G rounds of whole items, block b items b, b + G, ..., so the
// blocks running at once also read neighbouring strips of the same
// experts' rows, then an equal share of the last I - R G items' steps:
// block b the tail steps Wt b / G .. Wt (b + 1) / G - 1 in the order
// (item, k step), Wt = (I - R G) S.  So shares differ by at most one step
// and no wave is left half full.  A block walks its items with one ring
// (its phases carried across items), so the next item's weight tiles
// stream in while the current one's epilogue runs, and reads its expert's
// x rows with each step's weights, once an item and for all GD_STRIP
// column tiles.  Where a share boundary cuts a tail item, the block that
// holds the item's first step (its last item) adds the parts the following
// blocks computed (each their first tail item, done right after the
// rounds) in block order: each such block writes its fp32 part to its slot
// of `parts` and raises its flag; the first block waits for the flags,
// adds the parts, writes the bf16 output and lowers the flags for the next
// call.  No atomics: two calls give the same bits.
constexpr int GD_STRIP = 4;                   // 64-column tiles an item
constexpr int GD_STEP = D_TILE;               // k a step
constexpr int GD_SLOT = GD_STRIP * 8 * 4 * 128;  // floats of a part at 8 groups

// BPS blocks an SM (1 or 2), each with a ring of about 200 / BPS KB
template <int NG, int BPS>
struct GroupedDecodeTiles {
  static constexpr int A_BOX = D_TILE * D_TILE * 2;  // a 64 x 64 w box, 8 KB
  static constexpr int A_BYTES = GD_STRIP * A_BOX;
  static constexpr int STAGE = A_BYTES + NG * 8 * D_TILE * 2;  // and x's 8 NG rows
  static constexpr int RING = 200 * 1024 / BPS;
  static constexpr int STAGES = RING / STAGE < 12 ? RING / STAGE : 12;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// Block b's walk: its R rounds of whole items, then its share of the
// tail's steps.  next() gives the item and steps k0 .. k1 - 1 of position
// p (0 .. length() - 1), the position after it p + k1 - k0.
struct DecodeWalk {
  long long items, rounds, tail_steps;
  int S, b, G;

  __device__ __forceinline__ DecodeWalk(int E, int strips, int S_, int b_, int G_)
      : items((long long)E * strips), rounds(items / G_),
        tail_steps((items - rounds * G_) * S_), S(S_), b(b_), G(G_) {}
  // tail step at which block j's share starts
  __device__ __forceinline__ long long tail_start(int j) const { return tail_steps * j / G; }
  __device__ __forceinline__ long long length() const {
    return rounds * S + tail_start(b + 1) - tail_start(b);
  }
  __device__ __forceinline__ void next(long long p, long long& item, int& k0, int& k1) const {
    if (p < rounds * S) {
      item = b + (p / S) * G;
      k0 = 0;
      k1 = S;
      return;
    }
    const long long s = tail_start(b) + (p - rounds * S);
    const long long t = s / S;
    item = rounds * G + t;
    k0 = (int)(s - t * S);
    k1 = (int)min((long long)S, k0 + (tail_start(b + 1) - s));
  }
};

template <bool WT, int NG, int BPS>
__global__ void __launch_bounds__(D_THREADS, BPS)
matmul_grouped_decode_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap wmap,
                             __nv_bfloat16* __restrict__ out, float* __restrict__ parts,
                             int* __restrict__ flags, int E, int M, int N, int K) {
  using namespace hopper;
  using T = GroupedDecodeTiles<NG, BPS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;

  const int strips = (N + GD_STRIP * D_TILE - 1) / (GD_STRIP * D_TILE);
  const int S = (K + GD_STEP - 1) / GD_STEP;
  const int b = blockIdx.x, G = gridDim.x;
  const DecodeWalk walk(E, strips, S, b, G);
  const long long length = walk.length();
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {  // producer warp: one thread issues every load
    if (lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      int it = 0;  // steps loaded so far, over every item: the ring's phase
      for (long long p = 0; p < length;) {
        long long item;
        int k0, k1;
        walk.next(p, item, k0, k1);
        const int e = (int)(item / strips);
        const int n0 = (int)(item % strips) * GD_STRIP * D_TILE;
        const int valid = min(GD_STRIP, (N - n0 + D_TILE - 1) / D_TILE);  // tiles inside N
        for (int k = k0; k < k1; ++k, ++it) {
          const int st = it % T::STAGES;
          if (it >= T::STAGES) mbar_wait(&empty[st], ((it / T::STAGES) + 1) & 1);
          unsigned char* a = smem + st * T::STAGE;
          const int kq = k * GD_STEP;
          mbar_arrive_expect_tx(&full[st], valid * T::A_BOX + (T::STAGE - T::A_BYTES));
          // expert e's (N, K) (WT) or (K, N) rows, a box a column tile
          // inside N, and its x rows 0 .. 8 NG - 1
#pragma unroll
          for (int q = 0; q < GD_STRIP; ++q) {
            if (q >= valid) break;
            if (WT) tma_load_3d(a + q * T::A_BOX, &wmap, &full[st], kq, n0 + q * D_TILE, e);
            else tma_load_3d(a + q * T::A_BOX, &wmap, &full[st], n0 + q * D_TILE, kq, e);
          }
          tma_load_3d(a + T::A_BYTES, &xmap, &full[st], kq, 0, e);
        }
        p += k1 - k0;
      }
    }
    __syncwarp();
    return;
  }

  // the consumer warpgroup
  const int t = threadIdx.x;
  int it = 0;
  for (long long p = 0; p < length;) {
    long long item;
    int k0, k1;
    walk.next(p, item, k0, k1);
    const int e = (int)(item / strips);
    const int n0 = (int)(item % strips) * GD_STRIP * D_TILE;
    const int valid = min(GD_STRIP, (N - n0 + D_TILE - 1) / D_TILE);  // tiles inside N
    float acc[GD_STRIP][NG][4];
#pragma unroll
    for (int q = 0; q < GD_STRIP; ++q)
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][g][i] = 0.f;
    for (int k = k0; k < k1; ++k, ++it) {
      const int st = it % T::STAGES;
      mbar_wait(&full[st], (it / T::STAGES) & 1);
      const unsigned char* a = smem + st * T::STAGE;
      const unsigned char* xb = a + T::A_BYTES;
#pragma unroll
      for (int q = 0; q < GD_STRIP; ++q)
#pragma unroll
        for (int g = 0; g < NG; ++g) fence_regs(acc[q][g]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D_TILE / 16; ++kk)
#pragma unroll
        for (int q = 0; q < GD_STRIP; ++q) {
          if (q >= valid) break;  // a tile past N: nothing loaded, nothing stored
          const unsigned char* aq = a + q * T::A_BOX;
          const uint64_t da = WT ? make_desc(aq + kk * 32, 16, 1024)
                                 : make_desc(aq + kk * 2048, T::A_BOX, 1024);
#pragma unroll
          for (int g = 0; g < NG; ++g)
            wgmma_ss_n8<WT ? 0 : 1, 0>(acc[q][g], da,
                                       make_desc(xb + g * 1024 + kk * 32, 16, 1024), 1);
        }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's wgmmas are done: free its stage
#pragma unroll
      for (int q = 0; q < GD_STRIP; ++q)
#pragma unroll
        for (int g = 0; g < NG; ++g) fence_regs(acc[q][g]);
      if (k > k0 && lane == 0) mbar_arrive(&empty[(it - 1) % T::STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < GD_STRIP; ++q)
#pragma unroll
      for (int g = 0; g < NG; ++g) fence_regs(acc[q][g]);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % T::STAGES]);

    if (k0 > 0) {
      // the rest of an item an earlier block began: its part to this
      // block's slot (each thread its own floats), then the flag
      float* slot = parts + (size_t)b * GD_SLOT;
#pragma unroll
      for (int q = 0; q < GD_STRIP; ++q)
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            __stcg(slot + ((q * NG + g) * 4 + i) * 128 + t, acc[q][g][i]);
      __threadfence();
      named_bar_sync(1, 128);
      if (t == 0) flag_release(&flags[b], 1);
    } else {
      if (k1 < S) {
        // this block began a tail item and a share boundary cut it: add the
        // parts of the blocks that hold its other steps, in block order
        const long long item_end = (item - walk.rounds * G + 1) * S;  // in tail steps
        for (int j = b + 1; j < G && walk.tail_start(j) < item_end; ++j) {
          if (walk.tail_start(j + 1) == walk.tail_start(j)) continue;  // no steps
          if (t == 0) flag_wait(&flags[j], 1);
          named_bar_sync(1, 128);
          const float* slot = parts + (size_t)j * GD_SLOT;
#pragma unroll
          for (int q = 0; q < GD_STRIP; ++q)
#pragma unroll
            for (int g = 0; g < NG; ++g)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[q][g][i] += __ldcg(slot + ((q * NG + g) * 4 + i) * 128 + t);
          if (t == 0) flags[j] = 0;  // lowered for the next call
        }
      }
      // acc[q][g][2 h + c] =
      //   out[e][8 g + 2 (lane % 4) + c][n0 + 64 q + 16 warp + lane / 4 + 8 h]
      __nv_bfloat16* o = out + (size_t)e * M * N;
      const int row = 2 * (lane % 4);
#pragma unroll
      for (int q = 0; q < GD_STRIP; ++q) {
        const int col = n0 + q * D_TILE + 16 * warp + lane / 4;
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int r = 8 * g + row + c;
              if (r < M && col + 8 * h < N)
                o[(size_t)r * N + col + 8 * h] = __float2bfloat16(acc[q][g][2 * h + c]);
            }
      }
    }
    p += k1 - k0;
  }
}

template <bool WT, int NG, int BPS>
cudaError_t launch_grouped_decode(const CUtensorMap& xmap, const CUtensorMap& wmap, void* out,
                                  void* scratch, int slots, int E, int M, int N, int K,
                                  int blocks, cudaStream_t s) {
  static hopper::SmemRaised raised;
  float* parts = static_cast<float*>(scratch);
  int* flags = reinterpret_cast<int*>(parts + (size_t)slots * GD_SLOT);
  return hopper::launch_cluster(matmul_grouped_decode_kernel<WT, NG, BPS>, raised, dim3(blocks),
                                D_THREADS, GroupedDecodeTiles<NG, BPS>::SMEM, 1, s, xmap, wmap,
                                static_cast<__nv_bfloat16*>(out), parts, flags, E, M, N, K);
}

// Two blocks an SM take at most 16 rows (their registers hold no more
// accumulators).
template <bool WT, int BPS>
cudaError_t launch_grouped_decode_groups(const CUtensorMap& xmap, const CUtensorMap& wmap,
                                         void* out, void* scratch, int slots, int E, int M,
                                         int N, int K, int blocks, cudaStream_t s) {
  switch (row_groups(M)) {
    case 1:
      return launch_grouped_decode<WT, 1, BPS>(xmap, wmap, out, scratch, slots, E, M, N, K,
                                               blocks, s);
    case 2:
      return launch_grouped_decode<WT, 2, BPS>(xmap, wmap, out, scratch, slots, E, M, N, K,
                                               blocks, s);
  }
  if constexpr (BPS == 1) {
    if (row_groups(M) == 4)
      return launch_grouped_decode<WT, 4, 1>(xmap, wmap, out, scratch, slots, E, M, N, K,
                                             blocks, s);
    return launch_grouped_decode<WT, 8, 1>(xmap, wmap, out, scratch, slots, E, M, N, K,
                                           blocks, s);
  }
  return cudaErrorInvalidValue;
}

// The most grouped decode blocks (of M's row groups, BPS's ring) an SM
// holds at once.
template <int NG, int BPS>
int grouped_decode_per_sm() {
  static hopper::SmemRaised raised;
  auto kernel = matmul_grouped_decode_kernel<false, NG, BPS>;
  int n = 0;
  if (hopper::allow_smem(kernel, GroupedDecodeTiles<NG, BPS>::SMEM, raised) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, D_THREADS,
                                                    GroupedDecodeTiles<NG, BPS>::SMEM) !=
          cudaSuccess)
    return -1;
  return n;
}

template <int BPS>
int grouped_decode_per_sm_of(int M) {
  switch (row_groups(M)) {
    case 1: return grouped_decode_per_sm<1, BPS>();
    case 2: return grouped_decode_per_sm<2, BPS>();
  }
  if constexpr (BPS == 1) return row_groups(M) == 4 ? grouped_decode_per_sm<4, 1>()
                                                    : grouped_decode_per_sm<8, 1>();
  return -1;
}

// The map of w, read in place in the boxes of box_k k by box_n output
// columns: w_t = 0 is row-major (K, N), w_t = 1 the transpose of a row-major
// (N, K) array.
bool make_w_map(CUtensorMap* map, const void* w, int N, int K, int w_t, uint32_t box_k,
                uint32_t box_n) {
  return w_t ? hopper::make_map_2d(map, w, K, N, box_k, box_n)
             : hopper::make_map_2d(map, w, N, K, box_n, box_k);
}

template <bool XT, bool WT, bool G, int BN>
cudaError_t launch_prefill(const CUtensorMap& xmap, const CUtensorMap& wmap,
                           const CUtensorMap& omap, void* out, int E, int M, int N, int K,
                           int splits, int steps_per_split, int max_blocks, int tma_out,
                           cudaStream_t s) {
  static hopper::SmemRaised raised;
  const long tiles = (long)E * ((M + G_BM - 1) / G_BM) * ((N + BN - 1) / BN);
  const long clusters = std::min(tiles, (long)std::max(1, max_blocks / splits));
  return hopper::launch_cluster(matmul_wgmma_kernel<XT, WT, G, BN>, raised,
                                dim3((unsigned)(clusters * splits)), G_THREADS,
                                Prefill<BN>::SMEM, splits, s, xmap, wmap, omap,
                                static_cast<__nv_bfloat16*>(out), E, M, N, K, splits,
                                steps_per_split, tma_out);
}

// The layouts the prefill kernel is built for: x row-major with w either
// way, or x^T read in place with a row-major w (dw = x^T dy).
template <bool G, int BN>
cudaError_t launch_prefill_layout(int x_t, int w_t, const CUtensorMap& xmap,
                                  const CUtensorMap& wmap, const CUtensorMap& omap, void* out,
                                  int E, int M, int N, int K, int splits, int steps,
                                  int max_blocks, int tma_out, cudaStream_t s) {
  if (x_t)
    return launch_prefill<true, false, G, BN>(xmap, wmap, omap, out, E, M, N, K, splits, steps,
                                              max_blocks, tma_out, s);
  if (w_t)
    return launch_prefill<false, true, G, BN>(xmap, wmap, omap, out, E, M, N, K, splits, steps,
                                              max_blocks, tma_out, s);
  return launch_prefill<false, false, G, BN>(xmap, wmap, omap, out, E, M, N, K, splits, steps,
                                             max_blocks, tma_out, s);
}

template <bool G>
cudaError_t launch_prefill_tile(int tile_n, int x_t, int w_t, const CUtensorMap& xmap,
                                const CUtensorMap& wmap, const CUtensorMap& omap, void* out,
                                int E, int M, int N, int K, int splits, int steps,
                                int max_blocks, int tma_out, cudaStream_t s) {
  if (tile_n == 256)
    return launch_prefill_layout<G, 256>(x_t, w_t, xmap, wmap, omap, out, E, M, N, K, splits,
                                         steps, max_blocks, tma_out, s);
  return launch_prefill_layout<G, 128>(x_t, w_t, xmap, wmap, omap, out, E, M, N, K, splits,
                                       steps, max_blocks, tma_out, s);
}

// What the prefill entry points refuse: a bad shape, x^T with a transposed
// w, a K split that is not `splits` non-empty runs of steps_per_split.
bool prefill_args_bad(int E, int M, int N, int K, int x_t, int w_t, int tile_n, int splits,
                      int steps_per_split, int max_blocks) {
  const int steps = (K + G_BK - 1) / G_BK;
  return E < 1 || E > 65535 || M < 1 || N < 1 || K < 1 || (x_t && w_t) ||
         (tile_n != 128 && tile_n != 256) || splits < 1 || splits > hopper::MAX_CLUSTER ||
         steps_per_split < 1 || (splits - 1) * steps_per_split >= steps ||
         splits * steps_per_split < steps || max_blocks < 1;
}

// ------------------------------------------- fp32 path, element-wise loads
// fp32 what TMA cannot map (a stride not a multiple of 16 bytes, a
// misaligned tensor) and the grouped fp32 products: 64 x 64 tiles loaded
// element by element through shared memory, 4 x 4 FFMA a thread.
constexpr int FBM = 64, FBN = 64, FBK = 16, FTHREADS = 256;

// G: a grouped product, blockIdx.z the expert e of x (E, M, K), w (E, K, N)
// (WT: the transpose of a row-major (E, N, K), expert e's (N, K) block at
// the same offset e K N) and out (E, M, N), K unsplit; otherwise
// blockIdx.z the split.
template <bool WT, bool G>
__global__ void __launch_bounds__(FTHREADS)
matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, float* __restrict__ ws, int M, int N,
                  int K, int k_per_split) {
  __shared__ float As[FBK][FBM + 1];  // k-major: As[k][m]
  __shared__ float Bs[FBK][FBN + 1];  // Bs[k][n]
  const int n0 = blockIdx.x * FBN, m0 = blockIdx.y * FBM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  int k_begin = blockIdx.z * k_per_split, k_end = min(K, k_begin + k_per_split);
  if (G) {
    const size_t e = blockIdx.z;
    x += e * M * K;
    w += e * K * N;
    out += e * M * N;
    k_begin = 0;
    k_end = K;
  }
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

// ------------------------------------------------------ fp32 path, TMA ring
// fp32 products whose strides TMA maps (16-byte multiples) and whose
// tensors are 16-byte aligned: deepseek_moe_16b's router (M 4 at a decode
// step, 2048 at a prefill; K 2048, N 64) and its training dx (w read
// transposed) and dw (x^T read in place), and every fp32 parity product.
// True fp32: FFMA on the CUDA cores.  A block of 8 FFMA warps and a
// producer warp owns a BM x BN output tile, BM shaped to M (8, 32, 64 or
// 128 rows, so a decode step's 4 rows fill half a tile, not a 64th; BN 32
// at 8 rows, so a narrow output still spreads its weight over twice the
// SMs, 64 otherwise), and a run of K: the producer keeps a ring of 32-deep
// stages filled by TMA (x and w tiles; a tile read along k, x row-major or
// w transposed, in 128-byte swizzled rows, which spreads the threads'
// float4 reads over the banks; one read along m or n in plain rows), with
// a full and an empty mbarrier a stage; each FFMA thread owns TM x TN
// outputs, reads four k of each operand a time and loads the next four
// while it multiplies these; two blocks an SM (so clusters of 8 fit the SMs
// of a GPC).  Where the output's tiles fall short of the SMs, K is cut into
// runs, the blocks of a cluster (at most 8): each block writes its fp32
// partial tile over its quiet ring, and after a cluster barrier sums its
// share of the tile over every block's partial, in rank order, through
// distributed shared memory.  One launch, no workspace, no atomics: two
// calls give the same bits.  TMA zero-fills the ragged edges.
constexpr int F_BK = 32;  // k a stage

template <int BM>
struct F32Tiles {
  static constexpr int BN = BM == 8 ? 32 : 64;   // output columns a block
  static constexpr int CONSUMERS = 256;          // 8 FFMA warps
  static constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
  static constexpr int TY = BM == 8 ? 8 : 16;    // threads along m
  static constexpr int TX = CONSUMERS / TY;      // threads along n: 32 or 16
  static constexpr int TM = BM / TY;             // rows a thread: 1, 2, 4, 8
  static constexpr int TN = BN / TX;             // columns a thread: 1 or 4
  static constexpr int RING = 96 * 1024;         // two blocks an SM
  static constexpr int A_BYTES = BM * F_BK * 4;
  static constexpr int STAGE = A_BYTES + F_BK * BN * 4;
  static constexpr int STAGES = RING / STAGE < 8 ? RING / STAGE : 8;
  static constexpr int PSTRIDE = BN + 4;  // partial rows, padded against bank conflicts
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(BM * PSTRIDE * 4 <= STAGES * STAGE, "the partial tile fits the ring");
  static_assert(A_BYTES % 1024 == 0 && STAGE % 1024 == 0, "swizzled tiles 1024-aligned");
};

// W consecutive floats of shared memory into registers, in the widest loads
// their alignment allows (W floats from a W-aligned offset).
template <int W>
__device__ __forceinline__ void lds_run(float (&d)[W], const float* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      d[4 * q] = v.x;
      d[4 * q + 1] = v.y;
      d[4 * q + 2] = v.z;
      d[4 * q + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x;
    d[1] = v.y;
  } else {
    d[0] = *p;
  }
}

// The four k of float4 chunk c of row r of a 128-byte swizzled tile of
// 32-float rows (TMA's 128-byte swizzle: chunk c of row r at c ^ (r % 8)).
__device__ __forceinline__ void lds_swizzled(float (&d)[4], const float* tile, int r, int c) {
  const float4 v = *reinterpret_cast<const float4*>(tile + r * F_BK + ((c ^ (r & 7)) << 2));
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// Thread (ty, tx)'s operands of float4 chunk c (k 4 c .. 4 c + 3) of a
// stage: a[i][kk] of its rows, b[j][kk] of its columns.
template <int BM, bool XT, bool WT>
__device__ __forceinline__ void f32_operands(float (&a)[F32Tiles<BM>::TM][4],
                                             float (&b)[F32Tiles<BM>::TN][4],
                                             const float* As, const float* Bs, int ty, int tx,
                                             int c) {
  using T = F32Tiles<BM>;
  if (XT) {  // [32 k][BM m]: a run of TM rows a k
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float v[T::TM];
      lds_run<T::TM>(v, As + (4 * c + kk) * BM + ty * T::TM);
#pragma unroll
      for (int i = 0; i < T::TM; ++i) a[i][kk] = v[i];
    }
  } else {  // [BM m][32 k], swizzled: four k of a row
#pragma unroll
    for (int i = 0; i < T::TM; ++i) lds_swizzled(a[i], As, ty + T::TY * i, c);
  }
  if (WT) {  // [BN n][32 k], swizzled
#pragma unroll
    for (int j = 0; j < T::TN; ++j) lds_swizzled(b[j], Bs, tx + T::TX * j, c);
  } else {  // [32 k][BN n]: a run of TN columns a k
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float v[T::TN];
      lds_run<T::TN>(v, Bs + (4 * c + kk) * T::BN + tx * T::TN);
#pragma unroll
      for (int j = 0; j < T::TN; ++j) b[j][kk] = v[j];
    }
  }
}

// Block (rank, tile_m, tile_n) of a grid (splits, M / BM, N / BN), clusters
// of `splits` along x: output rows m0 .. m0 + BM - 1, columns n0 .. + BN -
// 1, k steps rank x steps_per_split .. + steps_per_split - 1.  XT: x is
// read as the transpose of a row-major (K, M) (dw = x^T dy); WT: w as the
// transpose of a row-major (N, K) (dx = dy w^T).  FFMA thread (ty, tx)
// owns rows ty + TY i (x^T: ty TM + i) and columns tx TN + j (w^T: tx + TX
// j): each thread's reads of a tile read along k are rows 8 apart and stay
// on separate banks, and a tile read along m or n gives it runs of floats.
template <int BM, bool XT, bool WT>
__global__ void __launch_bounds__(F32Tiles<BM>::THREADS, 2)
matmul_f32_ring_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, float* __restrict__ out,
                       int M, int N, int K, int steps_per_split) {
  using namespace hopper;
  using T = F32Tiles<BM>;
  constexpr int TM = T::TM, TN = T::TN, BN = T::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* part = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;

  const int splits = gridDim.x, rank = splits > 1 ? (int)cluster_rank() : 0;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const int k_first = rank * steps_per_split;
  const int nsteps = min(steps_per_split, (K + F_BK - 1) / F_BK - k_first);
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::CONSUMERS / 32);  // one arrival per FFMA warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = threadIdx.x / T::TX, tx = threadIdx.x % T::TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (warp == T::CONSUMERS / 32) {  // producer warp: one thread issues every load
    if (lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % T::STAGES;
        if (i >= T::STAGES) mbar_wait(&empty[s], ((i / T::STAGES) + 1) & 1);
        unsigned char* a = smem + s * T::STAGE;
        const int k0 = (k_first + i) * F_BK;
        mbar_arrive_expect_tx(&full[s], T::STAGE);
        if (XT) tma_load_2d(a, &xmap, &full[s], m0, k0);  // [32 k][BM m]
        else tma_load_2d(a, &xmap, &full[s], k0, m0);     // [BM m][32 k], swizzled
        if (WT) tma_load_2d(a + T::A_BYTES, &wmap, &full[s], k0, n0);  // [BN n][32 k], swizzled
        else tma_load_2d(a + T::A_BYTES, &wmap, &full[s], n0, k0);     // [32 k][BN n]
      }
    }
    __syncwarp();
  } else {
    for (int i = 0; i < nsteps; ++i) {
      const int s = i % T::STAGES;
      mbar_wait(&full[s], (i / T::STAGES) & 1);
      const float* As = reinterpret_cast<const float*>(smem + s * T::STAGE);
      const float* Bs = reinterpret_cast<const float*>(smem + s * T::STAGE + T::A_BYTES);
      float a[2][TM][4], b[2][TN][4];  // chunk c's operands and chunk c + 1's
      f32_operands<BM, XT, WT>(a[0], b[0], As, Bs, ty, tx, 0);
#pragma unroll
      for (int c = 0; c < F_BK / 4; ++c) {  // four k a time
        if (c + 1 < F_BK / 4)
          f32_operands<BM, XT, WT>(a[(c + 1) & 1], b[(c + 1) & 1], As, Bs, ty, tx, c + 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[r][j] = fmaf(a[c & 1][r][kk], b[c & 1][j][kk], acc[r][j]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  const bool ffma = warp < T::CONSUMERS / 32;
  if (splits == 1) {
    if (!ffma) return;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int gm = m0 + (XT ? ty * TM + r : ty + T::TY * r);
      if (gm >= M) continue;
      float* o = out + (size_t)gm * N + n0;
      if (WT || TN == 1) {  // any N
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = WT ? tx + T::TX * j : tx * TN + j;
          if (n0 + col < N) o[col] = acc[r][j];
        }
      } else if (n0 + tx * TN < N) {  // N % 4 == 0: the thread's run lies inside
        *reinterpret_cast<float4*>(o + tx * TN) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    return;
  }

  // K cut over the cluster: the partial tile over the ring, quiet once
  // every FFMA warp is past its last stage
  if (ffma) {
    named_bar_sync(1, T::CONSUMERS);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        part[(XT ? ty * TM + r : ty + T::TY * r) * T::PSTRIDE +
             (WT ? tx + T::TX * j : tx * TN + j)] = acc[r][j];
  }
  __syncwarp();
  cluster_sync();
  // block `rank` sums every splits-th run of four columns over every
  // block's partial, in rank order
  for (int idx = rank * T::THREADS + threadIdx.x; idx < BM * (BN / 4);
       idx += splits * T::THREADS) {
    const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {
      if (q >= splits) break;
      const float4 v = ld_dsmem_f32x4(part + r * T::PSTRIDE + c, q);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    float* o = out + (size_t)gm * N + gn;
    if (N % 4 == 0) {
      *reinterpret_cast<float4*>(o) = sum;
    } else {
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int k = 0; k < 4 && gn + k < N; ++k) o[k] = v[k];
    }
  }
  cluster_sync();
}

template <int BM, bool XT, bool WT>
cudaError_t launch_f32(const CUtensorMap& xmap, const CUtensorMap& wmap, void* out, int M,
                       int N, int K, int splits, int steps_per_split, cudaStream_t s) {
  static hopper::SmemRaised raised;
  constexpr int BN = F32Tiles<BM>::BN;
  const dim3 grid(splits, (M + BM - 1) / BM, (N + BN - 1) / BN);
  return hopper::launch_cluster(matmul_f32_ring_kernel<BM, XT, WT>, raised, grid,
                                F32Tiles<BM>::THREADS, F32Tiles<BM>::SMEM, splits, s, xmap, wmap,
                                static_cast<float*>(out), M, N, K, steps_per_split);
}

template <int BM>
cudaError_t launch_f32_layout(int x_t, int w_t, const CUtensorMap& xmap, const CUtensorMap& wmap,
                              void* out, int M, int N, int K, int splits, int steps,
                              cudaStream_t s) {
  if (x_t) return launch_f32<BM, true, false>(xmap, wmap, out, M, N, K, splits, steps, s);
  if (w_t) return launch_f32<BM, false, true>(xmap, wmap, out, M, N, K, splits, steps, s);
  return launch_f32<BM, false, false>(xmap, wmap, out, M, N, K, splits, steps, s);
}

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
    auto xb = static_cast<const __nv_bfloat16*>(x);
    auto wb = static_cast<const __nv_bfloat16*>(w);
    auto ob = static_cast<__nv_bfloat16*>(out);
    if (w_t) matmul_bf16_kernel<true><<<grid, THREADS, 0, s>>>(xb, wb, ob, wsf, M, N, K, k_per);
    else matmul_bf16_kernel<false><<<grid, THREADS, 0, s>>>(xb, wb, ob, wsf, M, N, K, k_per);
  } else if (dtype == 0) {
    const int k_per = ((K + FBK - 1) / FBK + splits - 1) / splits * FBK;
    const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, splits);
    auto xf = static_cast<const float*>(x);
    auto wf = static_cast<const float*>(w);
    auto of = static_cast<float*>(out);
    if (w_t) matmul_f32_kernel<true, false><<<grid, FTHREADS, 0, s>>>(xf, wf, of, wsf, M, N, K, k_per);
    else matmul_f32_kernel<false, false><<<grid, FTHREADS, 0, s>>>(xf, wf, of, wsf, M, N, K, k_per);
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

// The fp32 path of TMA's strides: x (M, K) row-major, or (x_t = 1) the
// transpose of a row-major (K, M) read in place; w as streamed_matmul's w_t
// (row-major when x_t = 1).  Output tiles of tile_m (8, 32, 64 or 128) rows
// by 32 (tile_m 8) or 64 columns; K cut into `splits` (<= 8) runs of
// steps_per_split 32-deep steps, each run non-empty, the blocks of a
// cluster.  The caller routes here only when the strides TMA maps are
// multiples of 16 bytes (K % 4 == 0 for a row-major x or a transposed w,
// M % 4 == 0 for x^T, N % 4 == 0 for a row-major w) and x and w are 16-byte
// aligned.  One launch, no workspace.  Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue for what the kernel does not take or a
// tensor map refused.
extern "C" int streamed_matmul_f32(const void* x, const void* w, void* out, int M, int N, int K,
                                   int x_t, int w_t, int tile_m, int splits,
                                   int steps_per_split, void* stream) {
  const int steps = (K + F_BK - 1) / F_BK;
  if (M < 1 || N < 1 || K < 1 || (x_t && w_t) || (!w_t && N % 4) ||
      (tile_m != 8 && tile_m != 32 && tile_m != 64 && tile_m != 128) || splits < 1 ||
      splits > hopper::MAX_CLUSTER || steps_per_split < 1 ||
      (splits - 1) * steps_per_split >= steps || splits * steps_per_split < steps)
    return static_cast<int>(cudaErrorInvalidValue);
  // x in [tile_m][32] swizzled boxes, or x^T in [32][tile_m]; w in [32][bn]
  // boxes, or w^T in [bn][32] swizzled
  const int bn = tile_m == 8 ? F32Tiles<8>::BN : F32Tiles<128>::BN;
  CUtensorMap xmap, wmap;
  if (!(x_t ? hopper::make_map_f32_2d(&xmap, x, M, K, tile_m, F_BK, false)
            : hopper::make_map_f32_2d(&xmap, x, K, M, F_BK, tile_m, true)) ||
      !(w_t ? hopper::make_map_f32_2d(&wmap, w, K, N, F_BK, bn, true)
            : hopper::make_map_f32_2d(&wmap, w, N, K, bn, F_BK, false)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int per = steps_per_split;
  switch (tile_m) {
    case 8: err = launch_f32_layout<8>(x_t, w_t, xmap, wmap, out, M, N, K, splits, per, s); break;
    case 32: err = launch_f32_layout<32>(x_t, w_t, xmap, wmap, out, M, N, K, splits, per, s); break;
    case 64: err = launch_f32_layout<64>(x_t, w_t, xmap, wmap, out, M, N, K, splits, per, s); break;
    default: err = launch_f32_layout<128>(x_t, w_t, xmap, wmap, out, M, N, K, splits, per, s);
  }
  return static_cast<int>(err);
}

// The prefill path: bf16 x (M, K) row-major, or (x_t = 1) the transpose of
// a row-major (K, M) read in place, w as streamed_matmul's w_t (row-major
// when x_t = 1).  K is cut into `splits` (<= 8) runs of steps_per_split
// 64-deep steps, each run non-empty, the blocks of a cluster; at most
// max_blocks blocks (the SMs) walk the tiles.  The caller routes here only
// when M >= 64, the strides TMA maps are multiples of 16 bytes (K % 8 == 0
// for a row-major x or a transposed w, M % 8 == 0 for x^T, N % 8 == 0 for a
// row-major w) and x and w are 16-byte aligned.  One launch, no workspace.
// Returns the cudaError_t of the launch, or cudaErrorInvalidValue for what
// the kernel does not take or a tensor map refused.
extern "C" int streamed_matmul_wgmma(const void* x, const void* w, void* out, int M, int N,
                                     int K, int x_t, int w_t, int tile_n, int splits,
                                     int steps_per_split, int max_blocks, void* stream) {
  // x in 128-row boxes, or x^T in 64 (m) x 64 (k) boxes; w in one tile_n x
  // 64 box per stage (w_t = 1), or tile_n / 64 boxes of 64 x 64 (w_t = 0:
  // the columns of an MN-major tile); out in 64 x 64 boxes where N % 8 == 0
  CUtensorMap xmap, wmap, omap = {};
  const int tma_out = N % 8 == 0;
  if (prefill_args_bad(1, M, N, K, x_t, w_t, tile_n, splits, steps_per_split, max_blocks) ||
      !(x_t ? hopper::make_map_2d(&xmap, x, M, K, 64, G_BK)
            : hopper::make_map_2d(&xmap, x, K, M, G_BK, G_BM)) ||
      !make_w_map(&wmap, w, N, K, w_t, G_BK, w_t ? tile_n : 64) ||
      (tma_out && !hopper::make_map_2d(&omap, out, N, M, 64, 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_prefill_tile<false>(
      tile_n, x_t, w_t, xmap, wmap, omap, out, 1, M, N, K, splits, steps_per_split, max_blocks,
      tma_out, static_cast<cudaStream_t>(stream)));
}

// The most clusters of `splits` prefill blocks that the card runs at once
// (cudaOccupancyMaxActiveClusters; every instantiation has the same shared
// memory and threads): a cluster occupies SMs of one GPC, so 8-block
// clusters fit fewer than SMs / 8.  The host's plan keeps a split's tiles
// within it (one wave).  Returns -1 if the query fails.
extern "C" int streamed_matmul_prefill_max_clusters(int tile_n, int splits) {
  static hopper::SmemRaised raised128, raised256;
  if (splits < 1 || splits > hopper::MAX_CLUSTER || (tile_n != 128 && tile_n != 256)) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(G_THREADS);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t err;
  if (tile_n == 128) {
    auto kernel = matmul_wgmma_kernel<false, false, false, 128>;
    cfg.dynamicSmemBytes = Prefill<128>::SMEM;
    err = hopper::allow_smem(kernel, Prefill<128>::SMEM, raised128);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  } else {
    auto kernel = matmul_wgmma_kernel<false, false, false, 256>;
    cfg.dynamicSmemBytes = Prefill<256>::SMEM;
    err = hopper::allow_smem(kernel, Prefill<256>::SMEM, raised256);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  }
  return err == cudaSuccess ? n : -1;
}

// The decode path: bf16 x (M, K) row-major with 1 <= M < 64, w as
// streamed_matmul's w_t, under the prefill path's TMA rules.  K is cut into
// `splits` (<= 8) ranges of steps_per_split 64-deep steps, each range
// non-empty.  One launch, no workspace.  Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int streamed_matmul_decode(const void* x, const void* w, void* out, int M, int N,
                                      int K, int w_t, int splits, int steps_per_split,
                                      void* stream) {
  const int steps = (K + D_TILE - 1) / D_TILE;
  if (M < 1 || M >= 64 || N < 1 || K < 1 || splits < 1 || splits > hopper::MAX_CLUSTER ||
      steps_per_split < 1 || (splits - 1) * steps_per_split >= steps ||
      splits * steps_per_split < steps)
    return static_cast<int>(cudaErrorInvalidValue);
  // x in boxes of all its row groups (rows past M read zero), w in 64 x 64
  CUtensorMap xmap, wmap;
  if (!hopper::make_map_2d(&xmap, x, K, M, D_TILE, 8 * row_groups(M)) ||
      !make_w_map(&wmap, w, N, K, w_t, D_TILE, D_TILE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      w_t ? launch_decode_groups<true>(xmap, wmap, out, M, N, K, splits, steps_per_split, s)
          : launch_decode_groups<false>(xmap, wmap, out, M, N, K, splits, steps_per_split, s));
}

// ------------------------------------------------------------- grouped
// out (E, M, N) = x (E, M, K) @ w (E, K, N), one product per expert, x and
// out row-major and contiguous, in one launch: the prefill and element-wise
// fp32 kernels above with a grid dimension over the experts, and at a
// decode step the persistent grouped decode kernel.  w is as
// streamed_matmul's w_t, per
// expert: w_t = 0 a contiguous row-major (E, K, N); w_t = 1 the transpose
// of a contiguous row-major (E, N, K) (an MoE backward's dx = dy w^T reads
// the forward's w in place).  The bf16 maps are rank 3, (E, rows, cols)
// with boxes inside one expert, so a ragged M, N or K zero-fills within the
// expert and never reads the next one's rows.  The caller routes bf16 here
// only when K % 8 == 0, N % 8 == 0 for w_t = 0, and x and w are 16-byte
// aligned.

// The map of E stacked row-major bf16 matrices (E, rows, cols), in boxes of
// box_rows rows of box_cols (64) elements of one matrix.
static bool make_stack_map(CUtensorMap* map, const void* ptr, int E, int rows, int cols,
                           uint32_t box_cols, uint32_t box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)E};
  const uint64_t strides[2] = {(uint64_t)cols * 2, (uint64_t)rows * cols * 2};
  const uint32_t box[3] = {box_cols, box_rows, 1};
  return hopper::make_map_bf16(map, ptr, 3, dims, strides, box);
}

// The rank-3 map of a grouped w, as make_w_map's of one expert: w_t = 0
// (E, K, N) rows in boxes of box_k k by box_n columns, w_t = 1 (E, N, K)
// rows in boxes of box_n columns by box_k k.
static bool make_w_stack_map(CUtensorMap* map, const void* w, int E, int N, int K, int w_t,
                             uint32_t box_k, uint32_t box_n) {
  return w_t ? make_stack_map(map, w, E, N, K, box_k, box_n)
             : make_stack_map(map, w, E, K, N, box_n, box_k);
}

// M >= 64: the prefill kernel per expert, its arguments as
// streamed_matmul_wgmma's; x_t = 1: x is the transpose of a contiguous (E,
// K, M) (a backward's dw = x^T dy: expert e's (C, d) rows read in place,
// the capacity C its K, which need not be a multiple of 8).
extern "C" int streamed_matmul_grouped_wgmma(const void* x, const void* w, void* out, int E,
                                             int M, int N, int K, int x_t, int w_t, int tile_n,
                                             int splits, int steps_per_split, int max_blocks,
                                             void* stream) {
  CUtensorMap xmap, wmap, omap = {};
  const int tma_out = N % 8 == 0;
  if (prefill_args_bad(E, M, N, K, x_t, w_t, tile_n, splits, steps_per_split, max_blocks) ||
      !(x_t ? make_stack_map(&xmap, x, E, K, M, 64, G_BK)
            : make_stack_map(&xmap, x, E, M, K, G_BK, G_BM)) ||
      !make_w_stack_map(&wmap, w, E, N, K, w_t, G_BK, w_t ? tile_n : 64) ||
      (tma_out && !make_stack_map(&omap, out, E, M, N, 64, 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_prefill_tile<true>(
      tile_n, x_t, w_t, xmap, wmap, omap, out, E, M, N, K, splits, steps_per_split, max_blocks,
      tma_out, static_cast<cudaStream_t>(stream)));
}

// 1 <= M < 64: the persistent grouped decode kernel with the ring of
// `bps` blocks an SM (1, or 2 for M <= 16), `blocks` blocks (at most the card holds at
// once, streamed_matmul_grouped_decode_per_sm, and at most the steps),
// `scratch` the parts and flags of `slots` >= blocks
// blocks (slots x GD_SLOT floats, then slots ints, the flags zero between
// calls: each call lowers the flags it raised).  A call must not run
// beside another on the same scratch.
extern "C" int streamed_matmul_grouped_decode(const void* x, const void* w, void* out,
                                              void* scratch, int slots, int E, int M, int N,
                                              int K, int w_t, int bps, int blocks,
                                              void* stream) {
  const long long W = (long long)E * ((N + GD_STRIP * D_TILE - 1) / (GD_STRIP * D_TILE)) *
                      ((K + GD_STEP - 1) / GD_STEP);
  if (E < 1 || E > 65535 || M < 1 || M >= 64 || N < 1 || K < 1 || (bps != 1 && bps != 2) ||
      (bps == 2 && row_groups(M) > 2) || blocks < 1 || blocks > slots || blocks > W ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  if (!make_stack_map(&xmap, x, E, M, K, D_TILE, 8 * row_groups(M)) ||
      !make_w_stack_map(&wmap, w, E, N, K, w_t, D_TILE, D_TILE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bps == 1)
    err = w_t ? launch_grouped_decode_groups<true, 1>(xmap, wmap, out, scratch, slots, E, M, N,
                                                      K, blocks, s)
              : launch_grouped_decode_groups<false, 1>(xmap, wmap, out, scratch, slots, E, M,
                                                       N, K, blocks, s);
  else
    err = w_t ? launch_grouped_decode_groups<true, 2>(xmap, wmap, out, scratch, slots, E, M, N,
                                                      K, blocks, s)
              : launch_grouped_decode_groups<false, 2>(xmap, wmap, out, scratch, slots, E, M,
                                                       N, K, blocks, s);
  return static_cast<int>(err);
}

// The most grouped decode blocks an SM holds at once for M rows and `bps`
// (the ring of one block an SM, 1, or of two, 2), or -1.
extern "C" int streamed_matmul_grouped_decode_per_sm(int M, int bps) {
  return bps == 1 ? grouped_decode_per_sm_of<1>(M) : grouped_decode_per_sm_of<2>(M);
}

// The grouped decode kernel's k a step, its columns an item, and the
// floats of a block's part.
extern "C" int streamed_matmul_grouped_decode_step() { return GD_STEP; }
extern "C" int streamed_matmul_grouped_decode_strip() { return GD_STRIP * D_TILE; }
extern "C" int streamed_matmul_grouped_decode_slot() { return GD_SLOT; }

// fp32: the element-wise CUDA-core kernel per expert.
extern "C" int streamed_matmul_grouped_f32(const void* x, const void* w, void* out, int E,
                                           int M, int N, int K, int w_t, void* stream) {
  if (E < 1 || E > 65535 || M < 1 || N < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto wf = static_cast<const float*>(w);
  auto of = static_cast<float*>(out);
  if (w_t) matmul_f32_kernel<true, true><<<grid, FTHREADS, 0, s>>>(xf, wf, of, nullptr, M, N, K, K);
  else matmul_f32_kernel<false, true><<<grid, FTHREADS, 0, s>>>(xf, wf, of, nullptr, M, N, K, K);
  return static_cast<int>(cudaGetLastError());
}

// The decode kernel's tile edge: output columns per block and k per step.
extern "C" int streamed_matmul_decode_tile() { return D_TILE; }
