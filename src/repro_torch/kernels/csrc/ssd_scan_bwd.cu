// ssd_scan_bwd: the backward of the Mamba-2 SSD chunk scan of ssd_scan.cu
// (one B/C group shared by the H heads, an optional initial state, the
// final state returned): given dy and the final state's cotangent, the
// gradients dx, ddt, dA, dB, dC and d init_state.
//
// The TPU kernel it serves is kernels/ssd_scan.py:ssd_scan (_ssd_kernel) of
// the JAX package, which has no backward kernel: the JAX package trains
// through models/ssd.py:ssd_scan_ref and XLA's autodiff, checkpointing each
// chunk.  The port's model calls the forward kernel for every scan, so its
// trainer needs this one.
//
// Layout: x, dy and dx (b, S, H, P) in fp32 or bf16; dt and ddt (b, S, H)
// fp32; A and dA (H,) fp32; B and C (b, S, N) in x's type with the given
// batch and sequence strides and a contiguous last dim, dB and dC (b, S, N)
// contiguous; init, dstate and dinit (b, H, P, N) fp32 or null.  (P, N) =
// (64, 128) (mamba2_1_3b) or (50, 16) (hymba_1_5b).
//
// The math, per sub-chunk of BQ = 64 rows (the forward kernels' blocking)
// with its start state s0, cum the inclusive cumsum of dt A over its rows,
// L[i,j] = exp(cum_i - cum_j) for j <= i, w_i = exp(cum_last - cum_i) and G
// the adjoint of its end state (dstate at the last sub-chunk):
//   dxdt = (L o C B^T)^T dy + w (B G^T)
//   dB_h = (L o dy xdt^T)^T C + w xdt G,  dC_h = (L o dy xdt^T) B + exp(cum) dy s0
//   dcum = rowsum(M) - colsum(M) + exp(cum) C.(dy s0) - w xdt.(B G^T)
//          (+ <G, s_end> at the last row),  M = L o (C B^T) o (dy xdt^T)
//   da = the reverse cumsum of dcum;  G <- exp(cum_last) G + (exp(cum) dy)^T C
// and dx = dt dxdt, ddt = x.dxdt + A da, dA = sum over b and S of dt da.  As in
// the forward, every decay is exp(cum_i - cum_j) with i >= j, never
// exp(-cum).  A ragged last sub-chunk is read with dt = x = B = C = dy = 0
// past S: those rows neither decay nor feed anything, their gradients are
// not stored, and the <G, s_end> that lands on the last (padded) row reaches
// the real rows through the reverse cumsum, as it must (cum is flat there).
//
// What bounds it on an H100: at mamba2's training shape (b 8, S 512, H 64,
// bf16) the function reads and writes ~0.11 GB (x, dy, dx and the fp32
// dt and ddt dominate): 0.0319 ms at 3.35 TB/s; it needs ~28 GFLOP (nine
// products per head and sub-chunk, the triangular ones halved): 0.028 ms
// at the dense bf16 peak.  So bytes bound it, just.
//
// Two routes here, two launches each, no atomics, so two runs give the
// same bits: a kernel over the sub-chunks per (head or pair of heads, batch
// row), then ssd_bwd_reduce_kernel (ssd_scan_bwd_reduce.cuh), which sums
// the dB and dC partials over the heads, and dA's over the batch rows, in a
// fixed order, one thread an output element.  (The third route, bf16 at
// (50, 16), is chunk-parallel: ssd_scan_bwd_tc.cu.)
//
// (a) ssd_bwd_wgmma_kernel, bf16 at (64, 128), mamba2_1_3b's training scan.
//   The chunked form needs each sub-chunk's start state s0 and its end
//   state's adjoint G together, so a design that walks the sub-chunks once
//   each way stores every s0 (the design before this one: a (b, H, nsub, P,
//   N) fp32 scratch, 134 MB at the train shape, ~0.54 GB of scratch traffic
//   a call with the per-pair partials).  Here no state is stored: every
//   term that reads s0 is formed in a forward pass, every term that reads G
//   in a reverse one, and the two passes run at once as blocks of their own.
//   - The split.  dC = (exp(cum) o dy) s0 + (L o dy xdt^T) B and dcum's
//     state terms R = rowsum(M) + C.((exp(cum) o dy) s0) are the forward
//     pass's; dx, dB = w xdt G + (L o dy xdt^T)^T C, dcum's other terms
//     -colsum(M) - w xdt.(B G^T), G's update and d init_state the reverse
//     pass's.  da, the reverse cumsum of dcum, is taken over the whole
//     sequence from <dstate, s_final> on the last row: its sum over a later
//     sub-chunk's rows is what the chunked form's <G, s_end> is (exact: a
//     CPU test holds the split to the plain version to 1e-10 in fp64).  The
//     reverse pass carries its share from sub-chunk to sub-chunk into ddt
//     and dt da; the forward pass stores pre_t, R summed over the rows
//     before t, (b, S, H), and tot, R's sum plus <dstate, s_final>, and its
//     dt da share tot sum(dt) - sum(dt pre); the reduce adds A (tot - pre)
//     to ddt.
//   - One block per (pair of heads, batch row, pass), a warpgroup per head
//     (256 threads, no producer warp, so ptxas allows 255 registers; no
//     spill): 512 blocks at the train shape, one an SM (215 KB of shared
//     memory).  Thread 0 asks TMA for each sub-chunk's tiles through one
//     stage (x and dy of each head, B, C, dt of a box of 4 heads); TMA fills
//     rows past S with zeros, so a ragged last sub-chunk has dt = x = B = C
//     = dy = 0 there.  The next load is issued when both warpgroups are done
//     with the stage, and lands during the step's merge.
//   - Every product is a wgmma from shared memory (m64 x {64, 128} x k16, A
//     transposed where it is read M-major): dy x^T and C B^T per head; L o
//     C B^T and L o dy (x dt)^T to bf16 tiles (stmatrix); bf16(exp(cum) o dy)
//     and bf16(x o dt w) (hi and lo in the forward pass) to tiles by an
//     elementwise pass, the latter in the merge tile, which is free between
//     merges.  Forward: (exp(cum) o dy) s0 with s0 hi and lo, in flight
//     while the scores are masked, then S2 B into the same accumulator and
//     the state's update s <- exp(cum_last) s + (x dt w)^T B in one wait.
//     Reverse: G's update, the scores and B G^T (G hi and lo) issued
//     together and in flight while the scores are masked; then dB and S1^T
//     dy.  M's row sums by quad shuffles, its column sums by shuffles and,
//     across the warps, shared memory; dcum's scans on warp 0.
//   - dB and dC summed over the heads on chip: each warpgroup writes half
//     its accumulator to a 32 KB merge tile and adds the other half to the
//     other's (the pair); then a cluster of 2 blocks (two pairs of a batch
//     row): the bulk-copy engine sends the half of the tile that the other
//     block sums (16 KB) to its receive buffer, each block sums its half
//     with what arrived and stores it in bf16: partials (b, H / 4, S, N)
//     bf16.  mbarriers, not cluster barriers, say that the half has landed
//     and that the other block has summed it, so the blocks are tied only
//     pairwise.  Two blocks a cluster: the card holds 66 such clusters at
//     once (every SM), against 30 of 4 and 15 of 8 (ssd_bwd_probe.py), and
//     a wave of 120 SMs took the train shape to three waves.
//   Rounding: only products' operands are bf16: L o C B^T, L o dy (x dt)^T,
//   exp(cum) o dy (the same bf16 in G's update and in R: with dy s0 scaled
//   after the product, dA missed 1e-2 of its largest value), x o dt o w in
//   dB, G in dB, and the partials.  Three are a bf16 pair hi + lo (two
//   products each): s0 in (exp(cum) o dy) s0, x o dt o w in the state's
//   update and G in B G^T; with one bf16 each, dA (a sum over every row
//   whose terms cancel) missed 1e-2 on a ragged S (a CPU model of these
//   roundings, tests/test_torch_ssd_bwd.py).  The states, G, every dcum term
//   and its sums are fp32.
//   Scratch at the train shape: the partials 16.8 MB each, pre 1 MB,
//   written once and read once: 69 MB (ssd_scan.py:bwd_scratch_bytes),
//   against the function's own ~0.11 GB.
//   Measured (one H100 80GB HBM3 at 700 W, launch/ssd_bwd_probe.py time
//   against the parent in one call, PERF.md §6): 0.293 ms a call at the
//   train shape (0.350 before), 9.2x its byte bound; 0.309 at (8, 449) from
//   an initial state (0.352), 0.587 at (1, 4096) (1.026), 0.150 at a rank's
//   H 32 (0.181).  What bounds it now is each block's sub-chunk chain: a
//   reverse step is ~16,000 clocks of dependent phases
//   (tools/ssd_bwd_trace.py), ~1,000 of them tensor work; the merge takes
//   4,000-6,000, masking the scores ~2,700, the scores' and B G^T's wait
//   ~2,500.
//
// (b) ssd_bwd_kernel, the CUDA cores in fp32: fp32 at either (P, N), the
//   parity route.  (bf16 at (50, 16), hymba_1_5b's training scan, took it
//   too, 1.3140 ms at b 2, S 2048, H 64 on one H100 80GB HBM3 at 700 W, 54x
//   its byte bound, the sub-chunk chain its bound; it has its own route
//   now, ssd_scan_bwd_tc.cu.)  One block of 256 threads per (head, batch row).  Pass 1
//   walks the sub-chunks in order and writes each one's start state and the
//   final state to a scratch (b, H, nsub + 1, P, N) fp32, as the forward
//   would carry them.  Pass 2 walks them in reverse with G in shared memory:
//   every operand of the sub-chunk in shared memory in fp32 (rows padded to
//   an odd length, so that a warp's column reads fall in distinct banks; P
//   padded to a multiple of 4 with zeros), each product a loop of 4 x 4
//   register tiles per thread, the row sums and the reverse cumsum in a
//   fixed order.  dx and ddt are stored per head; dB and dC, which the heads
//   share, as per-head fp32 partials (b, H, S, N), and dA's as (b, H).
//   Shared memory: x, dy and dxdt of 64 x 65, B, C, G, s0 (then exp(cum) dy
//   s0) of 64 x 129, the two 64 x 65 score tiles and the row vectors: 213 KB
//   at (64, 128), one block per SM; 162-168 registers, no spill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"
#include "ssd_scan_bwd_reduce.cuh"

namespace {

constexpr int BQ = 64;   // rows per sub-chunk
constexpr int BT = 256;  // threads per block

// A (R x CC) output cut into 4 x 4 register tiles: tile t of the (R / 4) x
// (CC / 4) grid holds rows t / TC + TR i and columns t % TC + TC j, i, j < 4,
// so that a warp's reads of neighbouring columns are neighbouring addresses.
template <int R, int CC>
struct Grid4 {
  static_assert(R % 4 == 0 && CC % 4 == 0, "4 x 4 register tiles");
  static constexpr int TR = R / 4, TC = CC / 4, COUNT = TR * TC;
  static constexpr int PER = (COUNT + BT - 1) / BT;  // tiles per thread
};

// acc[u][4 i + j] (+)= sum_k a(r_i, k) b(k, c_j) over this thread's tiles u
// (tile threadIdx.x + BT u), a and b reading shared memory.
template <int R, int CC, int K, bool ACC = false, typename FA, typename FB>
__device__ __forceinline__ void product(float (&acc)[Grid4<R, CC>::PER][16], FA a, FB b) {
  using Gd = Grid4<R, CC>;
#pragma unroll
  for (int u = 0; u < Gd::PER; ++u) {
    if (!ACC) {
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[u][e] = 0.f;
    }
    const int t = threadIdx.x + BT * u;
    if (Gd::COUNT % BT != 0 && t >= Gd::COUNT) continue;
    const int tr = t / Gd::TC, tc = t % Gd::TC;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a(tr + Gd::TR * i, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b(k, tc + Gd::TC * j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[u][4 * i + j] = fmaf(av[i], bv[j], acc[u][4 * i + j]);
    }
  }
}

// fe(row, column, value) over this thread's tiles of `acc`
template <int R, int CC, typename FE>
__device__ __forceinline__ void each(const float (&acc)[Grid4<R, CC>::PER][16], FE fe) {
  using Gd = Grid4<R, CC>;
#pragma unroll
  for (int u = 0; u < Gd::PER; ++u) {
    const int t = threadIdx.x + BT * u;
    if (Gd::COUNT % BT != 0 && t >= Gd::COUNT) continue;
    const int tr = t / Gd::TC, tc = t % Gd::TC;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) fe(tr + Gd::TR * i, tc + Gd::TC * j, acc[u][4 * i + j]);
  }
}

// Shared memory of ssd_bwd_kernel<P, N>, in floats
template <int P, int N>
struct BwdSmem {
  static constexpr int PP = (P + 3) / 4 * 4;  // P padded to the register tiles
  static constexpr int LX = PP + 1, LN = N + 1, LQ = BQ + 1;  // odd row lengths
  static constexpr int RS = PP > BQ ? PP : BQ;  // rows of s0, then of exp(cum) dy s0
  static constexpr int X = 0, DY = X + BQ * LX, DX = DY + BQ * LX, BS = DX + BQ * LX,
                       CS = BS + BQ * LN, GS = CS + BQ * LN, SB = GS + PP * LN,
                       S1 = SB + RS * LN, S2 = S1 + BQ * LQ, V = S2 + BQ * LQ;
  static constexpr int NV = 9;  // row vectors of BQ floats, then the warps' sums
  static constexpr int BYTES = (V + NV * BQ + BT / 32) * 4;
  static_assert(BYTES <= 232448, "more shared memory than a block may have");
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(BT, 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const T* __restrict__ dy,
               const float* __restrict__ init, const float* __restrict__ dstate,
               T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dBh,
               float* __restrict__ dCh, float* __restrict__ dAh, float* __restrict__ dinit,
               float* __restrict__ states, int S, int H, int b_sb, int b_ss, int c_sb,
               int c_ss) {
  using Sm = BwdSmem<P, N>;
  constexpr int PP = Sm::PP, LX = Sm::LX, LN = Sm::LN, LQ = Sm::LQ;
  extern __shared__ __align__(16) float sm[];
  float* Xs = sm + Sm::X;    // [BQ][LX] x (pass 1: x dt w)
  float* dYs = sm + Sm::DY;  // [BQ][LX] dy
  float* DXs = sm + Sm::DX;  // [BQ][LX] dxdt
  float* Bs = sm + Sm::BS;   // [BQ][LN]
  float* Cs = sm + Sm::CS;   // [BQ][LN]
  float* Gs = sm + Sm::GS;   // [PP][LN] pass 1: the state; pass 2: its adjoint G
  float* SBs = sm + Sm::SB;  // [RS][LN] s0, then exp(cum) dy s0
  float* S1s = sm + Sm::S1;  // [BQ][LQ] C B^T, then L o C B^T (lower triangle)
  float* S2s = sm + Sm::S2;  // [BQ][LQ] L o dy xdt^T (lower triangle)
  float* dts = sm + Sm::V;   // dt, 0 past S
  float* cum = dts + BQ;     // inclusive cumsum of dt A
  float* ecum = cum + BQ;    // exp(cum_i)
  float* wv = ecum + BQ;     // pass 1: dt_i w_i; pass 2: w_i = exp(cum_last - cum_i)
  float* rowm = wv + BQ;     // rowsum(M), colsum(M), dt w x.(B G^T), C.(exp(cum) dy s0),
  float* colm = rowm + BQ;   // x.dxdt
  float* gterm = colm + BQ;
  float* t1 = gterm + BQ;
  float* xdx = t1 + BQ;
  float* red = xdx + BQ;     // the warps' sums of <G, s_end>

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float a = A[h];
  const size_t bh = (size_t)b * H + h;
  const int nsub = (S + BQ - 1) / BQ;
  float* st = states + bh * (size_t)(nsub + 1) * P * N;

  // dts and cum of the sub-chunk at row c0 (two barriers)
  auto scan = [&](int c0, int rows) {
    if (tid < BQ) {
      const float d = tid < rows ? dt[((size_t)b * S + c0 + tid) * H + h] : 0.f;
      dts[tid] = d;
      float v = d * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, off);
        if ((tid & 31) >= off) v += t;
      }
      cum[tid] = v;
    }
    __syncthreads();
    if (tid >= 32 && tid < BQ) cum[tid] += cum[31];
    __syncthreads();
  };
  // rows c0 .. c0 + rows - 1 of head h of a (b, S, H, P) tensor, times
  // scale[i] (or 1), zeros past them and past P
  auto load_rows = [&](float* dst, const T* src, int c0, int rows, const float* scale) {
    for (int e = tid; e < BQ * PP; e += BT) {
      const int i = e / PP, p = e % PP;
      float v = 0.f;
      if (i < rows && p < P) {
        v = to_float(src[(((size_t)b * S + c0 + i) * H + h) * P + p]);
        if (scale) v *= scale[i];
      }
      dst[i * LX + p] = v;
    }
  };
  auto load_bc = [&](float* dst, const T* src, int sb, int ss, int c0, int rows) {
    for (int e = tid; e < BQ * N; e += BT) {
      const int i = e / N, n = e % N;
      dst[i * LN + n] = i < rows ? to_float(src[(size_t)b * sb + (size_t)(c0 + i) * ss + n]) : 0.f;
    }
  };
  auto load_state = [&](float* dst, const float* src) {  // src null: zeros
    for (int e = tid; e < PP * N; e += BT) {
      const int p = e / N, n = e % N;
      dst[p * LN + n] = (src && p < P) ? src[p * N + n] : 0.f;
    }
  };
  auto store_state = [&](float* dst, const float* src) {
    for (int e = tid; e < P * N; e += BT) dst[e] = src[(e / N) * LN + e % N];
  };

  // ---- pass 1: the start state of every sub-chunk, and the final state
  load_state(Gs, init ? init + bh * P * N : nullptr);
  for (int sc = 0; sc < nsub; ++sc) {
    const int c0 = sc * BQ, rows = min(BQ, S - c0);
    __syncthreads();  // the state is updated and the sub-chunk's buffers free
    store_state(st + (size_t)sc * P * N, Gs);
    scan(c0, rows);
    if (tid < BQ) wv[tid] = dts[tid] * expf(cum[BQ - 1] - cum[tid]);
    __syncthreads();
    load_rows(Xs, x, c0, rows, wv);
    load_bc(Bs, Bm, b_sb, b_ss, c0, rows);
    __syncthreads();
    const float el = expf(cum[BQ - 1]);
    float acc[Grid4<PP, N>::PER][16];  // sum_j (x dt w)_j[p] B_j[n]
    product<PP, N, BQ>(acc, [&](int p, int j) { return Xs[j * LX + p]; },
                       [&](int j, int n) { return Bs[j * LN + n]; });
    each<PP, N>(acc, [&](int p, int n, float v) { Gs[p * LN + n] = fmaf(el, Gs[p * LN + n], v); });
  }
  __syncthreads();
  store_state(st + (size_t)nsub * P * N, Gs);
  __syncthreads();  // the states are visible to the block

  // ---- pass 2: the sub-chunks in reverse, G carried in shared memory
  load_state(Gs, dstate ? dstate + bh * P * N : nullptr);
  float dA_acc = 0.f;
  for (int sc = nsub - 1; sc >= 0; --sc) {
    const int c0 = sc * BQ, rows = min(BQ, S - c0);
    __syncthreads();  // the last sub-chunk is done with every buffer
    load_rows(Xs, x, c0, rows, nullptr);
    load_rows(dYs, dy, c0, rows, nullptr);
    load_bc(Bs, Bm, b_sb, b_ss, c0, rows);
    load_bc(Cs, Cm, c_sb, c_ss, c0, rows);
    load_state(SBs, st + (size_t)sc * P * N);
    scan(c0, rows);
    if (tid < BQ) {
      ecum[tid] = expf(cum[tid]);
      wv[tid] = expf(cum[BQ - 1] - cum[tid]);
    }
    __syncthreads();
    const float el = ecum[BQ - 1];

    // C B^T and dy xdt^T (lower triangles); dy s0; w (B G^T) into dxdt
    {
      float acc[Grid4<BQ, BQ>::PER][16];
      product<BQ, BQ, N>(acc, [&](int i, int n) { return Cs[i * LN + n]; },
                         [&](int n, int j) { return Bs[j * LN + n]; });
      each<BQ, BQ>(acc, [&](int i, int j, float v) { S1s[i * LQ + j] = j <= i ? v : 0.f; });
      product<BQ, BQ, PP>(acc, [&](int i, int p) { return dYs[i * LX + p]; },
                          [&](int p, int j) { return Xs[j * LX + p]; });
      each<BQ, BQ>(acc, [&](int i, int j, float v) {
        S2s[i * LQ + j] = j <= i ? v * dts[j] : 0.f;
      });
    }
    float r1[Grid4<BQ, N>::PER][16];
    product<BQ, N, PP>(r1, [&](int i, int p) { return dYs[i * LX + p]; },
                       [&](int p, int n) { return SBs[p * LN + n]; });
    {
      float acc[Grid4<BQ, PP>::PER][16];
      product<BQ, PP, N>(acc, [&](int i, int n) { return Bs[i * LN + n]; },
                         [&](int n, int p) { return Gs[p * LN + n]; });
      each<BQ, PP>(acc, [&](int i, int p, float v) { DXs[i * LX + p] = wv[i] * v; });
    }
    __syncthreads();  // s0 is read: its buffer takes exp(cum) dy s0

    each<BQ, N>(r1, [&](int i, int n, float v) { SBs[i * LN + n] = ecum[i] * v; });
    if (tid < BQ) {  // L o dy xdt^T in place, and the row sums of M
      const int i = tid;
      float m = 0.f;
      for (int j = 0; j <= i; ++j) {
        const float s2 = S2s[i * LQ + j] * expf(cum[i] - cum[j]);
        S2s[i * LQ + j] = s2;
        if (j < i) m = fmaf(S1s[i * LQ + j], s2, m);
      }
      rowm[i] = m;
    }
    __syncthreads();

    if (tid < BQ) {  // the column sums of M
      const int i = tid;
      float m = 0.f;
      for (int k = i + 1; k < BQ; ++k) m = fmaf(S1s[k * LQ + i], S2s[k * LQ + i], m);
      colm[i] = m;
    } else if (tid < 2 * BQ) {  // dt w x.(B G^T)
      const int i = tid - BQ;
      float g = 0.f;
      for (int p = 0; p < PP; ++p) g = fmaf(Xs[i * LX + p], DXs[i * LX + p], g);
      gterm[i] = dts[i] * g;
    } else if (tid < 3 * BQ) {  // C.(exp(cum) dy s0)
      const int i = tid - 2 * BQ;
      float g = 0.f;
      for (int n = 0; n < N; ++n) g = fmaf(Cs[i * LN + n], SBs[i * LN + n], g);
      t1[i] = g;
    }
    {  // <G, s_end>, s_end the next sub-chunk's start state (or the final one)
      const float* s_end = st + (size_t)(sc + 1) * P * N;
      float g = 0.f;
      for (int e = tid; e < P * N; e += BT) g = fmaf(Gs[(e / N) * LN + e % N], s_end[e], g);
      g = warp_sum(g);
      if (tid % 32 == 0) red[tid / 32] = g;
    }
    __syncthreads();

    for (int e = tid; e < BQ * BQ; e += BT) {  // L o C B^T
      const int i = e / BQ, j = e % BQ;
      if (j <= i) S1s[i * LQ + j] *= expf(cum[i] - cum[j]);
    }
    __syncthreads();

    {  // dxdt += (L o C B^T)^T dy
      float acc[Grid4<BQ, PP>::PER][16];
      product<BQ, PP, BQ>(acc, [&](int i, int j) { return S1s[j * LQ + i]; },
                          [&](int j, int p) { return dYs[j * LX + p]; });
      each<BQ, PP>(acc, [&](int i, int p, float v) { DXs[i * LX + p] += v; });
    }
    {  // this head's dB and dC
      float acc[Grid4<BQ, N>::PER][16];
      product<BQ, N, BQ>(acc, [&](int i, int j) { return S2s[j * LQ + i]; },
                         [&](int j, int n) { return Cs[j * LN + n]; });
      product<BQ, N, PP, true>(acc, [&](int i, int p) { return Xs[i * LX + p] * (wv[i] * dts[i]); },
                               [&](int p, int n) { return Gs[p * LN + n]; });
      float* out = dBh + (bh * S + c0) * N;
      each<BQ, N>(acc, [&](int i, int n, float v) {
        if (i < rows) out[(size_t)i * N + n] = v;
      });
      product<BQ, N, BQ>(acc, [&](int i, int j) { return S2s[i * LQ + j]; },
                         [&](int j, int n) { return Bs[j * LN + n]; });
      out = dCh + (bh * S + c0) * N;
      each<BQ, N>(acc, [&](int i, int n, float v) {
        if (i < rows) out[(size_t)i * N + n] = v + SBs[i * LN + n];
      });
    }
    __syncthreads();  // every read of G and of dxdt's parts is done

    {  // G <- exp(cum_last) G + (exp(cum) dy)^T C: the adjoint of s0
      float acc[Grid4<PP, N>::PER][16];
      product<PP, N, BQ>(acc, [&](int p, int i) { return dYs[i * LX + p] * ecum[i]; },
                         [&](int i, int n) { return Cs[i * LN + n]; });
      each<PP, N>(acc, [&](int p, int n, float v) { Gs[p * LN + n] = fmaf(el, Gs[p * LN + n], v); });
    }
    for (int e = tid; e < rows * P; e += BT) {
      const int i = e / P, p = e % P;
      dx[(((size_t)b * S + c0 + i) * H + h) * P + p] = from_float<T>(dts[i] * DXs[i * LX + p]);
    }
    if (tid < BQ) {
      float g = 0.f;
      for (int p = 0; p < PP; ++p) g = fmaf(Xs[tid * LX + p], DXs[tid * LX + p], g);
      xdx[tid] = g;
    }
    __syncthreads();
    if (tid == 0) {  // dcum, its reverse cumsum da, ddt and dA, in order
      float gs = 0.f;
      for (int w = 0; w < BT / 32; ++w) gs += red[w];
      float da = gs;
      for (int i = BQ - 1; i >= 0; --i) {
        da += rowm[i] - colm[i] + t1[i] - gterm[i];
        if (i < rows) ddt[((size_t)b * S + c0 + i) * H + h] = fmaf(a, da, xdx[i]);
        dA_acc = fmaf(dts[i], da, dA_acc);
      }
    }
  }
  __syncthreads();
  if (dinit) store_state(dinit + bh * P * N, Gs);
  if (tid == 0) dAh[bh] = dA_acc;
}

template <typename T, int P, int N>
int launch_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
               const void* dy, const void* init, const void* dstate, void* dx, void* ddt,
               void* dA, void* dB, void* dC, void* dinit, float* states, float* dBh,
               float* dCh, float* dAh, int nb, int S, int H, int b_sb, int b_ss, int c_sb,
               int c_ss, cudaStream_t stream) {
  static hopper::SmemRaised raised;
  constexpr int smem = BwdSmem<P, N>::BYTES;
  cudaError_t err = hopper::allow_smem(ssd_bwd_kernel<T, P, N>, smem, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel<T, P, N><<<dim3(H, nb), BT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const T*>(dy),
      static_cast<const float*>(init), static_cast<const float*>(dstate), static_cast<T*>(dx),
      static_cast<float*>(ddt), dBh, dCh, dAh, static_cast<float*>(dinit), states, S, H, b_sb,
      b_ss, c_sb, c_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<T>(dBh, dCh, dAh, dB, dC, dA, nb, S, H, H, N, 1, stream);
}

// ------------------------------------------------ bf16 at (64, 128): wgmma
constexpr int WP = 64, WN = 128;  // P, N of mamba2_1_3b
constexpr int W_HEADS = 2;        // heads per block, a consumer warpgroup each
constexpr int W_THREADS = W_HEADS * 128;
constexpr int DT_HEADS = 4;       // heads in a dt box: 16 bytes, TMA's least
constexpr int W_CLUSTER = 2;      // blocks (pairs of heads) a cluster sums dB, dC over
constexpr int ATOM = BQ * 128;    // 64 rows of 64 bf16 (128-byte swizzle)
// the stage: x and dy of each head, B, C, dt (both passes load all of it)
constexpr int ST_X = 0, ST_DY = ST_X + W_HEADS * ATOM, ST_B = ST_DY + W_HEADS * ATOM,
              ST_C = ST_B + 2 * ATOM, ST_DT = ST_C + 2 * ATOM, DT_BYTES = BQ * DT_HEADS * 4,
              STAGE = ST_DT + DT_BYTES;
// a head's tiles: a P x N matrix in bf16 (hi) and the bf16 of what that
// leaves (lo), two atoms each: s0 in the forward pass, G in the reverse
// one; L o C B^T and L o dy (x dt)^T (64 x 64)
constexpr int T_HI = 0, T_LO = 2 * ATOM, T_S1 = 4 * ATOM, T_S2 = 5 * ATOM, HEAD_TILES = 6 * ATOM;
// the pair's 64 x 128 fp32 sum of a sub-chunk's dB or dC, [32][128] float2
// (thread t's d[2 k], d[2 k + 1] at [k][t]); the half of the other block's
// that this block sums (its 16 slots k)
constexpr int MERGE_BYTES = BQ * WN * 4, RECV_BYTES = MERGE_BYTES / 2;
// a head's vectors (fp32): cum (log2 units), dt, exp(cum), w = exp(cum_last -
// cum), exp(cum_last); dcum's row terms, x.dxdt, each warp's column sums of
// M, and each warp's part of <dstate, s_final>
constexpr int V_C = 0, V_D = 64, V_EC = 128, V_W = 192, V_EL = 256, V_ROW = 260, V_XDX = 324,
              V_COL = 388, V_GS = 644, VEC = 656;
constexpr int W_SMEM = 1024 + STAGE + W_HEADS * HEAD_TILES + MERGE_BYTES + RECV_BYTES +
                       W_HEADS * VEC * 4 + 4 * 8;
// named barriers: 1 + wg a warpgroup's own; the pair's sum
constexpr int BAR_PAIR = 3;

static_assert(STAGE % 1024 == 0 && HEAD_TILES % 1024 == 0 && MERGE_BYTES % 1024 == 0,
              "tiles must stay 1024-byte aligned for the 128-byte swizzle");
static_assert(W_SMEM <= 232448, "more shared memory than a block may have");

// Byte offset of element (row, col) of a tile of 64-column atoms (rows of
// 128 bytes, 16-byte chunks XOR-swizzled by row % 8), as TMA lays them out
// and wgmma reads them.
__device__ __forceinline__ int swz(int row, int col) {
  return (col / 64) * ATOM + row * 128 + ((((col % 64) / 8) ^ (row % 8)) << 4) + (col % 8) * 2;
}

// Accumulator layout of m64nNk16 in a warpgroup (hopper.cuh): thread t = 32
// warp + lane, r = 16 warp + lane / 4, q = lane % 4, holds d[4 j + 2 hh + e] =
// D[r + 8 hh][8 j + 2 q + e].
struct Lane {
  int warp, lane, q, r;
  __device__ Lane(int t) : warp(t / 32), lane(t % 32), q(t % 4), r(16 * (t / 32) + (t % 32) / 4) {}
  // an accumulator of 64 rows in bf16 (or the bf16 of its rounding error,
  // REST) to a swizzled tile: matrix m of stmatrix k holds rows 16 warp + 8
  // (m % 2) .., columns 16 k + 8 (m / 2) ..
  template <bool REST = false, int R>
  __device__ __forceinline__ void store_bf16(unsigned char* tile, const float (&d)[R]) const {
    const int srow = 16 * warp + 8 * ((lane / 8) % 2) + lane % 8, scol = 8 * (lane / 16);
    auto pk = [](float a, float b) {
      return REST ? hopper::pack_bf16_rest(a, b) : hopper::pack_bf16(a, b);
    };
#pragma unroll
    for (int k = 0; k < R / 8; ++k)
      hopper::stmatrix_x4(tile + swz(srow, 16 * k + scol), pk(d[8 * k], d[8 * k + 1]),
                          pk(d[8 * k + 2], d[8 * k + 3]), pk(d[8 * k + 4], d[8 * k + 5]),
                          pk(d[8 * k + 6], d[8 * k + 7]));
  }
  // per row r + 8 hh: the sum over this thread's columns of d times the
  // tile's elements there (the quad's sum: quad_sum)
  template <int R>
  __device__ __forceinline__ void rowdot(float (&out)[2], const unsigned char* tile,
                                         const float (&d)[R]) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < R / 4; ++j) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(tile + swz(r + 8 * hh, 8 * j + 2 * q)));
        s = fmaf(v.x, d[4 * j + 2 * hh], fmaf(v.y, d[4 * j + 2 * hh + 1], s));
      }
      out[hh] = quad_sum(s);
    }
  }
  // this thread's elements of a (P, N) fp32 matrix (a state, its adjoint)
  __device__ __forceinline__ void load_state(float (&d)[64], const float* m) const {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 u = *reinterpret_cast<const float2*>(m + (r + 8 * hh) * WN + 8 * j + 2 * q);
        d[4 * j + 2 * hh] = u.x;
        d[4 * j + 2 * hh + 1] = u.y;
      }
  }
  __device__ __forceinline__ void store_state(const float (&d)[64], float* m) const {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(m + (r + 8 * hh) * WN + 8 * j + 2 * q) =
            make_float2(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
  }
};

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

__global__ void __launch_bounds__(W_THREADS, 1)
ssd_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap dymap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap cmap,
                     const __grid_constant__ CUtensorMap dtmap, const float* __restrict__ A,
                     const float* __restrict__ init, const float* __restrict__ dstate,
                     __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                     __nv_bfloat16* __restrict__ dBp, __nv_bfloat16* __restrict__ dCp,
                     float* __restrict__ dAh, float* __restrict__ pre, float* __restrict__ tot,
                     float* __restrict__ dinit, int S, int H) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stage = smem;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  unsigned char* tiles = smem + STAGE + wg * HEAD_TILES;
  unsigned char* hit = tiles + T_HI;
  unsigned char* lot = tiles + T_LO;
  unsigned char* s1t = tiles + T_S1;
  unsigned char* s2t = tiles + T_S2;
  float* mt = reinterpret_cast<float*>(smem + STAGE + W_HEADS * HEAD_TILES);
  float* recv = mt + MERGE_BYTES / 4;
  float* v = recv + RECV_BYTES / 4 + wg * VEC;
  uint64_t* full = reinterpret_cast<uint64_t*>(recv + RECV_BYTES / 4 + W_HEADS * VEC);
  uint64_t* empty = full + 1;
  uint64_t* rcv = full + 2;    // the other block's half has landed in recv
  uint64_t* rfree = full + 3;  // the other block has summed what this one sent
  const unsigned char* xs = stage + ST_X + wg * ATOM;
  const unsigned char* dys = stage + ST_DY + wg * ATOM;
  const unsigned char* bs = stage + ST_B;
  const unsigned char* cs = stage + ST_C;

  const int h0 = blockIdx.x * W_HEADS, b = blockIdx.y, h = h0 + wg;
  const size_t bh = (size_t)b * H + h;
  const int nsub = (S + BQ - 1) / BQ;
  const bool rev = blockIdx.z == 1;  // the reverse pass's block, else the forward's
  const Lane ln(t);
  const int warp = ln.warp, lane = ln.lane, q = ln.q, r = ln.r;
  const float a = A[h], a2 = a * LOG2E;  // cum in log2 units
  // the cluster: W_CLUSTER blocks (pairs of heads) of batch row b,
  // rank-ordered; its dB / dC partial is slot blockIdx.x / W_CLUSTER of (b,
  // H / 4, S, N)
  const int rank = (int)cluster_rank(), parts = gridDim.x / W_CLUSTER;
  const size_t part_row = ((size_t)b * parts + blockIdx.x / W_CLUSTER) * S;

  // step s: sub-chunk s in the forward pass, nsub - 1 - s in the reverse
  // one.  One stage: thread 0 loads the next step once both warpgroups have
  // released this one.
  auto load = [&](int step) {
    const int row = (rev ? nsub - 1 - step : step) * BQ;
    mbar_arrive_expect_tx(full, STAGE);
    for (int hh = 0; hh < W_HEADS; ++hh) {
      tma_load_4d(stage + ST_X + hh * ATOM, &xmap, full, 0, h0 + hh, row, b);
      tma_load_4d(stage + ST_DY + hh * ATOM, &dymap, full, 0, h0 + hh, row, b);
    }
    for (int c = 0; c < 2; ++c) {
      tma_load_3d(stage + ST_B + c * ATOM, &bmap, full, 64 * c, row, b);
      tma_load_3d(stage + ST_C + c * ATOM, &cmap, full, 64 * c, row, b);
    }
    tma_load_3d(stage + ST_DT, &dtmap, full, h0 - h0 % DT_HEADS, row, b);
  };
  auto release = [&](int step) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
    if (threadIdx.x == 0 && step + 1 < nsub) {
      mbar_wait(empty, step & 1);
      load(step + 1);
    }
    __syncwarp();
  };
  // warp 0: this head's vectors of the stage's sub-chunk, lane l holding
  // rows l and l + 32; then the warpgroup's barrier
  auto scan = [&]() {
    if (warp == 0) {
      const float* dts = reinterpret_cast<const float*>(stage + ST_DT);
      const int hl = h % DT_HEADS;
      const float d0 = dts[lane * DT_HEADS + hl], d1 = dts[(lane + 32) * DT_HEADS + hl];
      float c0 = d0 * a2, c1 = d1 * a2;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, c0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, c1, off);
        if (lane >= off) {
          c0 += u0;
          c1 += u1;
        }
      }
      c1 += __shfl_sync(0xffffffffu, c0, 31);
      const float cl2 = __shfl_sync(0xffffffffu, c1, 31);
      v[V_C + lane] = c0;
      v[V_C + lane + 32] = c1;
      v[V_D + lane] = d0;
      v[V_D + lane + 32] = d1;
      v[V_EC + lane] = ex2(c0);
      v[V_EC + lane + 32] = ex2(c1);
      v[V_W + lane] = ex2(cl2 - c0);
      v[V_W + lane + 32] = ex2(cl2 - c1);
      if (lane == 0) v[V_EL] = ex2(cl2);
    }
    named_bar_sync(1 + wg, 128);
  };
  // bf16(exp(cum) o dy) to s1t, in dy's layout (a swizzle permutes the
  // 16-byte chunks of a row, so chunk c of either tile is row c / 8's): the
  // operand of (exp(cum) o dy) s0 and, transposed, of G's update
  auto scaled_dy = [&]() {
#pragma unroll
    for (int c = t; c < BQ * 8; c += 128) {
      const uint4 u = *reinterpret_cast<const uint4*>(dys + 16 * c);
      const float e = v[V_EC + c / 8];
      const uint4 o = {scale_bf16x2(u.x, make_float2(e, e)), scale_bf16x2(u.y, make_float2(e, e)),
                       scale_bf16x2(u.z, make_float2(e, e)), scale_bf16x2(u.w, make_float2(e, e))};
      *reinterpret_cast<uint4*>(s1t + 16 * c) = o;
    }
  };
  // bf16(x o dt w), and with `both` the bf16 of what that leaves, to this
  // warpgroup's two atoms of the merge tile (free between merges), in x's
  // layout: the A operand of the state's update (transposed, as hi + lo)
  // and of (x o dt w) G (hi)
  auto scaled_x = [&](bool both) {
    unsigned char* xt = reinterpret_cast<unsigned char*>(mt) + wg * 2 * ATOM;
#pragma unroll
    for (int c = t; c < BQ * 8; c += 128) {
      const uint4 u = *reinterpret_cast<const uint4*>(xs + 16 * c);
      const float f = v[V_D + c / 8] * v[V_W + c / 8];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        hi[i] = pack_bf16(xv.x * f, xv.y * f);
        lo[i] = pack_bf16_rest(xv.x * f, xv.y * f);
      }
      *reinterpret_cast<uint4*>(xt + 16 * c) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      if (both)
        *reinterpret_cast<uint4*>(xt + ATOM + 16 * c) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };
  // dy x^T and C B^T of the stage's sub-chunk (both operands K-major), one
  // wgmma group, committed
  auto scores = [&](float (&dxa)[32], float (&cba)[32]) {
    zero(dxa);
    zero(cba);
    fence_regs(dxa);
    fence_regs(cba);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64<0>(dxa, make_desc(dys + kk * 32, 16, 1024), make_desc(xs + kk * 32, 16, 1024),
                      1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int off = (kk / 4) * ATOM + (kk % 4) * 32;
      wgmma_ss_n64<0>(cba, make_desc(cs + off, 16, 1024), make_desc(bs + off, 16, 1024), 1);
    }
    wgmma_commit();
  };
  // L and the masks over the scores: dxa <- S2 = L o dy (x dt)^T, cba <- L o
  // C B^T; M = S2 o C B^T below the diagonal, its row sums (the forward
  // pass's dcum term) and each column's sum over this thread's rows, handed
  // to col(column, sum) at once (the reverse pass's)
  auto masks = [&](float (&dxa)[32], float (&cba)[32], float (&rowm)[2], auto col_sum) {
    float ci[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) ci[hh] = v[V_C + r + 8 * hh];
    rowm[0] = rowm[1] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 cj = *reinterpret_cast<const float2*>(v + V_C + 8 * j + 2 * q);
      const float2 dj = *reinterpret_cast<const float2*>(v + V_D + 8 * j + 2 * q);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * q + e;
        const float cc = e ? cj.y : cj.x, dd = e ? dj.y : dj.x;
        float cs_ = 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = r + 8 * hh, idx = 4 * j + 2 * hh + e;
          const float L = col <= i ? ex2(ci[hh] - cc) : 0.f;
          const float s2 = L * dxa[idx] * dd;
          const float m = col < i ? s2 * cba[idx] : 0.f;
          rowm[hh] += m;
          cs_ += m;
          cba[idx] *= L;
          dxa[idx] = s2;
        }
        col_sum(col, cs_);
      }
    }
  };
  // The pair's sum of a 64 x 128 partial (dC or dB of the sub-chunk at row
  // c0), then the cluster's, by every thread of the block: each warpgroup
  // writes half of its accumulator to the merge tile and adds the other half
  // to what the other wrote; then the bulk-copy engine sends the half of the
  // tile that the other block sums (its 16 slots k) to that block's recv,
  // and this block sums its own 16 slots with what the other sent (a + b is
  // b + a: the rank order holds either way) and stores the rows below S in
  // bf16 to the cluster's partial (b, H / 4, S, N).  No cluster barrier:
  // mbarriers say that the other block's half has landed (rcv) and that it
  // has summed what this block sent (rfree: each step waits for it before
  // scaled_x writes the tile again).  The next step's load is in flight
  // meanwhile.
  int merges = 0;
  auto tile_free = [&]() {
    if (merges > 0) mbar_wait_cluster(rfree, (merges - 1) & 1);
  };
  auto merge = [&](const float (&d)[64], __nv_bfloat16* out, int c0, int rows) {
    const int peer = rank ^ 1;
    float2* m2 = reinterpret_cast<float2*>(mt);
    named_bar_sync(BAR_PAIR, W_THREADS);  // both warpgroups' products have read their scaled_x
    // the halves are chosen by branches, so that d is indexed by constants
    // and stays in registers
    auto put = [&](int k0) {
#pragma unroll
      for (int k = k0; k < k0 + 16; ++k) m2[k * 128 + t] = make_float2(d[2 * k], d[2 * k + 1]);
    };
    auto add = [&](int k0) {
#pragma unroll
      for (int k = k0; k < k0 + 16; ++k) {
        const float2 o = m2[k * 128 + t];
        m2[k * 128 + t] = make_float2(d[2 * k] + o.x, d[2 * k + 1] + o.y);
      }
    };
    if (wg) put(0);
    else put(16);
    named_bar_sync(BAR_PAIR, W_THREADS);
    if (wg) add(16);
    else add(0);
    fence_proxy_async();  // the copy reads the tile through the async proxy
    named_bar_sync(BAR_PAIR, W_THREADS);
    if (threadIdx.x == 0) bulk_copy_cluster(recv, mt + 16 * peer * 256, RECV_BYTES, rcv, peer);
    mbar_wait_cluster(rcv, merges & 1);
#pragma unroll
    for (int e = threadIdx.x; e < 16 * 64; e += W_THREADS) {
      const int k = 16 * rank + e / 64, tt = 2 * (e % 64);  // threads tt, tt + 1
      const float4 a = *reinterpret_cast<const float4*>(mt + k * 256 + 2 * tt);
      const float4 o = *reinterpret_cast<const float4*>(recv + (e / 64) * 256 + 2 * tt);
      const int row = 16 * (tt / 32) + (tt % 32) / 4 + 8 * (k % 2);
      const int col = 8 * (k / 2) + 2 * (tt % 4);
      if (row < rows)
        *reinterpret_cast<uint2*>(out + (part_row + c0 + row) * WN + col) =
            make_uint2(pack_bf16(a.x + o.x, a.y + o.y), pack_bf16(a.z + o.z, a.w + o.w));
    }
    named_bar_sync(BAR_PAIR, W_THREADS);  // recv and the own half are read
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(rcv, RECV_BYTES);  // the next merge's
      mbar_arrive_cluster(rfree, peer);
    }
    ++merges;
  };

  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(empty, W_THREADS / 32);  // every warp of both warpgroups
    mbar_init(rcv, 1);
    mbar_init(rfree, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(rcv, RECV_BYTES);  // the first merge's
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_prefetch_map(&xmap);
    tma_prefetch_map(&dymap);
    tma_prefetch_map(&bmap);
    tma_prefetch_map(&cmap);
    tma_prefetch_map(&dtmap);
    load(0);
  }
  cluster_sync();  // the other block's mbarriers are initialised

  if (!rev) {
    // ---- the forward pass: s0, the sub-chunk's start state, an fp32 wgmma
    // accumulator from init_state (or 0), its bf16 hi and lo in shared
    // memory; per sub-chunk dC = (exp(cum) o dy) s0 + S2 B and dcum's terms
    // that read the states, R = rowsum(M) + C.((exp(cum) o dy) s0); then
    // s <- exp(cum_last) s + (x o dt w)^T B, x o dt w rounded to bf16 twice
    // (hi + lo: one bf16 would cost dA the fine limit).  da's share of R is
    // the sum of R over the rows from row t on, plus <dstate, s_final>: tot
    // less pre_t, the sum over the rows before t (warp 0 carries it), and its
    // dt da share tot sum(dt) - sum(dt pre); the reduce adds A (tot - pre) to
    // the reverse pass's ddt
    float st[64];
    if (init) ln.load_state(st, init + bh * WP * WN);
    else zero(st);
    float run = 0.f, sdt = 0.f, sdtp = 0.f;  // warp 0: R's sum, sum(dt), sum(dt pre)
    for (int k = 0; k < nsub; ++k) {
      const int c0 = k * BQ, rows = min(BQ, S - c0);
      ln.store_bf16(hit, st);  // while the stage loads
      ln.store_bf16<true>(lot, st);
      mbar_wait(full, k & 1);
      scan();
      scaled_dy();
      tile_free();
      scaled_x(true);
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      float rterm[2];
      float acc[64];
      {
        float dxa[32], cba[32];
        scores(dxa, cba);
        // (exp(cum) o dy) s0, s0 as hi + lo
        zero(acc);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss_n128<0, 1>(acc, make_desc(s1t + (kk % 4) * 32, 16, 1024),
                              make_desc((kk < 4 ? hit : lot) + (kk % 4) * 2048, ATOM, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dxa);
        fence_regs(cba);
        float rowm[2];
        masks(dxa, cba, rowm, [](int, float) {});
        ln.store_bf16(s2t, dxa);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) rterm[hh] = quad_sum(rowm[hh]);
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      wgmma_wait<0>();
      fence_regs(acc);
      {
        float cd[2];
        ln.rowdot(cd, cs, acc);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) rterm[hh] += cd[hh];
      }
      {  // dC = acc + S2 B; then the state's update, in flight through dC's merge
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128<0, 1>(acc, make_desc(s2t + kk * 32, 16, 1024),
                              make_desc(bs + kk * 2048, ATOM, 1024), 1);
        wgmma_commit();
        const float el = v[V_EL];
#pragma unroll
        for (int i = 0; i < 64; ++i) st[i] *= el;
        fence_regs(st);
        wgmma_fence();
        const unsigned char* xt = reinterpret_cast<const unsigned char*>(mt) + wg * 2 * ATOM;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)  // (x o dt w)^T hi, then lo, M-major from their tiles
          wgmma_ss_n128<1, 1>(st, make_desc(xt + (kk / 4) * ATOM + (kk % 4) * 2048, ATOM, 1024),
                              make_desc(bs + (kk % 4) * 2048, ATOM, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(st);
      }
      if (q == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) v[V_ROW + r + 8 * hh] = rterm[hh];
      }
      release(k);  // the next step's load lands during dC's merge
      merge(acc, dCp, c0, rows);
      named_bar_sync(1 + wg, 128);  // R is whole, the vectors are read
      if (warp == 0) {  // pre of rows lane, lane + 32: prefix sums, in order
        float p[2] = {v[V_ROW + lane], v[V_ROW + lane + 32]};
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u0 = __shfl_up_sync(0xffffffffu, p[0], off);
          const float u1 = __shfl_up_sync(0xffffffffu, p[1], off);
          if (lane >= off) {
            p[0] += u0;
            p[1] += u1;
          }
        }
        const float first = __shfl_sync(0xffffffffu, p[0], 31);  // rows 0 .. 31
        p[1] += first;
        const float last = __shfl_sync(0xffffffffu, p[1], 31);
        const float e0 = __shfl_up_sync(0xffffffffu, p[0], 1);  // inclusive to exclusive
        const float e1 = __shfl_up_sync(0xffffffffu, p[1], 1);
        p[0] = lane ? e0 : 0.f;
        p[1] = lane ? e1 : first;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = lane + 32 * half;
          const float e = run + p[half], d = v[V_D + i];
          if (i < rows) pre[((size_t)b * S + c0 + i) * H + h] = e;
          sdt += d;
          sdtp = fmaf(d, e, sdtp);
        }
        run += last;
      }
    }
    {  // tot = R's sum + <dstate, s_final>; the forward share of dt da
      float s = 0.f;
      if (dstate) {
        float gd[64];
        ln.load_state(gd, dstate + bh * WP * WN);
#pragma unroll
        for (int i = 0; i < 64; ++i) s = fmaf(gd[i], st[i], s);
      }
      s = warp_sum(s);
      if (lane == 0) v[V_GS + warp] = s;
      named_bar_sync(1 + wg, 128);
      if (warp == 0) {
        const float tt = run + (((v[V_GS] + v[V_GS + 1]) + v[V_GS + 2]) + v[V_GS + 3]);
        sdt = warp_sum(sdt);
        sdtp = warp_sum(sdtp);
        if (lane == 0) {
          tot[bh] = tt;
          dAh[2 * bh] = fmaf(tt, sdt, -sdtp);
        }
      }
    }
  } else {

    // ---- the reverse pass: G, the adjoint of the sub-chunk's end state, an
    // fp32 accumulator from dstate (or 0) back to d init_state; its bf16 hi
    // and lo in shared memory for the products that read it.  da's share
    // here is the sum of dcum's other terms, -colsum(M) - w xdt.(B G^T), from
    // row t to the end, carried from sub-chunk to sub-chunk (warp 0): with the
    // forward pass's share, the reverse cumsum of dcum over the whole
    // sequence from <dstate, s_final>, whose sum over a later sub-chunk's rows
    // is what the chunked form's <G, s_end> is.
    float g[64];
    float carry = 0.f;  // warp 0
    if (dstate) ln.load_state(g, dstate + bh * WP * WN);
    else zero(g);
    ln.store_bf16(hit, g);
    ln.store_bf16<true>(lot, g);
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);

    float dA_acc = 0.f;  // warp 0: this head's dt da over its rows
    for (int step = 0; step < nsub; ++step) {
      const int k = nsub - 1 - step, c0 = k * BQ, rows = min(BQ, S - c0);
      mbar_wait(full, step & 1);
      scan();
      tile_free();
      scaled_x(false);
      float wi[2], di[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        wi[hh] = v[V_W + r + 8 * hh];
        di[hh] = v[V_D + r + 8 * hh];
      }
      float rterm[2], xdx[2];

      // G's update to the start state's adjoint, G <- exp(cum_last) G +
      // (exp(cum) o dy)^T C, and B G^T (G's hi and lo, of the end state) in
      // flight while the scores are formed and masked
      scaled_dy();
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      {
        const float el = v[V_EL];
#pragma unroll
        for (int i = 0; i < 64; ++i) g[i] *= el;
      }
      fence_regs(g);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // (exp(cum) o dy)^T from its tile, M-major
        wgmma_ss_n128<1, 1>(g, make_desc(s1t + kk * 2048, ATOM, 1024),
                            make_desc(cs + kk * 2048, ATOM, 1024), 1);
      wgmma_commit();
      float dxa[32], cba[32];
      scores(dxa, cba);
      float bg[32];
      zero(bg);
      fence_regs(bg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {  // G's hi, then its lo
        const int off = ((kk % 8) / 4) * ATOM + (kk % 4) * 32;
        wgmma_ss_n64<0>(bg, make_desc(bs + off, 16, 1024),
                        make_desc((kk < 8 ? hit : lot) + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(g);
      fence_regs(dxa);
      fence_regs(cba);
      {
        float rowm[2];
        masks(dxa, cba, rowm, [&](int col, float x) {  // over the warp's 16 rows
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          if (lane < 4) v[V_COL + 64 * warp + col] = x;
        });
        ln.store_bf16(s1t, cba);
        ln.store_bf16(s2t, dxa);
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);

      // dB = (x o dt w) G + S2^T C (G's hi), then dxdt = w (B G^T) + S1^T dy,
      // in flight through dB's merge
      float acc[64];
      zero(acc);
      fence_regs(acc);
      wgmma_fence();
      const unsigned char* xt = reinterpret_cast<const unsigned char*>(mt) + wg * 2 * ATOM;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // x o dt w from its tile
        wgmma_ss_n128<0, 1>(acc, make_desc(xt + kk * 32, 16, 1024),
                            make_desc(hit + kk * 2048, ATOM, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // S2^T from its tile, M-major
        wgmma_ss_n128<1, 1>(acc, make_desc(s2t + kk * 2048, ATOM, 1024),
                            make_desc(cs + kk * 2048, ATOM, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(bg);
      {
        float xg[2];
        ln.rowdot(xg, xs, bg);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rterm[hh] = -wi[hh] * di[hh] * xg[hh];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            bg[4 * j + 2 * hh] *= wi[hh];
            bg[4 * j + 2 * hh + 1] *= wi[hh];
          }
        }
      }
      fence_regs(bg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // S1^T from its tile, M-major
        wgmma_ss_n64<1, 1>(bg, make_desc(s1t + kk * 2048, ATOM, 1024),
                           make_desc(dys + kk * 2048, ATOM, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(bg);
      ln.rowdot(xdx, xs, bg);
      {  // dx = dt dxdt, rows below S
        __nv_bfloat16* out = dx + (((size_t)b * S + c0) * H + h) * WP;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = r + 8 * hh;
          if (i < rows) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<uint32_t*>(out + (size_t)i * H * WP + 8 * j + 2 * q) =
                  pack_bf16(di[hh] * bg[4 * j + 2 * hh], di[hh] * bg[4 * j + 2 * hh + 1]);
          }
        }
      }
      release(step);  // the next step's load lands during dB's merge
      merge(acc, dBp, c0, rows);

      // the start state's adjoint's bf16 hi and lo (the next sub-chunk's end
      // state's); dcum, its reverse cumsum from the carry, ddt and dt da, in
      // order, on warp 0
      ln.store_bf16(hit, g);
      ln.store_bf16<true>(lot, g);
      if (q == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          v[V_ROW + r + 8 * hh] = rterm[hh];
          v[V_XDX + r + 8 * hh] = xdx[hh];
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (warp == 0) {
        float dc[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = lane + 32 * half;
          dc[half] = v[V_ROW + i] -
                     (((v[V_COL + i] + v[V_COL + 64 + i]) + v[V_COL + 128 + i]) + v[V_COL + 192 + i]);
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {  // suffix sums
          const float u0 = __shfl_down_sync(0xffffffffu, dc[0], off);
          const float u1 = __shfl_down_sync(0xffffffffu, dc[1], off);
          if (lane + off < 32) {
            dc[0] += u0;
            dc[1] += u1;
          }
        }
        dc[0] += __shfl_sync(0xffffffffu, dc[1], 0);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = lane + 32 * half;
          dc[half] += carry;
          if (i < rows) ddt[((size_t)b * S + c0 + i) * H + h] = fmaf(a, dc[half], v[V_XDX + i]);
          dA_acc = fmaf(v[V_D + i], dc[half], dA_acc);
        }
        carry = __shfl_sync(0xffffffffu, dc[0], 0);
      }
    }

    if (dinit) ln.store_state(g, dinit + bh * WP * WN);
    if (warp == 0) {
      dA_acc = warp_sum(dA_acc);
      if (lane == 0) dAh[2 * bh + 1] = dA_acc;
    }
  }
  // no block leaves before the other has summed the last half it sent
  mbar_wait_cluster(rfree, (merges - 1) & 1);
}

int launch_bwd_wgmma(const void* x, const void* dt, const void* A, const void* B, const void* C,
                     const void* dy, const void* init, const void* dstate, void* dx, void* ddt,
                     void* dA, void* dB, void* dC, void* dinit, float* pre, void* dBp,
                     void* dCp, float* dAh, int nb, int S, int H, int b_sb, int b_ss, int c_sb,
                     int c_ss, cudaStream_t stream) {
  if (H % DT_HEADS != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = H / W_HEADS;  // a multiple of W_CLUSTER
  static hopper::SmemRaised raised;
  CUtensorMap xmap, dymap, bmap, cmap, dtmap;
  const uint64_t xdims[4] = {WP, (uint64_t)H, (uint64_t)S, (uint64_t)nb};
  const uint64_t xstr[3] = {WP * 2, (uint64_t)H * WP * 2, (uint64_t)S * H * WP * 2};
  const uint32_t xbox[4] = {64, 1, BQ, 1};
  const uint64_t bcdims[3] = {WN, (uint64_t)S, (uint64_t)nb};
  const uint64_t bstr[2] = {(uint64_t)b_ss * 2, (uint64_t)b_sb * 2};
  const uint64_t cstr[2] = {(uint64_t)c_ss * 2, (uint64_t)c_sb * 2};
  const uint32_t bcbox[3] = {64, BQ, 1};
  const uint64_t dtdims[3] = {(uint64_t)H, (uint64_t)S, (uint64_t)nb};
  const uint64_t dtstr[2] = {(uint64_t)H * 4, (uint64_t)S * H * 4};
  const uint32_t dtbox[3] = {DT_HEADS, BQ, 1};
  if (!hopper::make_map_bf16(&xmap, x, 4, xdims, xstr, xbox) ||
      !hopper::make_map_bf16(&dymap, dy, 4, xdims, xstr, xbox) ||
      !hopper::make_map_bf16(&bmap, B, 3, bcdims, bstr, bcbox) ||
      !hopper::make_map_bf16(&cmap, C, 3, bcdims, cstr, bcbox) ||
      !hopper::make_map(&dtmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dt, 3, dtdims, dtstr, dtbox,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  float* tot = dAh + 2 * (size_t)nb * H;  // after dt da's two shares (b, H, 2)
  cudaError_t err = hopper::launch_cluster(
      ssd_bwd_wgmma_kernel, raised, dim3(pairs, nb, 2), W_THREADS, W_SMEM, W_CLUSTER, stream,
      xmap, dymap, bmap, cmap, dtmap, static_cast<const float*>(A),
      static_cast<const float*>(init), static_cast<const float*>(dstate),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ddt),
      static_cast<__nv_bfloat16*>(dBp), static_cast<__nv_bfloat16*>(dCp), dAh, pre, tot,
      static_cast<float*>(dinit), S, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(dBp),
                                      static_cast<const __nv_bfloat16*>(dCp), dAh, dB, dC, dA,
                                      nb, S, pairs / W_CLUSTER, H, WN, 2, stream, pre, tot, A,
                                      ddt);
}

}  // namespace

// The rows of a sub-chunk: the CUDA-core kernel's states scratch holds
// ceil(S / rows) + 1 states per (batch row, head).
extern "C" int ssd_scan_bwd_rows() { return BQ; }

// How many clusters of `cl` blocks of the wgmma kernel the card holds at
// once (cudaOccupancyMaxActiveClusters: whole clusters fit a GPC's SMs),
// or -1 for a cluster it does not take.
extern "C" int ssd_scan_bwd_max_clusters(int cl) {
  static hopper::SmemRaised raised;
  if (cl < 1 || cl > hopper::MAX_CLUSTER) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = W_SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t err = hopper::allow_smem(ssd_bwd_wgmma_kernel, W_SMEM, raised);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, ssd_bwd_wgmma_kernel, &cfg);
  return err == cudaSuccess ? n : -1;
}

// dtype: 0 = fp32, 1 = bf16 (x, B, C, dy, dx, dB, dC).  (P, N) = (64, 128),
// or (50, 16) in fp32 (bf16 at (50, 16) is ssd_scan_bwd_tc's).  init, dstate
// and dinit may be null (a zero initial state, a zero cotangent of the final
// state, no d init).  bf16 at (64, 128) takes the wgmma kernel (H % 4 == 0,
// 16-byte aligned pointers and B / C strides); its scratch: states (b, S, H)
// fp32 (pre), dBh and dCh (b, H / 4, S, N) bf16, dAh (b, H, 3) fp32 (dt da's
// two shares, then tot).  fp32 takes the CUDA-core kernel; its scratch, fp32:
// states (b, H, nsub + 1, P, N), dBh and dCh (b, H, S, N), dAh (b, H).
// Returns the cudaError_t of the launches, or cudaErrorInvalidValue for what
// the kernels do not take.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, const void* dy, const void* init,
                            const void* dstate, void* dx, void* ddt, void* dA, void* dB,
                            void* dC, void* dinit, void* states, void* dBh, void* dCh,
                            void* dAh, int nb, int S, int H, int P, int N, int b_sb, int b_ss,
                            int c_sb, int c_ss, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* st = static_cast<float*>(states);
  float* pb = static_cast<float*>(dBh);
  float* pc = static_cast<float*>(dCh);
  float* pa = static_cast<float*>(dAh);
#define SSD_BWD_ARGS \
  x, dt, A, B, C, dy, init, dstate, dx, ddt, dA, dB, dC, dinit, st, pb, pc, pa, nb, S, H, b_sb, \
      b_ss, c_sb, c_ss, s
  if (P == WP && N == WN && dtype == 0) return launch_bwd<float, WP, WN>(SSD_BWD_ARGS);
  if (P == WP && N == WN && dtype == 1)
    return launch_bwd_wgmma(x, dt, A, B, C, dy, init, dstate, dx, ddt, dA, dB, dC, dinit, st,
                            dBh, dCh, pa, nb, S, H, b_sb, b_ss, c_sb, c_ss, s);
  if (P == 50 && N == 16 && dtype == 0) return launch_bwd<float, 50, 16>(SSD_BWD_ARGS);
#undef SSD_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
