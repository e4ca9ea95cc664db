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
// Two routes, two launches each, no atomics, so two runs give the same
// bits: a kernel per (head or pair of heads, batch row) that recomputes the
// sub-chunks' start states into a scratch and walks the sub-chunks in
// reverse, then ssd_bwd_reduce_kernel (ssd_scan_bwd_reduce.cuh), which sums
// the per-head (or per pair) dB and dC partials over the heads, and dA's
// over the batch rows, in a fixed order, one thread an output element.  (The third route, bf16 at
// (50, 16), is chunk-parallel: ssd_scan_bwd_tc.cu.)
//
// (a) ssd_bwd_wgmma_kernel, bf16 at (64, 128), mamba2_1_3b's training scan:
//   - One block per (pair of heads, batch row), a consumer warpgroup per
//     head (256 threads): 256 blocks at the train shape, in two waves of
//     one block per SM (220 KB of shared memory: two blocks do not fit).
//     Thread 0 asks TMA for each step's tiles through one stage: x and dy
//     of each head (4D maps, box 64 x 1 x 64), B and C (3D maps at the
//     caller's strides), dt (a box of 4 heads, TMA's least 16 bytes); TMA
//     fills rows past S with zeros, so a ragged last sub-chunk has dt = x =
//     B = C = dy = 0 there.  The next step's load is issued when both
//     warpgroups have done with the stage, so it overlaps the step's tail.
//   - Pass 1 walks the sub-chunks in order with the state a wgmma
//     accumulator (m64n128k16, register A), as ssd_wgmma_kernel carries it,
//     and writes each start state to a scratch (b, H, nsub, P, N) fp32.
//   - Pass 2 walks them in reverse with G, the 64 x 128 adjoint of the
//     sub-chunk's end state, an fp32 accumulator in registers from the last
//     sub-chunk to the first; its bf16 copy in shared memory is the operand
//     of B G^T and (x dt w) G.  Per sub-chunk, every product a chain of
//     m64 x {64, 128} x k16 wgmma, both operands from the TMA tiles or the
//     A operand from registers (ldmatrix, .trans for the transposed ones):
//     G's update by (exp(cum) o dy)^T C, issued first, while s0 is read
//     from the scratch; dy x^T and C B^T (formed per head: the products are
//     not what bounds it, and a hand-over between the warpgroups would cost
//     a barrier and 16 KB); L o C B^T and L o dy (x dt)^T (stmatrix to bf16
//     tiles, read back transposed by ldmatrix.trans); M = (C B^T) o L o dy
//     (x dt)^T from the two fp32 accumulators, its row sums by quad
//     shuffles and its column sums by shuffles and, across the warps,
//     shared memory; dxdt = w (B G^T) + (L o C B^T)^T dy; dC = exp(cum) (dy
//     s0) + (L o dy (x dt)^T) B; dB = (x dt w) G + (L o dy (x dt)^T)^T C.
//     L needs one exp2 an element, from cum in log2 units.  dcum's reverse
//     cumsum is a warp scan (shuffles), on warp 0.  dx leaves as bf16 pairs
//     from the accumulator, ddt from the scan.
//   - The pair's dB and dC are summed in the block (the second warpgroup
//     hands its fp32 accumulator over in halves through 16 KB of shared
//     memory, named barriers signalling full and empty), so the partials
//     are (b, H / 2, S, N) fp32.
//   Rounding: only products' operands are bf16: L o C B^T, L o dy (x dt)^T,
//   exp(cum) o dy, x o dt o w in dB, s0, and G in dB.  Two operands are a
//   bf16 pair hi + lo (two products each): pass 1's x o dt o w and G in B
//   G^T.  With one bf16 each, dA (a sum over every row whose terms cancel)
//   missed 1e-2 of its largest value on a ragged S (a CPU model of these
//   roundings, tests/test_torch_ssd_bwd.py); every sum, G, the states, the
//   dcum terms and the reverse cumsum are fp32.
//   Scratch at the train shape: states 134 MB, dB and dC partials 67 MB
//   each, written once and read once, ~0.54 GB with the reduce's reads:
//   five times the function's own bytes.  255 registers a thread (ptxas, no
//   spill); shared memory 220 KB: the stage 65 KB, a head's G hi and lo, s0
//   (16 KB each) and two 64 x 64 tiles (8 KB each), the hand-over 16 KB.
//   What bounds it once it runs (one H100 80GB HBM3 at 700 W, chip_smoke.py
//   and launch/ssd_bwd_probe.py time): 0.35 ms a call at the train shape,
//   11x its byte bound.  About half of that is the scratch (the states
//   ~0.083 ms, the partials' stores ~0.03, the reduce ~0.05, each timed
//   as a copy without it: PERF.md §6); the rest is the sub-chunk chain, ~8 us a
//   step of about nine dependent wgmma groups, two warpgroup barriers and
//   two hand-overs; warp 0's serial dcum work costs nothing measurable.
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
constexpr int ATOM = BQ * 128;    // 64 rows of 64 bf16 (128-byte swizzle)
// the stage: x and dy of each head, B, C, dt (pass 1 loads x, B and dt)
constexpr int ST_X = 0, ST_DY = ST_X + W_HEADS * ATOM, ST_B = ST_DY + W_HEADS * ATOM,
              ST_C = ST_B + 2 * ATOM, ST_DT = ST_C + 2 * ATOM, DT_BYTES = BQ * DT_HEADS * 4,
              STAGE = ST_DT + DT_BYTES;
constexpr int PASS1_BYTES = W_HEADS * ATOM + 2 * ATOM + DT_BYTES;
// a head's tiles: G in bf16 (hi) and the bf16 of what that leaves (lo), s0
// in bf16 (P x N each, two atoms), L o C B^T and L o dy (x dt)^T (64 x 64)
constexpr int T_GHI = 0, T_GLO = 2 * ATOM, T_S0 = 4 * ATOM, T_S1 = 6 * ATOM, T_S2 = 7 * ATOM,
              HEAD_TILES = 8 * ATOM;
// half of a 64 x 128 fp32 accumulator, [16][128] float2: the pair's hand-over
constexpr int PAIR_BYTES = BQ * WN * 4 / 2;
// a head's vectors (fp32): cum (log2 units), dt, exp(cum), w = exp(cum_last -
// cum), exp(cum_last); dcum's row terms, x.dxdt, each warp's column sums of
// M, and each warp's part of <G, s_end> for two sub-chunks
constexpr int V_C = 0, V_D = 64, V_EC = 128, V_W = 192, V_EL = 256, V_ROW = 260, V_XDX = 324,
              V_COL = 388, V_GS = 644, VEC = 656;
constexpr int W_SMEM = 1024 + STAGE + W_HEADS * HEAD_TILES + PAIR_BYTES +
                       W_HEADS * VEC * 4 + 2 * 8;
// named barriers: 1 + wg a warpgroup's own; the pair's hand-over
constexpr int BAR_PAIR_FULL = 3, BAR_PAIR_EMPTY = 4;

static_assert(STAGE % 1024 == 0 && HEAD_TILES % 1024 == 0 && PAIR_BYTES % 1024 == 0,
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
// D[r + 8 hh][8 j + 2 q + e].  A register A fragment of k16 is a[2 c + hh] =
// A[r + 8 hh][8 c + 2 q + {0, 1}].
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
  // the A fragments (64 x 64, k = 64) of a tile as stored, A[i][j] = tile[i][j]
  __device__ __forceinline__ void frag(uint32_t (&a)[16], const unsigned char* tile) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t u[4];
      hopper::ldmatrix_x4(u, tile + swz(16 * warp + 8 * ((lane / 8) % 2) + lane % 8,
                                        16 * kk + 8 * (lane / 16)));
#pragma unroll
      for (int c = 0; c < 4; ++c) a[4 * kk + c] = u[c];
    }
  }
  // the A fragments of a tile transposed, A[i][j] = tile[j][i] (matrix m =
  // lane / 8 of ldmatrix.trans: rows j of k-step kk, columns i of chunk 2
  // warp + m % 2), each element j of a[4 kk + c] times scale[j] when given
  __device__ __forceinline__ void frag_t(uint32_t (&a)[16], const unsigned char* tile,
                                         const float* scale = nullptr) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int mi = lane / 8, jr = 16 * kk + 8 * (mi / 2) + lane % 8;
      uint32_t u[4];
      hopper::ldmatrix_x4_trans(u, tile + swz(jr, 8 * (2 * warp + mi % 2)));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (scale) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[c]));
          const float2 s = *reinterpret_cast<const float2*>(scale + 16 * kk + 8 * (c / 2) + 2 * q);
          a[4 * kk + c] = hopper::pack_bf16(v.x * s.x, v.y * s.y);
        } else {
          a[4 * kk + c] = u[c];
        }
      }
    }
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
                     float* __restrict__ dBp, float* __restrict__ dCp, float* __restrict__ dAh,
                     float* __restrict__ dinit, float* __restrict__ states, int S, int H) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stage = smem;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  unsigned char* tiles = smem + STAGE + wg * HEAD_TILES;
  unsigned char* ghi = tiles + T_GHI;
  unsigned char* glo = tiles + T_GLO;
  unsigned char* s0t = tiles + T_S0;
  unsigned char* s1t = tiles + T_S1;
  unsigned char* s2t = tiles + T_S2;
  float2* pair = reinterpret_cast<float2*>(smem + STAGE + W_HEADS * HEAD_TILES);
  float* v = reinterpret_cast<float*>(smem + STAGE + W_HEADS * HEAD_TILES + PAIR_BYTES) + wg * VEC;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGE + W_HEADS * HEAD_TILES + PAIR_BYTES +
                                               W_HEADS * VEC * 4);
  uint64_t* empty = full + 1;
  const unsigned char* xs = stage + ST_X + wg * ATOM;
  const unsigned char* dys = stage + ST_DY + wg * ATOM;
  const unsigned char* bs = stage + ST_B;
  const unsigned char* cs = stage + ST_C;

  const int h0 = blockIdx.x * W_HEADS, b = blockIdx.y, h = h0 + wg;
  const size_t bh = (size_t)b * H + h;
  const int nsub = (S + BQ - 1) / BQ, nsteps = 2 * nsub;
  const Lane ln(t);
  const int warp = ln.warp, lane = ln.lane, q = ln.q, r = ln.r;
  const float a = A[h], a2 = a * LOG2E;  // cum in log2 units
  float* st_base = states + bh * (size_t)nsub * WP * WN;

  // step s < nsub: pass 1 over sub-chunk s; then pass 2 over the sub-chunks
  // in reverse.  One stage: thread 0 loads the next step once both
  // warpgroups have released this one.
  auto load = [&](int step) {
    const bool p2 = step >= nsub;
    const int row = (p2 ? nsteps - 1 - step : step) * BQ;
    mbar_arrive_expect_tx(full, p2 ? STAGE : PASS1_BYTES);
    for (int hh = 0; hh < W_HEADS; ++hh) {
      tma_load_4d(stage + ST_X + hh * ATOM, &xmap, full, 0, h0 + hh, row, b);
      if (p2) tma_load_4d(stage + ST_DY + hh * ATOM, &dymap, full, 0, h0 + hh, row, b);
    }
    for (int c = 0; c < 2; ++c) {
      tma_load_3d(stage + ST_B + c * ATOM, &bmap, full, 64 * c, row, b);
      if (p2) tma_load_3d(stage + ST_C + c * ATOM, &cmap, full, 64 * c, row, b);
    }
    tma_load_3d(stage + ST_DT, &dtmap, full, h0 - h0 % DT_HEADS, row, b);
  };
  auto release = [&](int step) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
    if (threadIdx.x == 0 && step + 1 < nsteps) {
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
      const float cl = __shfl_sync(0xffffffffu, c1, 31);
      v[V_C + lane] = c0;
      v[V_C + lane + 32] = c1;
      v[V_D + lane] = d0;
      v[V_D + lane + 32] = d1;
      v[V_EC + lane] = ex2(c0);
      v[V_EC + lane + 32] = ex2(c1);
      v[V_W + lane] = ex2(cl - c0);
      v[V_W + lane + 32] = ex2(cl - c1);
      if (lane == 0) v[V_EL] = ex2(cl);
    }
    named_bar_sync(1 + wg, 128);
  };
  // the pair's sum of a 64 x 128 partial (dB or dC of this sub-chunk):
  // the second warpgroup hands its half over, the first adds its own and
  // stores the rows below S of (b, H / 2, S, N), one half at a time
  auto pair_sum = [&](const float (&d)[64], float* out, int c0, int rows) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (wg == 1) {
        named_bar_sync(BAR_PAIR_EMPTY, W_THREADS);
#pragma unroll
        for (int k = 0; k < 16; ++k)
          pair[k * 128 + t] = make_float2(d[32 * half + 2 * k], d[32 * half + 2 * k + 1]);
        named_bar_arrive(BAR_PAIR_FULL, W_THREADS);
      } else {
        named_bar_sync(BAR_PAIR_FULL, W_THREADS);
        float* base = out + ((size_t)(b * (H / W_HEADS) + blockIdx.x) * S + c0) * WN;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int idx = 32 * half + 2 * k, j = idx / 4, hh = (idx / 2) % 2, i = r + 8 * hh;
          const float2 o = pair[k * 128 + t];
          if (i < rows)
            *reinterpret_cast<float2*>(base + (size_t)i * WN + 8 * j + 2 * q) =
                make_float2(d[idx] + o.x, d[idx + 1] + o.y);
        }
        named_bar_arrive(BAR_PAIR_EMPTY, W_THREADS);
      }
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(empty, W_THREADS / 32);  // every warp of both warpgroups
    fence_barrier_init();
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
  if (wg == 0) named_bar_arrive(BAR_PAIR_EMPTY, W_THREADS);  // the hand-over starts empty

  // ---- pass 1: the start state of every sub-chunk into the scratch, the
  // state a wgmma accumulator: s <- exp(cum_last) s + (x o dt w)^T B, x o dt w
  // rounded to bf16 twice (hi + lo: one bf16 would cost dA the fine limit)
  float st[64];
  if (init) ln.load_state(st, init + bh * WP * WN);
  else zero(st);
  for (int k = 0; k < nsub; ++k) {
    mbar_wait(full, k & 1);
    scan();
    ln.store_state(st, st_base + (size_t)k * WP * WN);
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int mi = lane / 8, jr = 16 * kk + 8 * (mi / 2) + lane % 8;
      uint32_t u[4];
      ldmatrix_x4_trans(u, xs + swz(jr, 8 * (2 * warp + mi % 2)));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 16 * kk + 8 * (c / 2) + 2 * q;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[c]));
        const float f0 = xv.x * v[V_D + j] * v[V_W + j], f1 = xv.y * v[V_D + j + 1] * v[V_W + j + 1];
        hi[4 * kk + c] = pack_bf16(f0, f1);
        lo[4 * kk + c] = pack_bf16_rest(f0, f1);
      }
    }
    const float el = v[V_EL];
#pragma unroll
    for (int i = 0; i < 64; ++i) st[i] *= el;
    fence_regs(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a4[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3]};
      wgmma_rs_n128<1>(st, a4, make_desc(bs + kk * 2048, ATOM, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a4[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3]};
      wgmma_rs_n128<1>(st, a4, make_desc(bs + kk * 2048, ATOM, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    release(k);
    named_bar_sync(1 + wg, 128);  // the vectors are read
  }

  // ---- pass 2: G, the adjoint of the sub-chunk's end state, an fp32
  // accumulator from the last sub-chunk to the first; its bf16 hi and lo in
  // shared memory for the products that read it.  <G, s_end> of each
  // sub-chunk is formed one sub-chunk ahead, when its start state is read.
  float g[64];
  if (dstate) ln.load_state(g, dstate + bh * WP * WN);
  else zero(g);
  {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s = fmaf(g[i], st[i], s);
    s = warp_sum(s);
    if (lane == 0) v[V_GS + 4 * ((nsub - 1) & 1) + warp] = s;
  }
  ln.store_bf16(ghi, g);
  ln.store_bf16<true>(glo, g);
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);

  float dA_acc = 0.f;  // warp 0: this head's dt da over its rows
  for (int k = nsub - 1; k >= 0; --k) {
    const int step = nsteps - 1 - k, c0 = k * BQ, rows = min(BQ, S - c0);
    mbar_wait(full, step & 1);
    scan();
    float ci[2], eci[2], wi[2], di[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ci[hh] = v[V_C + r + 8 * hh];
      eci[hh] = v[V_EC + r + 8 * hh];
      wi[hh] = v[V_W + r + 8 * hh];
      di[hh] = v[V_D + r + 8 * hh];
    }
    float rterm[2];  // dcum's terms of rows r, r + 8

    // (1) G <- exp(cum_last) G + (exp(cum) o dy)^T C, its start state's
    // adjoint, while s0 is read from the scratch; then <G, s0> (the next
    // sub-chunk's <G, s_end>) and s0 in bf16
    {
      uint32_t fa[16];
      ln.frag_t(fa, dys, v + V_EC);
      const float el = v[V_EL];
#pragma unroll
      for (int i = 0; i < 64; ++i) g[i] *= el;
      fence_regs(g);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a4[4] = {fa[4 * kk], fa[4 * kk + 1], fa[4 * kk + 2], fa[4 * kk + 3]};
        wgmma_rs_n128<1>(g, a4, make_desc(cs + kk * 2048, ATOM, 1024), 1);
      }
      wgmma_commit();
      float sv[64];
      ln.load_state(sv, st_base + (size_t)k * WP * WN);
      wgmma_wait<0>();
      fence_regs(g);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) s = fmaf(g[i], sv[i], s);
      s = warp_sum(s);
      if (lane == 0) v[V_GS + 4 * ((k + 1) & 1) + warp] = s;
      ln.store_bf16(s0t, sv);
    }

    // DX = dy x^T and C B^T (both operands K-major); S1 = L o C B^T, S2 = L o
    // DX o dt_j to bf16 tiles; M = L o C B^T o DX o dt_j below the diagonal,
    // its row sums (dcum's first term) and column sums (its second)
    {
      float dxa[32], cba[32];
      zero(dxa);
      zero(cba);
      fence_regs(dxa);
      fence_regs(cba);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64<0>(dxa, make_desc(dys + kk * 32, 16, 1024), make_desc(xs + kk * 32, 16, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int off = (kk / 4) * ATOM + (kk % 4) * 32;
        wgmma_ss_n64<0>(cba, make_desc(cs + off, 16, 1024), make_desc(bs + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxa);
      fence_regs(cba);
      float rowm[2] = {0.f, 0.f}, colm[16];
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
          colm[2 * j + e] = cs_;
        }
      }
      ln.store_bf16(s1t, cba);
      ln.store_bf16(s2t, dxa);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) rterm[hh] = quad_sum(rowm[hh]);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float x = colm[c];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (lane < 4) v[V_COL + 64 * warp + 8 * (c / 2) + 2 * q + c % 2] = x;
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);

    // (2) dxdt = w (B G^T) + S1^T dy, with dcum's term - w dt x.(B G^T);
    // then dC = exp(cum) (dy s0) + S2 B, with exp(cum) C.(dy s0).  One
    // chain after the other: both at once would not fit the registers.
    float xdx[2];
    {
      float bg[32];
      zero(bg);
      fence_regs(bg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {  // G's hi, then its lo
        const int off = ((kk % 8) / 4) * ATOM + (kk % 4) * 32;
        wgmma_ss_n64<0>(bg, make_desc(bs + off, 16, 1024),
                        make_desc((kk < 8 ? ghi : glo) + off, 16, 1024), 1);
      }
      wgmma_commit();
      uint32_t fs[16];
      ln.frag_t(fs, s1t);
      wgmma_wait<0>();
      fence_regs(bg);
      {
        float xg[2];
        ln.rowdot(xg, xs, bg);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rterm[hh] -= wi[hh] * di[hh] * xg[hh];
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
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a4[4] = {fs[4 * kk], fs[4 * kk + 1], fs[4 * kk + 2], fs[4 * kk + 3]};
        wgmma_rs_n64<1>(bg, a4, make_desc(dys + kk * 2048, ATOM, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(bg);
      ln.rowdot(xdx, xs, bg);
      // dx = dt dxdt, rows below S
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
    {
      float acc[64];
      zero(acc);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128<0, 1>(acc, make_desc(dys + kk * 32, 16, 1024),
                            make_desc(s0t + kk * 2048, ATOM, 1024), 1);
      wgmma_commit();
      uint32_t f2[16];
      ln.frag(f2, s2t);
      wgmma_wait<0>();
      fence_regs(acc);
      {
        float cd[2];
        ln.rowdot(cd, cs, acc);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rterm[hh] += eci[hh] * cd[hh];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            acc[4 * j + 2 * hh] *= eci[hh];
            acc[4 * j + 2 * hh + 1] *= eci[hh];
          }
        }
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a4[4] = {f2[4 * kk], f2[4 * kk + 1], f2[4 * kk + 2], f2[4 * kk + 3]};
        wgmma_rs_n128<1>(acc, a4, make_desc(bs + kk * 2048, ATOM, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      pair_sum(acc, dCp, c0, rows);
    }

    // (3) dB = (x o dt w) G + S2^T C (G's bf16 hi), the stage's last reads
    {
      uint32_t fx[16], fs[16];
      ln.frag(fx, xs);
#pragma unroll
      for (int c = 0; c < 16; ++c) {  // a[2 c' + hh]: rows r + 8 hh
        const float sc = di[c % 2] * wi[c % 2];
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&fx[c]));
        fx[c] = pack_bf16(xv.x * sc, xv.y * sc);
      }
      ln.frag_t(fs, s2t);
      float acc[64];
      zero(acc);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a4[4] = {fx[4 * kk], fx[4 * kk + 1], fx[4 * kk + 2], fx[4 * kk + 3]};
        wgmma_rs_n128<1>(acc, a4, make_desc(ghi + kk * 2048, ATOM, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a4[4] = {fs[4 * kk], fs[4 * kk + 1], fs[4 * kk + 2], fs[4 * kk + 3]};
        wgmma_rs_n128<1>(acc, a4, make_desc(cs + kk * 2048, ATOM, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(step);
      pair_sum(acc, dBp, c0, rows);
    }

    // (4) the new G's bf16 hi and lo; dcum, its reverse cumsum da, ddt and
    // dt da, in order, on warp 0
    ln.store_bf16(ghi, g);
    ln.store_bf16<true>(glo, g);
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
      const float* gs = v + V_GS + 4 * (k & 1);
      float dc[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = lane + 32 * half;
        dc[half] = v[V_ROW + i] - (((v[V_COL + i] + v[V_COL + 64 + i]) + v[V_COL + 128 + i]) +
                                   v[V_COL + 192 + i]);
      }
      if (lane == 31) dc[1] += ((gs[0] + gs[1]) + gs[2]) + gs[3];  // <G, s_end> on row 63
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
        if (i < rows) ddt[((size_t)b * S + c0 + i) * H + h] = fmaf(a, dc[half], v[V_XDX + i]);
        dA_acc = fmaf(v[V_D + i], dc[half], dA_acc);
      }
    }
  }

  if (dinit) ln.store_state(g, dinit + bh * WP * WN);
  if (warp == 0) {
    dA_acc = warp_sum(dA_acc);
    if (lane == 0) dAh[bh] = dA_acc;
  }
  if (wg == 1) named_bar_sync(BAR_PAIR_EMPTY, W_THREADS);  // the first warpgroup's last arrival
}

int launch_bwd_wgmma(const void* x, const void* dt, const void* A, const void* B, const void* C,
                     const void* dy, const void* init, const void* dstate, void* dx, void* ddt,
                     void* dA, void* dB, void* dC, void* dinit, float* states, float* dBp,
                     float* dCp, float* dAh, int nb, int S, int H, int b_sb, int b_ss, int c_sb,
                     int c_ss, cudaStream_t stream) {
  if (H % DT_HEADS != 0) return static_cast<int>(cudaErrorInvalidValue);
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
  cudaError_t err = hopper::allow_smem(ssd_bwd_wgmma_kernel, W_SMEM, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_wgmma_kernel<<<dim3(H / W_HEADS, nb), W_THREADS, W_SMEM, stream>>>(
      xmap, dymap, bmap, cmap, dtmap, static_cast<const float*>(A),
      static_cast<const float*>(init), static_cast<const float*>(dstate),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ddt), dBp, dCp, dAh,
      static_cast<float*>(dinit), states, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<__nv_bfloat16>(dBp, dCp, dAh, dB, dC, dA, nb, S, H / W_HEADS, H, WN, 1,
                                      stream);
}

}  // namespace

// The rows of a sub-chunk: the states scratch holds ceil(S / rows) (+ 1 on
// the CUDA cores) states per (batch row, head).
extern "C" int ssd_scan_bwd_rows() { return BQ; }

// dtype: 0 = fp32, 1 = bf16 (x, B, C, dy, dx, dB, dC).  (P, N) = (64, 128),
// or (50, 16) in fp32 (bf16 at (50, 16) is ssd_scan_bwd_tc's).  init, dstate
// and dinit may be null (a zero initial state, a zero cotangent of the final
// state, no d init).  bf16 at (64, 128) takes the wgmma kernel (H % 4 == 0,
// 16-byte aligned pointers and B / C strides); its scratch, fp32: states (b,
// H, nsub, P, N), nsub = ceil(S / ssd_scan_bwd_rows()), dBh and dCh (b, H /
// 2, S, N), dAh (b, H).  fp32 takes the CUDA-core kernel; its scratch:
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
  if (P == WP && N == WN && dtype == 1) return launch_bwd_wgmma(SSD_BWD_ARGS);
  if (P == 50 && N == 16 && dtype == 0) return launch_bwd<float, 50, 16>(SSD_BWD_ARGS);
#undef SSD_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
