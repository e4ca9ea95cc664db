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
// What bounds it on an H100: at mamba2's training shape (b 8, S 512, H 64)
// the function needs ~28 GFLOP (nine products per head and sub-chunk, the
// triangular ones halved) and moves ~0.11 GB of inputs and outputs: 0.03 ms
// on the tensor cores in bf16, 0.42 ms at the CUDA cores' fp32 rate.  This
// kernel runs ~39 GFLOP (its triangles in full) on the CUDA cores in fp32
// and writes ~0.4 GB of scratch (states and per-head partials).
//
// What the design does about it (a simple design that is right; the tensor
// cores are a later step): two launches, no atomics, so two runs give the
// same bits.
//   (a) ssd_bwd_kernel, one block of 256 threads per (head, batch row).
//       Pass 1 walks the sub-chunks in order and writes each one's start
//       state and the final state to a scratch (b, H, nsub + 1, P, N) fp32,
//       as the forward would carry them.  Pass 2 walks them in reverse with G
//       in shared memory: every operand of the sub-chunk in shared memory in
//       fp32 (rows padded to an odd length, so that a warp's column reads
//       fall in distinct banks; P padded to a multiple of 4 with zeros), each
//       product a loop of 4 x 4 register tiles per thread on the CUDA cores,
//       the row sums and the reverse cumsum in a fixed order.  dx and ddt are
//       stored per head; dB and dC, which the heads share, as per-head fp32
//       partials (b, H, S, N), and dA's as (b, H).
//   (b) ssd_bwd_reduce_kernel sums the partials over the heads (and dA's over
//       the batch) in order, one thread per output element.
// Shared memory: x, dy and dxdt of 64 x 65, B, C, G, s0 (then exp(cum) dy s0)
// of 64 x 129, the two 64 x 65 score tiles and the row vectors: 213 KB at
// (64, 128), one block per SM; 162-168 registers, no spill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

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

// dB and dC (b, S, N) in T: the heads' partials summed in order, one thread
// an element; dA (H,): the batch rows' partials summed in order
template <typename T>
__global__ void __launch_bounds__(BT)
ssd_bwd_reduce_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
                      const float* __restrict__ dAh, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA, int nb, int S, int H, int N) {
  const size_t idx = (size_t)blockIdx.x * BT + threadIdx.x;
  const size_t plane = (size_t)S * N;
  if (idx < (size_t)nb * plane) {
    const size_t b = idx / plane, sn = idx % plane;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      const size_t off = (b * H + h) * plane + sn;
      sb += dBh[off];
      sc += dCh[off];
    }
    dB[idx] = from_float<T>(sb);
    dC[idx] = from_float<T>(sc);
  }
  if (idx < (size_t)H) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += dAh[(size_t)b * H + idx];
    dA[idx] = s;
  }
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
  const size_t total = (size_t)nb * S * N;
  const size_t blocks = (total > (size_t)H ? total : (size_t)H) + BT - 1;
  ssd_bwd_reduce_kernel<T><<<(unsigned)(blocks / BT), BT, 0, stream>>>(
      dBh, dCh, dAh, static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA), nb, S,
      H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rows of a sub-chunk: the states scratch holds (b, H, ceil(S / rows) +
// 1, P, N) fp32.
extern "C" int ssd_scan_bwd_rows() { return BQ; }

// dtype: 0 = fp32, 1 = bf16 (x, B, C, dy, dx, dB, dC).  (P, N) = (64, 128) or
// (50, 16).  init, dstate and dinit may be null (a zero initial state, a zero
// cotangent of the final state, no d init).  Scratch, fp32: states (b, H,
// ceil(S / ssd_scan_bwd_rows()) + 1, P, N), dBh and dCh (b, H, S, N), dAh (b,
// H).  Returns the cudaError_t of the launches, or cudaErrorInvalidValue for
// what the kernels do not take.
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
  if (P == 64 && N == 128 && dtype == 0) return launch_bwd<float, 64, 128>(SSD_BWD_ARGS);
  if (P == 64 && N == 128 && dtype == 1) return launch_bwd<__nv_bfloat16, 64, 128>(SSD_BWD_ARGS);
  if (P == 50 && N == 16 && dtype == 0) return launch_bwd<float, 50, 16>(SSD_BWD_ARGS);
  if (P == 50 && N == 16 && dtype == 1) return launch_bwd<__nv_bfloat16, 50, 16>(SSD_BWD_ARGS);
#undef SSD_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
