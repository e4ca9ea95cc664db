// ssd_scan: the Mamba-2 SSD chunk scan with one B/C group shared by the H
// heads, from an optional initial state, returning y and the final state.
//
// Replaces the TPU kernel kernels/ssd_scan.py:ssd_scan (_ssd_kernel) of the
// JAX package, with the init_state / return_state options of
// models/ssd.py:ssd_scan_ref, which the prefill needs to seed decoding.
//
// Layout: x and y (b, S, H, P) in fp32 or bf16, dt (b, S, H) fp32 and A (H,)
// fp32, all contiguous; B and C (b, S, N) in x's type with the given batch
// and sequence strides and a contiguous last dim (views are read in place);
// init_state (or null for zeros) and the final state (b, H, P, N) fp32.
// (P, N) = (64, 128) (mamba2_1_3b; ssd_kernel and ssd_wgmma_kernel) or
// (50, 16) (hymba_1_5b; ssd_simt_kernel in fp32, ssd_tc_kernel in bf16).
//
// What bounds it on an H100: at b 8, S 512, H 64 a call moves ~87 MB (x, y
// and the final state dominate) and needs ~17 GFLOP with C.B^T formed once
// per (batch row, sub-chunk) and shared by the heads, so on the tensor cores
// the least time (~26 us) is set by bytes.
//
// What the design does about it (bf16, ssd_wgmma_kernel): one block per
// (pair of heads, batch row) walks the sequence in sub-chunks of Q = 64
// rows, wgmma's M.  A producer warpgroup asks TMA for each sub-chunk's x
// tiles of its two heads (a 4D map, box 64 x 1 x 64), B and C (3D maps with
// their own strides) and dt (a 3D fp32 map, box of 4 heads: TMA's least
// inner extent is 16 bytes) through a ring of W_STAGES stages; TMA fills
// rows past S with zeros, so a ragged last sub-chunk has dt = 0 and
// x = B = C = 0, rows that neither decay nor feed the state.  Per sub-chunk
// the producer forms G = C B^T once for both heads (wgmma m64n64k16, both
// operands K-major), scans dt A for each head (one warp a head, in log2
// units), and turns G into each head's G o L o dt_j, L[i,j] = exp(cum_i -
// cum_j) for j <= i, as bf16 A fragments in shared memory (double
// buffered, one barrier per head, so the first head starts while the second
// converts).  L is built without an exp per element: left of a warp's 16
// rows as exp(cum_i - cum_{16w-1}) exp(cum_{16w-1} - cum_j), two factors
// <= 1 that cannot overflow, exactly within them.  One consumer warpgroup
// per head holds the 64 x 128 fp32 state as a wgmma accumulator in
// registers from the first sub-chunk to the last (setmaxnreg moves
// registers from the producer):
//   y_off = C state^T (m64n64k16, the state's bf16 copy in shared memory);
//   meanwhile the A fragments of (x o w)^T, w_j = dt_j exp(cum_last -
//   cum_j), x read transposed from its tile by ldmatrix;
//   y = exp(cum_i) y_off + (G o L o dt) x (register A, x an MN-major B);
//   state = exp(cum_last) state + (x o w)^T B (m64n128k16, register A, B
//   an MN-major B), while y goes to bf16 over the head's x tile (stmatrix)
//   and out by one TMA store (rows past S are not written).
// The state's bf16 copy is rewritten for the next sub-chunk (stmatrix), and
// the fp32 state is written once at the end.  Three operands are rounded to
// bf16 where the CUDA-core kernel kept fp32: G o L o dt, the state in
// y_off, and x o w.  Shared memory: 3 stages of 49 KB, the fragments and
// vectors of 2 sub-chunks (40 KB) and two bf16 states of 16 KB, 220 KB, so
// one block of 384 threads per SM, which the registers also require: a
// consumer thread holds 64 fp32 of state, 32 of y and 32 of A fragments,
// and two consumers at 184 registers and the producer at 104 fill the
// SM's 64K.  At b 8 and H 64 the 256 blocks run in two waves over 132
// SMs, each a sequence of 8 sub-chunks: latency, not bytes, bounds it.
//
// fp32 (ssd_kernel) stays on the CUDA cores and exists for parity runs: one
// block per (head, batch row) keeps the state, transposed, in shared memory
// (fp32, rows padded by 4 floats so that 16-byte loads of neighbouring rows
// fall in distinct banks: C and B 2 x 64 x 132, x.dt 64 x 68, G 64 x 68,
// state^T 128 x 68 and four 64-vectors, 138,240 bytes) and runs every
// product as fp32 FMA from register tiles of 4x4 (8x4 for the state).
//
// (50, 16) in fp32 (ssd_simt_kernel) exists for parity runs: one block per
// (head, batch row) of 256 threads walks the sequence in sub-chunks of
// Q = 64 rows on the CUDA cores with x dt, B, C, G = (C B^T) o L, the 50 x
// 16 state and the four 64-vectors in 42 KB of shared memory, one output
// element a thread at a time.
//
// (50, 16) in bf16 (ssd_tc_kernel), hymba_1_5b's served scan.  What bounds
// it: at b 8, S 512, H 64 a call moves ~54 MB (x and y), 0.0165 ms at 3.35
// TB/s, and needs ~3 GFLOP as padded for the tensor cores (~3 us at the
// dense bf16 peak); each block is a chain of S / 64 sub-chunks, so the
// latency of a sub-chunk bounds it next.  What the design does about it:
// - One block per (group of 4 heads, batch row), 16 warps, walks the
//   sequence in sub-chunks of 64 rows.  Four heads is the least group whose
//   rows are whole 16-byte units: its slice of an x row is 4 x 50 x 2 = 400
//   bytes at byte 400 g, of a dt row 16 bytes at byte 16 g.  So TMA takes x
//   as (b S) rows of H P elements, box {200, 64, 1}, unswizzled, and the
//   same map takes y back; B and C as {16, S, b} with the caller's strides,
//   box {16, 64, 1}; dt as the wgmma kernel does.  A ring of 4 stages keeps
//   two sub-chunks in flight ahead of the one computed.  TMA fills rows past
//   S with zeros, rows with dt = 0 that neither decay nor feed the state,
//   and the y store does not write them.
// - A re-layout pass: head h's 50 columns start at byte 100 h, 4-byte
//   aligned only, which ldmatrix cannot address (and a TMA box of 28 words
//   starting there never completed its barrier on the card), so each warp
//   copies its head's rows of the next sub-chunk, a 32-bit word a lane, to
//   a tile of 112-byte rows (P padded to 56 with zeros, in shared memory
//   only; at 112 bytes the eight rows of an ldmatrix fall in distinct
//   banks) once it is done with this one.  Strip 0 of each head, which has
//   the least to do, then scans the next sub-chunk's dt A (log2 units) into
//   the head's vectors.
// - Every product on the tensor cores, mma.sync m16n8k16 (bf16 operands,
//   fp32 sums), not wgmma: the products are small (~3 GFLOP a call), so
//   wgmma's rate would lift nothing that bounds the kernel, while a warp of
//   16 rows skips the blocks right of the diagonal that wgmma's 64-row tile
//   computes, and ldmatrix reads plain row-major tiles where wgmma needs its
//   canonical layouts.  Warp 4 w + hh takes rows 16 w .. 16 w + 15 of head
//   hh, so each of the SM's four schedulers (warp % 4) runs one head:
//     y_off = C state^T (K 16, the state's bf16 copy), times exp(cum_i);
//     per k-step kk <= w: G = C B^T (two 16 x 8 products, K 16), each
//     element times exp(cum_i - cum_j) dt_j (0 for j > i) and rounded to
//     bf16: the accumulator becomes the A fragment of y += (G o L o dt) x
//     (7 column tiles of x).  G never leaves the registers: each head's
//     warps form it from the block's C and B tiles, where forming it once
//     per block would cost a 16 KB fp32 round trip through shared memory and
//     a second barrier, more than the 2 (w + 1) products a warp saves;
//     y goes to bf16 over the stage's x, which the re-layout has read, and
//     leaves by one TMA store after the next barrier;
//     state^T = exp(cum_last) state^T + (B o w)^T x, w_j = dt_j exp(cum_last
//     - cum_j), B o w rounded to bf16 as the A fragment (B read transposed
//     by ldmatrix): warp 4 w + hh keeps column tiles w and w + 4 (< 7) of
//     head hh's state in fp32 accumulator registers from the first
//     sub-chunk to the last; only its bf16 copy in shared memory (the B
//     operand of y_off) is rounded.
// - One __syncthreads per sub-chunk: the x tiles, the vectors and the
//   state's bf16 copy are double buffered, so that a warp may start on the
//   next sub-chunk while others finish this one.  108 registers a thread,
//   ~210 KB of shared memory, one block of 512 threads per SM.
// Three operands are rounded to bf16 where the CUDA-core kernel kept fp32,
// as in the wgmma kernel: G o L o dt, the state in y_off, and B o w.
// Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py): 0.0322 ms at b 8,
// S 512, 1.95x the byte bound (the CUDA-core kernel took 0.3652 ms), and
// 0.1718 ms at b 1, S 4096, about 2.7 us a sub-chunk.  The instruction rate
// does not bound it: forming L from two factors without an exp per element,
// or moving the state's tiles off the busiest strip, made it no faster
// (launch/scan_time.py).  At b 2 (32 blocks) and b 1 (16) most SMs idle
// while a block's 29 or 64 sub-chunks run in sequence.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int SP = 64;         // head dim P
constexpr int SN = 128;        // state dim N
constexpr int Q = 64;          // rows per sub-chunk
constexpr int THREADS = 256;   // 16 x 16 thread grid (r, c)
constexpr int NPAD = SN + 4;   // row of C_s and B_s
constexpr int PPAD = SP + 4;   // row of X_s and St
constexpr int QPAD = Q + 4;    // row of G_s
constexpr int SMEM_FLOATS = 2 * Q * NPAD + Q * PPAD + Q * QPAD + SN * PPAD + 4 * Q;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ init,
           float* __restrict__ y, float* __restrict__ state_out, int S, int H,
           int b_sb, int b_ss, int c_sb, int c_ss) {
  extern __shared__ __align__(16) float smem[];
  float* C_s = smem;                  // [Q][NPAD]   C rows of the sub-chunk
  float* B_s = C_s + Q * NPAD;        // [Q][NPAD]   B rows
  float* X_s = B_s + Q * NPAD;        // [Q][PPAD]   x * dt
  float* G_s = X_s + Q * PPAD;        // [Q][QPAD]   (C B^T) o L
  float* St = G_s + Q * QPAD;         // [SN][PPAD]  the state, transposed
  float* cum = St + SN * PPAD;        // [Q] inclusive cumsum of dt * A
  float* ecum = cum + Q;              // [Q] exp(cum_i)
  float* wdec = ecum + Q;             // [Q] exp(cum_last - cum_i)
  float* dts = wdec + Q;              // [Q] dt, 0 past the end

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const float a = A[h];
  const size_t bh = (size_t)b * H + h;

  for (int e = tid; e < SP * SN; e += THREADS) {
    const int p = e / SN, n = e % SN;
    St[n * PPAD + p] = init ? init[bh * SP * SN + e] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);

    // dt and the per-warp scan of dt * A (rows past the end: dt = 0)
    if (tid < Q) {
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

    // the second warp's scan continues the first's; stage x*dt, B and C
    if (tid >= 32 && tid < Q) cum[tid] += cum[31];
    for (int e = tid; e < Q * SP; e += THREADS) {
      const int i = e / SP, p = e % SP;
      float v = 0.f;
      if (i < rows) v = (x[(((size_t)b * S + c0 + i) * H + h) * SP + p]) * dts[i];
      X_s[i * PPAD + p] = v;
    }
    for (int e = tid; e < Q * SN; e += THREADS) {
      const int i = e / SN, n = e % SN;
      float bv = 0.f, cv = 0.f;
      if (i < rows) {
        bv = (Bm[(size_t)b * b_sb + (size_t)(c0 + i) * b_ss + n]);
        cv = (Cm[(size_t)b * c_sb + (size_t)(c0 + i) * c_ss + n]);
      }
      B_s[i * NPAD + n] = bv;
      C_s[i * NPAD + n] = cv;
    }
    __syncthreads();

    // G[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i; rows i = r + 16a,
    // columns j = c + 16bb
    if (tid < Q) {
      ecum[tid] = expf(cum[tid]);
      wdec[tid] = expf(cum[Q - 1] - cum[tid]);
    }
    {
      float acc[4][4] = {};
      for (int n = 0; n < SN; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(&C_s[(r + 16 * i) * NPAD + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(&B_s[(c + 16 * j) * NPAD + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float s = acc[i][j];
            s = fmaf(cv[i].x, bv[j].x, s);
            s = fmaf(cv[i].y, bv[j].y, s);
            s = fmaf(cv[i].z, bv[j].z, s);
            s = fmaf(cv[i].w, bv[j].w, s);
            acc[i][j] = s;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gi = r + 16 * i, gj = c + 16 * j;
          G_s[gi * QPAD + gj] = gj <= gi ? acc[i][j] * expf(cum[gi] - cum[gj]) : 0.f;
        }
    }
    __syncthreads();

    // y rows i = r + 16a, columns p = 4c .. 4c+3:
    // G (x dt) + exp(cum_i) (C_i . state[p])
    {
      float yd[4][4] = {}, yo[4][4] = {};
      for (int j = 0; j < Q; j += 4) {
        float4 g[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = ld4(&G_s[(r + 16 * i) * QPAD + j]);
#pragma unroll
        for (int m = 0; m < 4; ++m) xv[m] = ld4(&X_s[(j + m) * PPAD + 4 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float gm = at(g[i], m);
            yd[i][0] = fmaf(gm, xv[m].x, yd[i][0]);
            yd[i][1] = fmaf(gm, xv[m].y, yd[i][1]);
            yd[i][2] = fmaf(gm, xv[m].z, yd[i][2]);
            yd[i][3] = fmaf(gm, xv[m].w, yd[i][3]);
          }
      }
      for (int n = 0; n < SN; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(&C_s[(r + 16 * i) * NPAD + n]);
#pragma unroll
        for (int m = 0; m < 4; ++m) sv[m] = ld4(&St[(n + m) * PPAD + 4 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float cm = at(cv[i], m);
            yo[i][0] = fmaf(cm, sv[m].x, yo[i][0]);
            yo[i][1] = fmaf(cm, sv[m].y, yo[i][1]);
            yo[i][2] = fmaf(cm, sv[m].z, yo[i][2]);
            yo[i][3] = fmaf(cm, sv[m].w, yo[i][3]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = r + 16 * i;
        if (gi < rows) {
          const float e = ecum[gi];
          float* dst = y + (((size_t)b * S + c0 + gi) * H + h) * SP + 4 * c;
#pragma unroll
          for (int k = 0; k < 4; ++k) dst[k] = fmaf(e, yo[i][k], yd[i][k]);
        }
      }
    }
    __syncthreads();  // the state was read above and is rewritten below

    // state[p][n] = exp(cum_last) state[p][n] + sum_j wdec_j (x dt)_j[p] B_j[n]
    // for n = r + 16a (8 values), p = 4c .. 4c+3
    {
      const float dlast = ecum[Q - 1];
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = ld4(&St[(r + 16 * i) * PPAD + 4 * c]);
        s[i][0] = v.x * dlast;
        s[i][1] = v.y * dlast;
        s[i][2] = v.z * dlast;
        s[i][3] = v.w * dlast;
      }
      for (int j = 0; j < rows; ++j) {
        const float w = wdec[j];
        const float4 xv = ld4(&X_s[j * PPAD + 4 * c]);
        const float x0 = xv.x * w, x1 = xv.y * w, x2 = xv.z * w, x3 = xv.w * w;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float bj = B_s[j * NPAD + r + 16 * i];
          s[i][0] = fmaf(bj, x0, s[i][0]);
          s[i][1] = fmaf(bj, x1, s[i][1]);
          s[i][2] = fmaf(bj, x2, s[i][2]);
          s[i][3] = fmaf(bj, x3, s[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(&St[(r + 16 * i) * PPAD + 4 * c]) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();  // the next sub-chunk overwrites B_s, X_s and cum
  }

  for (int e = tid; e < SP * SN; e += THREADS) {
    const int p = e / SN, n = e % SN;
    state_out[bh * SP * SN + e] = St[n * PPAD + p];
  }
}

int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
           const void* init, void* y, void* state, int nb, int S, int H, int b_sb, int b_ss,
           int c_sb, int c_ss, cudaStream_t s) {
  static hopper::SmemRaised raised;
  const cudaError_t err = hopper::allow_smem(ssd_kernel, (int)SMEM_BYTES, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<<<dim3(H, nb), THREADS, SMEM_BYTES, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(init),
      static_cast<float*>(y), static_cast<float*>(state), S, H, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- (50, 16) fp32, CUDA cores
constexpr int SIMT_THREADS = 256;

template <typename T, int SP_, int SN_>
__global__ void __launch_bounds__(SIMT_THREADS)
ssd_simt_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ state_out, int S, int H,
                int b_sb, int b_ss, int c_sb, int c_ss) {
  // rows of B and of the state padded to SN_ + 1 floats: lanes that take
  // neighbouring rows (j in C B^T, p in C state) read distinct banks
  constexpr int NP = SN_ + 1;
  __shared__ float X_s[Q][SP_];     // x * dt
  __shared__ float B_s[Q][NP];
  __shared__ float C_s[Q][SN_];
  __shared__ float G_s[Q][Q + 1];   // (C B^T) o L, 0 above the diagonal
  __shared__ float St[SP_][NP];     // the state[p][n]
  __shared__ float cum[Q], ecum[Q], wdec[Q], dts[Q];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float a = A[h];
  const size_t bh = (size_t)b * H + h;
  for (int e = tid; e < SP_ * SN_; e += SIMT_THREADS)
    St[e / SN_][e % SN_] = init ? init[bh * SP_ * SN_ + e] : 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);
    // dt and the per-warp scan of dt * A (rows past the end: dt = 0)
    if (tid < Q) {
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
    // the second warp's scan continues the first's; stage x*dt, B and C
    if (tid >= 32 && tid < Q) cum[tid] += cum[31];
    for (int e = tid; e < Q * SP_; e += SIMT_THREADS) {
      const int i = e / SP_, p = e % SP_;
      X_s[i][p] = i < rows
          ? to_float(x[(((size_t)b * S + c0 + i) * H + h) * SP_ + p]) * dts[i] : 0.f;
    }
    for (int e = tid; e < Q * SN_; e += SIMT_THREADS) {
      const int i = e / SN_, n = e % SN_;
      B_s[i][n] = i < rows ? to_float(Bm[(size_t)b * b_sb + (size_t)(c0 + i) * b_ss + n]) : 0.f;
      C_s[i][n] = i < rows ? to_float(Cm[(size_t)b * c_sb + (size_t)(c0 + i) * c_ss + n]) : 0.f;
    }
    __syncthreads();

    // G[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i
    if (tid < Q) {
      ecum[tid] = expf(cum[tid]);
      wdec[tid] = expf(cum[Q - 1] - cum[tid]);
    }
    for (int e = tid; e < Q * Q; e += SIMT_THREADS) {
      const int i = e / Q, j = e % Q;
      float g = 0.f;
      if (j <= i) {
#pragma unroll
        for (int n = 0; n < SN_; ++n) g = fmaf(C_s[i][n], B_s[j][n], g);
        g *= expf(cum[i] - cum[j]);
      }
      G_s[i][j] = g;
    }
    __syncthreads();

    // y[i][p] = sum_{j <= i} G[i][j] (x dt)_j[p] + exp(cum_i) (C_i . state[p])
    for (int e = tid; e < rows * SP_; e += SIMT_THREADS) {
      const int i = e / SP_, p = e % SP_;
      float yd = 0.f, yo = 0.f;
      for (int j = 0; j <= i; ++j) yd = fmaf(G_s[i][j], X_s[j][p], yd);
#pragma unroll
      for (int n = 0; n < SN_; ++n) yo = fmaf(C_s[i][n], St[p][n], yo);
      y[(((size_t)b * S + c0 + i) * H + h) * SP_ + p] = from_float<T>(fmaf(ecum[i], yo, yd));
    }
    __syncthreads();  // the state was read above and is rewritten below

    // state[p][n] = exp(cum_last) state[p][n] + sum_j wdec_j (x dt)_j[p] B_j[n]
    const float dlast = ecum[Q - 1];
    for (int e = tid; e < SP_ * SN_; e += SIMT_THREADS) {
      const int p = e / SN_, n = e % SN_;
      float st = St[p][n] * dlast;
      for (int j = 0; j < rows; ++j) st = fmaf(wdec[j] * X_s[j][p], B_s[j][n], st);
      St[p][n] = st;
    }
    __syncthreads();  // the next sub-chunk overwrites B_s, X_s and cum
  }

  for (int e = tid; e < SP_ * SN_; e += SIMT_THREADS)
    state_out[bh * SP_ * SN_ + e] = St[e / SN_][e % SN_];
}

template <typename T, int SP_, int SN_>
int launch_simt(const void* x, const void* dt, const void* A, const void* B, const void* C,
                const void* init, void* y, void* state, int nb, int S, int H, int b_sb,
                int b_ss, int c_sb, int c_ss, cudaStream_t s) {
  ssd_simt_kernel<T, SP_, SN_><<<dim3(H, nb), SIMT_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(state), S, H, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- bf16 path, wgmma
constexpr int W_HEADS = 2;                    // heads per block, a consumer warpgroup each
constexpr int W_STAGES = 3;                   // the TMA ring
constexpr int W_THREADS = (W_HEADS + 1) * 128;  // the consumers, then the producer warpgroup
constexpr int PRODUCER_REGS = 104, CONSUMER_REGS = 184;
constexpr int DT_HEADS = 4;                   // heads in a dt box: 16 bytes, TMA's least
constexpr int ATOM = Q * 128;                 // 64 rows of 64 bf16 (128-byte swizzle)
constexpr int ST_X = 0;                       // stage: x of each head, B, C, dt
constexpr int ST_B = ST_X + W_HEADS * ATOM;
constexpr int ST_C = ST_B + 2 * ATOM;
constexpr int ST_DT = ST_C + 2 * ATOM;
constexpr int STAGE = ST_DT + Q * DT_HEADS * 4;
constexpr int PA_BYTES = Q * Q * 2;           // a head's G o L o dt, bf16 A fragments
// a head's vectors over the sub-chunk's rows, fp32: for the consumer w_j =
// dt_j exp(cum_last - cum_j), exp(cum_i) and exp(cum_last); for the
// producer cum, dt and, for each warp w = 1..3 of 16 rows, F_w[j] = dt_j
// exp(cum_{16 w - 1} - cum_j) over the columns j < 16 w
constexpr int V_W = 0, V_EC = 64, V_EL = 128, V_C = 132, V_D = 196, V_F = 260, VEC = 512;
constexpr int SBF_BYTES = SP * SN * 2;        // a head's state in bf16
constexpr int W_SMEM = 1024 + W_STAGES * STAGE + 2 * W_HEADS * (PA_BYTES + VEC * 4) +
                       W_HEADS * SBF_BYTES + (2 * W_STAGES + 2 * W_HEADS + 2) * 8;
static_assert(STAGE % 1024 == 0 && PA_BYTES % 1024 == 0 && SBF_BYTES % 1024 == 0 &&
                  (2 * W_HEADS * (PA_BYTES + VEC * 4)) % 1024 == 0,
              "tiles must stay 1024-byte aligned for the 128-byte swizzle");
static_assert(W_SMEM <= 232448, "more shared memory than a block may have");
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * W_HEADS <= 168 * W_THREADS,
              "setmaxnreg must stay within the registers the block was launched with");

// Byte offset of element (row, col) of a tile of 64-column atoms (rows of
// 128 bytes, 16-byte chunks XOR-swizzled by row % 8), as TMA lays them out
// and wgmma reads them.
__device__ __forceinline__ int swz(int row, int col) {
  return (col / 64) * ATOM + row * 128 + ((((col % 64) / 8) ^ (row % 8)) << 4) + (col % 8) * 2;
}


__global__ void __launch_bounds__(W_THREADS, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap ymap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap,
                 const __grid_constant__ CUtensorMap dtmap, const float* __restrict__ A,
                 const float* __restrict__ init, float* __restrict__ state_out, int S, int H) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = smem;
  unsigned char* pa_ring = smem + W_STAGES * STAGE;             // [2][W_HEADS] tiles
  float* vec_ring = reinterpret_cast<float*>(pa_ring + 2 * W_HEADS * PA_BYTES);  // [2][W_HEADS]
  unsigned char* sbf = reinterpret_cast<unsigned char*>(vec_ring + 2 * W_HEADS * VEC);
  uint64_t* full = reinterpret_cast<uint64_t*>(sbf + W_HEADS * SBF_BYTES);
  uint64_t* empty = full + W_STAGES;
  uint64_t* gfull = empty + W_STAGES;  // [2][W_HEADS]: a head's fragments are ready
  uint64_t* gempty = gfull + 2 * W_HEADS;

  const int h0 = blockIdx.x * W_HEADS, b = blockIdx.y;
  const int nsteps = (S + Q - 1) / Q;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W_HEADS * 4);  // one arrival per consumer warp
    }
    for (int g = 0; g < 2; ++g) {
      for (int hh = 0; hh < W_HEADS; ++hh) mbar_init(&gfull[g * W_HEADS + hh], 128);  // producer threads
      mbar_init(&gempty[g], W_HEADS * 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32, warp = t / 32;
  // accumulator rows r and r + 8, columns 8 j + 2 q + {0, 1}; r % 8 == lane / 4
  const int r = 16 * warp + lane / 4, q = lane % 4;
  if (wg == W_HEADS) {
    // ---------------- producer: the loads; per sub-chunk G = C B^T, each
    // head's scan of dt A and its G o L o dt as bf16 A fragments
    setmaxnreg_dec<PRODUCER_REGS>();
    auto load = [&](int step) {
      const int s = step % W_STAGES, row = step * Q;
      unsigned char* st = stages + s * STAGE;
      mbar_arrive_expect_tx(&full[s], STAGE);
      for (int hh = 0; hh < W_HEADS; ++hh)
        tma_load_4d(st + ST_X + hh * ATOM, &xmap, &full[s], 0, h0 + hh, row, b);
      for (int a = 0; a < 2; ++a) {
        tma_load_3d(st + ST_B + a * ATOM, &bmap, &full[s], 64 * a, row, b);
        tma_load_3d(st + ST_C + a * ATOM, &cmap, &full[s], 64 * a, row, b);
      }
      tma_load_3d(st + ST_DT, &dtmap, &full[s], h0 - h0 % DT_HEADS, row, b);
    };
    if (t == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&ymap);
      tma_prefetch_map(&bmap);
      tma_prefetch_map(&cmap);
      tma_prefetch_map(&dtmap);
      for (int step = 0; step < min(W_STAGES, nsteps); ++step) load(step);
    }
    __syncwarp();
    const float a2 = warp < W_HEADS ? A[h0 + warp] * LOG2E : 0.f;  // cum in log2 units
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % W_STAGES, g = step & 1;
      mbar_wait(&full[s], (step / W_STAGES) & 1);
      const unsigned char* st = stages + s * STAGE;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SN / 16; ++kk) {
        const int off = (kk / 4) * ATOM + (kk % 4) * 32;
        wgmma_ss_n64<0>(acc, make_desc(st + ST_C + off, 16, 1024),
                        make_desc(st + ST_B + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if (step >= 2) mbar_wait(&gempty[g], ((step - 2) / 2) & 1);

      // warp hh < W_HEADS: head h0 + hh's inclusive scan of dt A, lane l
      // holding rows l (c0) and l + 32 (c1), and its vectors
      if (warp < W_HEADS) {
        const float* dts = reinterpret_cast<const float*>(st + ST_DT);
        const int hl = (h0 + warp) % DT_HEADS;
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
        const float cr[3] = {__shfl_sync(0xffffffffu, c0, 15), __shfl_sync(0xffffffffu, c0, 31),
                             __shfl_sync(0xffffffffu, c1, 15)};  // cum at rows 15, 31, 47
        float* v = vec_ring + (g * W_HEADS + warp) * VEC;
        v[V_W + lane] = d0 * ex2(cl - c0);
        v[V_W + lane + 32] = d1 * ex2(cl - c1);
        v[V_EC + lane] = ex2(c0);
        v[V_EC + lane + 32] = ex2(c1);
        if (lane == 0) v[V_EL] = ex2(cl);
        v[V_C + lane] = c0;
        v[V_C + lane + 32] = c1;
        v[V_D + lane] = d0;
        v[V_D + lane + 32] = d1;
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          if (lane < 16 * w) v[V_F + 64 * (w - 1) + lane] = d0 * ex2(cr[w - 1] - c0);
          if (lane + 32 < 16 * w) v[V_F + 64 * (w - 1) + lane + 32] = d1 * ex2(cr[w - 1] - c1);
        }
      }
      named_bar_sync(3, 128);
      wgmma_wait<0>();
      fence_regs(acc);

      // M = G o L o dt_j, L[i,j] = exp(cum_i - cum_j) for j <= i.  This
      // warp's rows i lie in 16 w .. 16 w + 15: left of that band L dt_j =
      // exp(cum_i - cum_{16 w - 1}) F_w[j], both factors <= 1; in the band
      // exactly; right of it 0.  Branch-free, so that acc's index stays a
      // constant and the blocks of columns interleave.
#pragma unroll
      for (int hh = 0; hh < W_HEADS; ++hh) {
        const float* v = vec_ring + (g * W_HEADS + hh) * VEC;
        const float* F = v + V_F + 64 * max(warp - 1, 0);
        const float cref = v[V_C + max(16 * warp - 1, 0)];
        float ci[2], rf[2], band[2][2][2];
#pragma unroll
        for (int ih = 0; ih < 2; ++ih) {
          ci[ih] = v[V_C + r + 8 * ih];
          rf[ih] = ex2(ci[ih] - cref);
        }
#pragma unroll
        for (int b2 = 0; b2 < 2; ++b2) {
          const int j = 16 * warp + 8 * b2 + 2 * q;
          const float2 cj = *reinterpret_cast<const float2*>(v + V_C + j);
          const float2 dj = *reinterpret_cast<const float2*>(v + V_D + j);
#pragma unroll
          for (int ih = 0; ih < 2; ++ih) {
            const int i = r + 8 * ih;
            band[ih][b2][0] = j <= i ? ex2(ci[ih] - cj.x) * dj.x : 0.f;
            band[ih][b2][1] = j + 1 <= i ? ex2(ci[ih] - cj.y) * dj.y : 0.f;
          }
        }
        uint32_t pa[16];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 f = *reinterpret_cast<const float2*>(F + 8 * jj + 2 * q);
          const bool left = jj < 2 * warp, b0 = jj == 2 * warp, b1 = jj == 2 * warp + 1;
#pragma unroll
          for (int ih = 0; ih < 2; ++ih) {
            const float f0 = left ? rf[ih] * f.x : b0 ? band[ih][0][0] : b1 ? band[ih][1][0] : 0.f;
            const float f1 = left ? rf[ih] * f.y : b0 ? band[ih][0][1] : b1 ? band[ih][1][1] : 0.f;
            pa[4 * (jj / 2) + 2 * (jj % 2) + ih] =
                pack_bf16(acc[4 * jj + 2 * ih] * f0, acc[4 * jj + 2 * ih + 1] * f1);
          }
        }
        uint4* dst = reinterpret_cast<uint4*>(pa_ring + (g * W_HEADS + hh) * PA_BYTES);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dst[k * 128 + t] = make_uint4(pa[4 * k], pa[4 * k + 1], pa[4 * k + 2], pa[4 * k + 3]);
        // the first head's consumer starts while the next head converts
        mbar_arrive(&gfull[g * W_HEADS + hh]);
      }
      // the stage of the step before takes the step W_STAGES - 1 ahead
      const int next = step - 1 + W_STAGES;
      if (t == 0 && step >= 1 && next < nsteps) {
        mbar_wait(&empty[(step - 1) % W_STAGES], ((step - 1) / W_STAGES) & 1);
        load(next);
      }
      __syncwarp();
    }
  } else {
    // ---------------- consumer wg: head h0 + wg
    setmaxnreg_inc<CONSUMER_REGS>();
    const int h = h0 + wg;
    const size_t bh = (size_t)b * H + h;
    unsigned char* sb = sbf + wg * SBF_BYTES;

    float st[64];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float2 v = make_float2(0.f, 0.f);
        if (init) v = *reinterpret_cast<const float2*>(init + (bh * SP + r + 8 * hh) * SN + 8 * j + 2 * q);
        st[4 * j + 2 * hh] = v.x;
        st[4 * j + 2 * hh + 1] = v.y;
      }
    // an accumulator of 64 rows in bf16 to a swizzled tile: matrix m of
    // stmatrix k holds rows 16 warp + 8 (m % 2) .., columns 8 (2 k + m / 2) ..
    const int srow = 16 * warp + 8 * ((lane / 8) % 2) + lane % 8, scol = 8 * (lane / 16);
    auto store_bf16 = [&](unsigned char* tile, auto& d) {
      constexpr int n = sizeof(d) / sizeof(d[0]);  // 8 per 16 columns
#pragma unroll
      for (int k = 0; k < n / 8; ++k)
        stmatrix_x4(tile + swz(srow, 16 * k + scol), pack_bf16(d[8 * k], d[8 * k + 1]),
                    pack_bf16(d[8 * k + 2], d[8 * k + 3]), pack_bf16(d[8 * k + 4], d[8 * k + 5]),
                    pack_bf16(d[8 * k + 6], d[8 * k + 7]));
    };
    store_bf16(sb, st);  // the state's bf16 copy: the B operand of y_off
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);

    for (int step = 0; step < nsteps; ++step) {
      const int s = step % W_STAGES, g = step & 1;
      mbar_wait(&full[s], (step / W_STAGES) & 1);
      unsigned char* xs = stages + s * STAGE + ST_X + wg * ATOM;
      const unsigned char* bs = stages + s * STAGE + ST_B;
      const unsigned char* cs = stages + s * STAGE + ST_C;

      // y_off = C state^T, from the state's bf16 copy
      float y[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] = 0.f;
      fence_regs(y);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SN / 16; ++kk) {
        const int off = (kk / 4) * ATOM + (kk % 4) * 32;
        wgmma_ss_n64<0>(y, make_desc(cs + off, 16, 1024), make_desc(sb + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      // warp 0 releases the stage before once its y store has left the x tile
      if (step > 0 && warp == 0) {
        if (t == 0) bulk_wait_read<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(step - 1) % W_STAGES]);
      }

      // the producer's A fragments of G o L o dt and this head's vectors
      mbar_wait(&gfull[g * W_HEADS + wg], (step / 2) & 1);
      const float* v = vec_ring + (g * W_HEADS + wg) * VEC;
      uint32_t pa[16];
      const uint4* src = reinterpret_cast<const uint4*>(pa_ring + (g * W_HEADS + wg) * PA_BYTES);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 u = src[k * 128 + t];
        pa[4 * k] = u.x;
        pa[4 * k + 1] = u.y;
        pa[4 * k + 2] = u.z;
        pa[4 * k + 3] = u.w;
      }
      // (x o w)^T as the A fragments of the update: x^T read by ldmatrix.trans
      // (matrix m = lane / 8: rows j of k-step kk, columns p of chunk 2 warp + m % 2)
      uint32_t xa[16];
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const int mi = lane / 8, jr = 16 * kk + 8 * (mi / 2) + lane % 8;
        uint32_t u[4];
        ldmatrix_x4_trans(u, xs + swz(jr, 8 * (2 * warp + mi % 2)));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[c]));
          const float2 w = *reinterpret_cast<const float2*>(v + V_W + 16 * kk + 8 * (c / 2) + 2 * q);
          xa[4 * kk + c] = pack_bf16(xv.x * w.x, xv.y * w.y);
        }
      }
      const float el = v[V_EL], ec[2] = {v[V_EC + r], v[V_EC + r + 8]};
      mbar_arrive(&gempty[g]);

      wgmma_wait<0>();
      fence_regs(y);
      // decay the state to the sub-chunk's end, and y_off by exp(cum_i)
#pragma unroll
      for (int i = 0; i < 64; ++i) st[i] *= el;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          y[4 * j + 2 * hh] *= ec[hh];
          y[4 * j + 2 * hh + 1] *= ec[hh];
        }
      fence_regs(y);
      fence_regs(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const uint32_t a4[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_rs_n64<1>(y, a4, make_desc(xs + kk * 2048, ATOM, 1024), 1);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const uint32_t a4[4] = {xa[4 * kk], xa[4 * kk + 1], xa[4 * kk + 2], xa[4 * kk + 3]};
        wgmma_rs_n128<1>(st, a4, make_desc(bs + kk * 2048, ATOM, 1024), 1);
      }
      wgmma_commit();

      // y in bf16 over this head's x tile (read by nothing now) while the
      // update runs, then one TMA store; the state's bf16 copy for the next
      // y_off
      wgmma_wait<1>();
      fence_regs(y);
      store_bf16(xs, y);
      wgmma_wait<0>();
      fence_regs(st);
      store_bf16(sb, st);
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (t == 0) {
        tma_store_4d(&ymap, xs, 0, h, step * Q, b);
        bulk_commit();
      }
      __syncwarp();
      if (warp > 0 && lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(state_out + (bh * SP + r + 8 * hh) * SN + 8 * j + 2 * q) =
            make_float2(st[4 * j + 2 * hh], st[4 * j + 2 * hh + 1]);
    if (t == 0) bulk_wait<0>();
  }
}

int launch_wgmma(const void* x, const void* dt, const void* A, const void* B, const void* C,
                 const void* init, void* y, void* state, int nb, int S, int H, int b_sb,
                 int b_ss, int c_sb, int c_ss, cudaStream_t stream) {
  if (H % DT_HEADS != 0) return static_cast<int>(cudaErrorInvalidValue);
  static hopper::SmemRaised raised;
  CUtensorMap xmap, ymap, bmap, cmap, dtmap;
  const uint64_t xdims[4] = {SP, (uint64_t)H, (uint64_t)S, (uint64_t)nb};
  const uint64_t xstr[3] = {SP * 2, (uint64_t)H * SP * 2, (uint64_t)S * H * SP * 2};
  const uint32_t xbox[4] = {64, 1, Q, 1};
  const uint64_t bcdims[3] = {SN, (uint64_t)S, (uint64_t)nb};
  const uint64_t bstr[2] = {(uint64_t)b_ss * 2, (uint64_t)b_sb * 2};
  const uint64_t cstr[2] = {(uint64_t)c_ss * 2, (uint64_t)c_sb * 2};
  const uint32_t bcbox[3] = {64, Q, 1};
  const uint64_t dtdims[3] = {(uint64_t)H, (uint64_t)S, (uint64_t)nb};
  const uint64_t dtstr[2] = {(uint64_t)H * 4, (uint64_t)S * H * 4};
  const uint32_t dtbox[3] = {DT_HEADS, Q, 1};
  if (!hopper::make_map_bf16(&xmap, x, 4, xdims, xstr, xbox) ||
      !hopper::make_map_bf16(&ymap, y, 4, xdims, xstr, xbox) ||
      !hopper::make_map_bf16(&bmap, B, 3, bcdims, bstr, bcbox) ||
      !hopper::make_map_bf16(&cmap, C, 3, bcdims, cstr, bcbox) ||
      !hopper::make_map(&dtmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dt, 3, dtdims, dtstr, dtbox,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = hopper::allow_smem(ssd_wgmma_kernel, W_SMEM, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_wgmma_kernel<<<dim3(H / W_HEADS, nb), W_THREADS, W_SMEM, stream>>>(
      xmap, ymap, bmap, cmap, dtmap, static_cast<const float*>(A),
      static_cast<const float*>(init), static_cast<float*>(state), S, H);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------ (50, 16) bf16: mma.sync and TMA
constexpr int TC_P = 50, TC_N = 16;
constexpr int TC_HEADS = 4;                  // heads per block: 400-byte rows of x
constexpr int TC_PT = 7;                     // tiles of 8 columns over P (50 padded to 56)
constexpr int TC_THREADS = 4 * TC_HEADS * 32;  // 4 warps a head, 16 rows each
constexpr int TC_STAGES = 4;                 // the TMA ring
constexpr int TC_ROW = TC_HEADS * TC_P;      // a sequence row of the block's x: 200 bf16
constexpr int TC_DT = Q * TC_ROW * 2;        // stage: x (then y), dt, B, C
constexpr int TC_B = TC_DT + Q * TC_HEADS * 4;
constexpr int TC_C = TC_B + Q * TC_N * 2;
constexpr int TC_STAGE = TC_C + Q * TC_N * 2;
constexpr int XP_LD = 56;                    // a head's x tile row: 112 bytes
constexpr int XP_TILE = Q * XP_LD;           // elements of a head's x tile
constexpr int SB_LD = 24;                    // a row p of the state's bf16 copy: 48 bytes
constexpr int SB_TILE = 8 * TC_PT * SB_LD;
// a head's vectors over the sub-chunk's rows, fp32: cum (log2 units), dt,
// w_j = dt_j exp(cum_last - cum_j), exp(cum_i), and exp(cum_last)
constexpr int TV_C = 0, TV_D = 64, TV_W = 128, TV_EC = 192, TV_EL = 256, TC_VEC = 260;
constexpr int TC_SMEM = 128 + TC_STAGES * TC_STAGE +
                        2 * TC_HEADS * (2 * XP_TILE + 2 * SB_TILE + 4 * TC_VEC) + TC_STAGES * 8;

static_assert(TC_STAGE % 128 == 0 && TC_DT % 128 == 0 && TC_B % 128 == 0 && TC_C % 128 == 0,
              "TMA's shared-memory boxes must stay 128-byte aligned");
static_assert(TC_SMEM <= 232448, "more shared memory than a block may have");


__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_tc_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap bmap, const __grid_constant__ CUtensorMap cmap,
              const __grid_constant__ CUtensorMap dtmap, const float* __restrict__ A,
              const float* __restrict__ init, float* __restrict__ state_out, int S, int H) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  __nv_bfloat16* xp = reinterpret_cast<__nv_bfloat16*>(stages + TC_STAGES * TC_STAGE);
  __nv_bfloat16* sbf = xp + 2 * TC_HEADS * XP_TILE;                      // [2][TC_HEADS]
  float* vec = reinterpret_cast<float*>(sbf + 2 * TC_HEADS * SB_TILE);   // [2][TC_HEADS]
  uint64_t* full = reinterpret_cast<uint64_t*>(vec + 2 * TC_HEADS * TC_VEC);

  const int h0 = blockIdx.x * TC_HEADS, b = blockIdx.y;
  const int nsteps = (S + Q - 1) / Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // warp = 4 w + hh: strip w (rows 16 w .. 16 w + 15) of head h0 + hh, so
  // that each of the SM's four schedulers (warp % 4) runs one head's strips
  const int hh = warp % TC_HEADS, w = warp / TC_HEADS;
  const int g = lane / 4, tq = lane % 4, mi = lane / 8, lr = lane % 8;
  const int r0 = 16 * w + g;                  // accumulator rows r0 and r0 + 8
  const int h = h0 + hh;
  const size_t bh = (size_t)b * H + h;

  auto load = [&](int step) {
    unsigned char* st = stages + (step % TC_STAGES) * TC_STAGE;
    uint64_t* bar = &full[step % TC_STAGES];
    mbar_arrive_expect_tx(bar, TC_STAGE);
    tma_load_3d(st, &xmap, bar, h0 * TC_P, step * Q, b);
    tma_load_3d(st + TC_DT, &dtmap, bar, h0, step * Q, b);
    tma_load_3d(st + TC_B, &bmap, bar, 0, step * Q, b);
    tma_load_3d(st + TC_C, &cmap, bar, 0, step * Q, b);
  };
  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    tma_prefetch_map(&xmap);
    tma_prefetch_map(&ymap);
    tma_prefetch_map(&bmap);
    tma_prefetch_map(&cmap);
    tma_prefetch_map(&dtmap);
    for (int step = 0; step < min(TC_STAGES, nsteps); ++step) load(step);
  }
  // columns 50 .. 55 of the x tiles stay 0
  uint32_t* xp32 = reinterpret_cast<uint32_t*>(xp);
  for (int e = tid; e < 2 * TC_HEADS * Q * 3; e += TC_THREADS)
    xp32[(e / 3) * (XP_LD / 2) + TC_P / 2 + e % 3] = 0u;

  // The state^T (n, p) of head h in fp32 accumulators: this warp's column
  // tiles w and w + 4 (< 7), rows n = g, g + 8, columns p = 8 pt + 2 tq + e
  float sacc[2][4];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pt = w + 4 * k, n = g + 8 * (e / 2), p = 8 * pt + 2 * tq + e % 2;
      sacc[k][e] = init && pt < TC_PT && p < TC_P ? init[(bh * TC_P + p) * TC_N + n] : 0.f;
    }
  // its bf16 copy, [p][n]: the B operand of y_off
  auto store_state = [&](__nv_bfloat16* sb) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (w + 4 * k >= TC_PT) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sb[(8 * (w + 4 * k) + 2 * tq + e % 2) * SB_LD + g + 8 * (e / 2)] =
            __float2bfloat16(sacc[k][e]);
    }
  };
  store_state(sbf + hh * SB_TILE);

  // A sub-chunk's x to each head's tile of 112-byte rows, which ldmatrix
  // can address: head hh's 50 columns start at byte 100 hh of the 400-byte
  // row TMA wrote, 4-byte aligned only.  Warp 4 w + hh copies head hh's
  // rows w, w + 4, .., lane l < 25 its word l of each
  auto relayout = [&](int step) {
    const unsigned char* st = stages + (step % TC_STAGES) * TC_STAGE;
    mbar_wait(&full[step % TC_STAGES], (step / TC_STAGES) & 1);
    if (lane < TC_P / 2) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(st) + hh * (TC_P / 2) + lane;
      uint32_t* dst = xp32 + ((step & 1) * TC_HEADS + hh) * (XP_TILE / 2) + lane;
      uint32_t u[Q / 4];
#pragma unroll
      for (int k = 0; k < Q / 4; ++k) u[k] = src[(w + 4 * k) * (TC_ROW / 2)];
#pragma unroll
      for (int k = 0; k < Q / 4; ++k) dst[(w + 4 * k) * (XP_LD / 2)] = u[k];
    }
  };
  // Strip 0 of each head (the least work) scans dt A of a sub-chunk, in
  // log2 units, into the head's vectors: lane l holds rows l (c0) and
  // l + 32 (c1)
  const float a2 = A[h] * LOG2E;
  auto scan = [&](int step) {
    const unsigned char* st = stages + (step % TC_STAGES) * TC_STAGE;
    const float* dts = reinterpret_cast<const float*>(st + TC_DT);
    const float d0 = dts[lane * TC_HEADS + hh], d1 = dts[(lane + 32) * TC_HEADS + hh];
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
    float* v = vec + ((step & 1) * TC_HEADS + hh) * TC_VEC;
    v[TV_C + lane] = c0;
    v[TV_C + lane + 32] = c1;
    v[TV_D + lane] = d0;
    v[TV_D + lane + 32] = d1;
    v[TV_W + lane] = d0 * ex2(cl - c0);
    v[TV_W + lane + 32] = d1 * ex2(cl - c1);
    v[TV_EC + lane] = ex2(c0);
    v[TV_EC + lane + 32] = ex2(c1);
    if (lane == 0) v[TV_EL] = ex2(cl);
  };
  __syncthreads();  // the barriers are initialised
  relayout(0);
  if (w == 0) scan(0);

  for (int step = 0; step < nsteps; ++step) {
    const int par = step & 1;
    unsigned char* st = stages + (step % TC_STAGES) * TC_STAGE;
    // The one block-wide barrier of a sub-chunk: its x tiles and vectors
    // are written, and every warp is done with the sub-chunk before (its y
    // over its stage's x, the x tiles, state copy and vectors of the other
    // parity)
    __syncthreads();
    if (tid == 0) {
      if (step >= 1) {  // y of the sub-chunk before, out of its stage
        tma_store_3d(&ymap, stages + ((step - 1) % TC_STAGES) * TC_STAGE, h0 * TC_P,
                     (step - 1) * Q, b);
        bulk_commit();
      }
      // the stage of two sub-chunks back, once its y store has read it,
      // takes the sub-chunk TC_STAGES - 2 ahead
      if (step >= 2 && step - 2 + TC_STAGES < nsteps) {
        bulk_wait_read<1>();
        load(step - 2 + TC_STAGES);
      }
    }
    __syncwarp();

    const __nv_bfloat16* Bt = reinterpret_cast<const __nv_bfloat16*>(st + TC_B);  // [j][n]
    const __nv_bfloat16* Ct = reinterpret_cast<const __nv_bfloat16*>(st + TC_C);  // [i][n]
    const __nv_bfloat16* xh = xp + (par * TC_HEADS + hh) * XP_TILE;              // [j][p]
    const float* v = vec + (par * TC_HEADS + hh) * TC_VEC;

    // C of the strip's rows: the A operand of C B^T and of C state^T
    uint32_t ca[4];
    ldmatrix_x4(ca, Ct + (16 * w + lr + 8 * (mi % 2)) * TC_N + 8 * (mi / 2));

    // y_off = C state^T from the state's bf16 copy, scaled by exp(cum_i)
    const __nv_bfloat16* sb = sbf + (par * TC_HEADS + hh) * SB_TILE;
    float y[TC_PT][4];
#pragma unroll
    for (int pt = 0; pt < TC_PT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[pt][e] = 0.f;
#pragma unroll
    for (int pt = 0; pt < TC_PT; pt += 2) {
      if (pt + 1 < TC_PT) {
        uint32_t bb[4];
        ldmatrix_x4(bb, sb + (8 * (pt + mi / 2) + lr) * SB_LD + 8 * (mi % 2));
        mma_m16n8k16(y[pt], ca, bb[0], bb[1]);
        mma_m16n8k16(y[pt + 1], ca, bb[2], bb[3]);
      } else {
        uint32_t bb[2];
        ldmatrix_x2(bb, sb + (8 * pt + lr) * SB_LD + 8 * (mi % 2));
        mma_m16n8k16(y[pt], ca, bb[0], bb[1]);
      }
    }
    const float ec0 = v[TV_EC + r0], ec1 = v[TV_EC + r0 + 8];
    const float ci0 = v[TV_C + r0], ci1 = v[TV_C + r0 + 8];
#pragma unroll
    for (int pt = 0; pt < TC_PT; ++pt) {
      y[pt][0] *= ec0;
      y[pt][1] *= ec0;
      y[pt][2] *= ec1;
      y[pt][3] *= ec1;
    }

    // y += (G o L o dt) x over the columns j <= i: per k-step of 16 columns,
    // G = C B^T (two 16 x 8 products, K = N = 16), then each element times
    // exp(cum_i - cum_j) dt_j (0 right of the diagonal) as a bf16 A fragment
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (kk > w) break;
      uint32_t bb[4];
      ldmatrix_x4(bb, Bt + (16 * kk + 8 * (mi / 2) + lr) * TC_N + 8 * (mi % 2));
      float g0[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_m16n8k16(g0, ca, bb[0], bb[1]);
      mma_m16n8k16(g1, ca, bb[2], bb[3]);
      const int j0 = 16 * kk + 2 * tq;
      const float2 cj0 = *reinterpret_cast<const float2*>(v + TV_C + j0);
      const float2 cj1 = *reinterpret_cast<const float2*>(v + TV_C + j0 + 8);
      const float2 dj0 = *reinterpret_cast<const float2*>(v + TV_D + j0);
      const float2 dj1 = *reinterpret_cast<const float2*>(v + TV_D + j0 + 8);
      auto m = [](float gv, int i, float ci, int j, float cj, float dj) {
        return j <= i ? gv * ex2(ci - cj) * dj : 0.f;
      };
      const uint32_t ma[4] = {
          pack_bf16(m(g0[0], r0, ci0, j0, cj0.x, dj0.x), m(g0[1], r0, ci0, j0 + 1, cj0.y, dj0.y)),
          pack_bf16(m(g0[2], r0 + 8, ci1, j0, cj0.x, dj0.x),
                    m(g0[3], r0 + 8, ci1, j0 + 1, cj0.y, dj0.y)),
          pack_bf16(m(g1[0], r0, ci0, j0 + 8, cj1.x, dj1.x),
                    m(g1[1], r0, ci0, j0 + 9, cj1.y, dj1.y)),
          pack_bf16(m(g1[2], r0 + 8, ci1, j0 + 8, cj1.x, dj1.x),
                    m(g1[3], r0 + 8, ci1, j0 + 9, cj1.y, dj1.y))};
      // x rows 16 kk .. 16 kk + 15 as B fragments (ldmatrix, transposed)
      const __nv_bfloat16* xr = xh + (16 * kk + lr + 8 * (mi % 2)) * XP_LD;
#pragma unroll
      for (int pt = 0; pt < TC_PT; pt += 2) {
        if (pt + 1 < TC_PT) {
          uint32_t xb[4];
          ldmatrix_x4_trans(xb, xr + 8 * (pt + mi / 2));
          mma_m16n8k16(y[pt], ma, xb[0], xb[1]);
          mma_m16n8k16(y[pt + 1], ma, xb[2], xb[3]);
        } else {
          uint32_t xb[2];
          ldmatrix_x2_trans(xb, xr + 8 * pt);
          mma_m16n8k16(y[pt], ma, xb[0], xb[1]);
        }
      }
    }

    // y in bf16 over the stage's x, which the re-layout has read: head hh's
    // columns of rows r0 and r0 + 8, a bf16 pair a word
    uint32_t* y32 = reinterpret_cast<uint32_t*>(st);
#pragma unroll
    for (int pt = 0; pt < TC_PT; ++pt)
      if (8 * pt + 2 * tq < TC_P) {
        const int col = hh * (TC_P / 2) + 4 * pt + tq;
        y32[r0 * (TC_ROW / 2) + col] = pack_bf16(y[pt][0], y[pt][1]);
        y32[(r0 + 8) * (TC_ROW / 2) + col] = pack_bf16(y[pt][2], y[pt][3]);
      }
    fence_proxy_async();  // the next sub-chunk's TMA store reads it

    // state^T = exp(cum_last) state^T + (B o w)^T x, K = the 64 rows j: the
    // A fragments of (B o w)^T from B by ldmatrix (transposed), scaled by w
    // and rounded to bf16; x's B fragments as for y
    const float el = v[TV_EL];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[k][e] *= el;
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      uint32_t ba[4];
      ldmatrix_x4_trans(ba, Bt + (16 * kk + lr + 8 * (mi / 2)) * TC_N + 8 * (mi % 2));
      const int j0 = 16 * kk + 2 * tq;
      const float2 w0 = *reinterpret_cast<const float2*>(v + TV_W + j0);
      const float2 w1 = *reinterpret_cast<const float2*>(v + TV_W + j0 + 8);
      const uint32_t wa[4] = {scale_bf16x2(ba[0], w0), scale_bf16x2(ba[1], w0),
                              scale_bf16x2(ba[2], w1), scale_bf16x2(ba[3], w1)};
      const __nv_bfloat16* xr = xh + (16 * kk + lr + 8 * (mi % 2)) * XP_LD;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (w + 4 * k < TC_PT) {
          uint32_t xb[2];
          ldmatrix_x2_trans(xb, xr + 8 * (w + 4 * k));
          mma_m16n8k16(sacc[k], wa, xb[0], xb[1]);
        }
    }
    // the bf16 copy of the other parity, for the next sub-chunk's y_off
    store_state(sbf + ((par ^ 1) * TC_HEADS + hh) * SB_TILE);
    // the next sub-chunk's x tiles and vectors, each warp once done here
    if (step + 1 < nsteps) {
      relayout(step + 1);
      if (w == 0) scan(step + 1);
    }
  }

  __syncthreads();
  if (tid == 0) {
    tma_store_3d(&ymap, stages + ((nsteps - 1) % TC_STAGES) * TC_STAGE, h0 * TC_P,
                 (nsteps - 1) * Q, b);
    bulk_commit();
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pt = w + 4 * k, n = g + 8 * (e / 2), p = 8 * pt + 2 * tq + e % 2;
      if (pt < TC_PT && p < TC_P) state_out[(bh * TC_P + p) * TC_N + n] = sacc[k][e];
    }
  if (tid == 0) bulk_wait<0>();
}

int launch_tc(const void* x, const void* dt, const void* A, const void* B, const void* C,
              const void* init, void* y, void* state, int nb, int S, int H, int b_sb, int b_ss,
              int c_sb, int c_ss, cudaStream_t stream) {
  if (H % TC_HEADS != 0) return static_cast<int>(cudaErrorInvalidValue);
  static hopper::SmemRaised raised;
  CUtensorMap xmap, ymap, bmap, cmap, dtmap;
  // x and y as (b S) rows of H P elements: a block's box is 4 heads of a row
  const uint64_t xdims[3] = {(uint64_t)H * TC_P, (uint64_t)S, (uint64_t)nb};
  const uint64_t xstr[2] = {(uint64_t)H * TC_P * 2, (uint64_t)S * H * TC_P * 2};
  const uint32_t xbox[3] = {TC_ROW, Q, 1};
  const uint64_t bcdims[3] = {TC_N, (uint64_t)S, (uint64_t)nb};
  const uint64_t bstr[2] = {(uint64_t)b_ss * 2, (uint64_t)b_sb * 2};
  const uint64_t cstr[2] = {(uint64_t)c_ss * 2, (uint64_t)c_sb * 2};
  const uint32_t bcbox[3] = {TC_N, Q, 1};
  const uint64_t dtdims[3] = {(uint64_t)H, (uint64_t)S, (uint64_t)nb};
  const uint64_t dtstr[2] = {(uint64_t)H * 4, (uint64_t)S * H * 4};
  const uint32_t dtbox[3] = {TC_HEADS, Q, 1};
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle NONE = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!hopper::make_map(&xmap, BF16, x, 3, xdims, xstr, xbox, NONE) ||
      !hopper::make_map(&ymap, BF16, y, 3, xdims, xstr, xbox, NONE) ||
      !hopper::make_map(&bmap, BF16, B, 3, bcdims, bstr, bcbox, NONE) ||
      !hopper::make_map(&cmap, BF16, C, 3, bcdims, cstr, bcbox, NONE) ||
      !hopper::make_map(&dtmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dt, 3, dtdims, dtstr, dtbox,
                        NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = hopper::allow_smem(ssd_tc_kernel, TC_SMEM, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_tc_kernel<<<dim3(H / TC_HEADS, nb), TC_THREADS, TC_SMEM, stream>>>(
      xmap, ymap, bmap, cmap, dtmap, static_cast<const float*>(A),
      static_cast<const float*>(init), static_cast<float*>(state), S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, B, C and y).  In fp32 the CUDA-core kernels
// take (P, N) = (50, 16) (ssd_simt_kernel) and (64, 128) (ssd_kernel); in
// bf16 the tensor-core kernels, ssd_tc_kernel at (50, 16) and the wgmma
// kernel at (64, 128), which take H % 4 == 0 and 16-byte aligned pointers
// and B and C strides.  init may be null (zero state).
// Returns the cudaError_t of the launch, or cudaErrorInvalidValue for what
// the kernels do not take.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
                        const void* C, const void* init, void* y, void* state, int nb,
                        int S, int H, int P, int N, int b_sb, int b_ss, int c_sb,
                        int c_ss, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 50 && N == 16 && dtype == 0)
    return launch_simt<float, 50, 16>(x, dt, A, B, C, init, y, state, nb, S, H, b_sb, b_ss,
                                      c_sb, c_ss, s);
  if (P == 50 && N == 16 && dtype == 1)
    return launch_tc(x, dt, A, B, C, init, y, state, nb, S, H, b_sb, b_ss, c_sb, c_ss, s);
  if (P != SP || N != SN) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch(x, dt, A, B, C, init, y, state, nb, S, H, b_sb, b_ss, c_sb, c_ss, s);
  if (dtype == 1) return launch_wgmma(x, dt, A, B, C, init, y, state, nb, S, H, b_sb, b_ss, c_sb, c_ss, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
