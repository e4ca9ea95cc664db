// ssd_scan: the Mamba-2 SSD chunk scan with one B/C group shared by the H
// heads, from an optional initial state, returning y and the final state.
//
// Replaces the TPU kernel kernels/ssd_scan.py:ssd_scan (_ssd_kernel) of the
// JAX package, with the init_state / return_state options of
// models/ssd.py:ssd_scan_ref, which the prefill needs to seed decoding.
//
// Layout: x and y (b, S, H, P) in T, dt (b, S, H) fp32 and A (H,) fp32, all
// contiguous; B and C (b, S, N) in T with the given batch and sequence
// strides and a contiguous last dim (the two halves of the conv output, read
// in place); init_state (or null for zeros) and the final state (b, H, P, N)
// fp32.  P = 64 and N = 128 only.
//
// What bounds it on an H100: at b 8, S 512, H 64 a call moves ~87 MB (x, y
// and the state dominate) and needs ~17 GFLOP if C.B^T is formed once per
// (batch row, chunk) and the rest runs on the tensor cores, so the least
// time (~26 us) is set by bytes.
//
// What the design does about it, so far: one block per (head, batch row)
// walks the sequence in order, in sub-chunks of Q = 64 rows, and keeps the
// P x N fp32 state in shared memory from the first sub-chunk to the last, so
// the state goes to device memory once, and x, B, C and dt are each read
// once per block (B and C once per head: the heads share them).  A ragged
// last sub-chunk reads dt = 0 and x.dt = 0 for its missing rows, which
// neither decay nor feed the state.  Within a sub-chunk: a warp scan of
// dt * A; G = (C B^T) o L with L[i,j] = exp(cum_i - cum_j) for j <= i;
// y = G (x dt) + exp(cum) (C state^T); then state = exp(cum_last) state +
// sum_j exp(cum_last - cum_j) (x dt)_j B_j^T.  All products are fp32 FMA on
// the CUDA cores from register tiles of 4x4 (8x4 for the state) fed by
// 16-byte shared-memory loads, so the kernel is bound by those, far from the
// byte bound; C B^T is recomputed by every head.  Tensor cores (wgmma), a
// C B^T shared across heads and a chunk-parallel state pass are later work.
//
// Shared memory (fp32, rows padded by 4 floats so that 16-byte loads of
// neighbouring rows fall in distinct banks): C and B 2 x 64 x 132, x.dt
// 64 x 68, G 64 x 68, state^T 128 x 68, and four 64-vectors: 138,240 bytes
// of the 227 KB a block may have, so one block per SM.  A 256-row sub-chunk
// would not fit: its G tile alone is 256 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ init,
           T* __restrict__ y, float* __restrict__ state_out, int S, int H,
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
      if (i < rows) v = to_float(x[(((size_t)b * S + c0 + i) * H + h) * SP + p]) * dts[i];
      X_s[i * PPAD + p] = v;
    }
    for (int e = tid; e < Q * SN; e += THREADS) {
      const int i = e / SN, n = e % SN;
      float bv = 0.f, cv = 0.f;
      if (i < rows) {
        bv = to_float(Bm[(size_t)b * b_sb + (size_t)(c0 + i) * b_ss + n]);
        cv = to_float(Cm[(size_t)b * c_sb + (size_t)(c0 + i) * c_ss + n]);
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
          T* dst = y + (((size_t)b * S + c0 + gi) * H + h) * SP + 4 * c;
#pragma unroll
          for (int k = 0; k < 4; ++k) dst[k] = from_float<T>(fmaf(e, yo[i][k], yd[i][k]));
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

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* init, void* y, void* state, int nb, int S,
           int H, int b_sb, int b_ss, int c_sb, int c_ss, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<T><<<dim3(H, nb), THREADS, SMEM_BYTES, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(state), S, H, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, B, C and y); init may be null (zero state).
// Returns the cudaError_t of the launch.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
                        const void* C, const void* init, void* y, void* state, int nb,
                        int S, int H, int P, int N, int b_sb, int b_ss, int c_sb,
                        int c_ss, int dtype, void* stream) {
  if (P != SP || N != SN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A, B, C, init, y, state, nb, S, H, b_sb, b_ss, c_sb, c_ss, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dt, A, B, C, init, y, state, nb, S, H, b_sb, b_ss, c_sb, c_ss, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
