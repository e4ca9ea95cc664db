// ssd_scan_bwd_tc: the backward of the Mamba-2 SSD chunk scan of ssd_scan.cu
// in bf16 at hymba_1_5b's heads (P 50, N 16), chunk-parallel on mma.sync:
// the "tc" route of kernels/ssd_scan.py:ssd_bwd_route.  Given dy and the
// final state's cotangent it returns dx, ddt, dA, dB, dC and d init_state,
// as ssd_scan_bwd.cu's kernels and ssd_scan_bwd_plain compute them.
//
// The TPU kernel it serves is kernels/ssd_scan.py:ssd_scan (_ssd_kernel) of
// the JAX package, which has no backward kernel: the JAX package trains
// through models/ssd.py:ssd_scan_ref and XLA's autodiff.
//
// Layout: x, dy and dx (b, S, H, 50) bf16, dt and ddt (b, S, H) fp32, A and
// dA (H,) fp32, B and C (b, S, 16) bf16 with the given batch and sequence
// strides (multiples of 8 elements) and a contiguous last dim, dB and dC
// (b, S, 16) bf16 contiguous; init, dstate and dinit (b, H, 50, 16) fp32 or
// null.  H a multiple of 4 and every pointer 16-byte aligned.
//
// The math (ssd_scan_bwd.cu's header): per sub-chunk k of Q = 64 rows, with
// its start state s0_k, cum the inclusive cumsum of dt A over its rows,
// L[i,j] = exp(cum_i - cum_j) for j <= i, w_i = exp(cum_last - cum_i) and
// G_k the adjoint of its end state,
//   dxdt = (L o C B^T)^T dy + w (B G_k^T),  dx = dt dxdt
//   dB_h = (L o dy xdt^T)^T C + w xdt G_k,  dC_h = (L o dy xdt^T) B + exp(cum) dy s0_k
//   dcum = rowsum(M) - colsum(M) + exp(cum) C.(dy s0_k) - w xdt.(B G_k^T)
//          (+ <G_k, s0_{k+1}> at the last row),  M = L o (C B^T) o (dy xdt^T)
//   da = the reverse cumsum of dcum within the sub-chunk, ddt = x.dxdt + A da,
//   dA = the sum over b and S of dt da.
// cum restarts at every sub-chunk, so nothing of dcum crosses a sub-chunk:
// what a later sub-chunk owes an earlier dt reaches it through G and the
// <G_k, s0_{k+1}> term.  The only serial dependences are the states and
// the adjoints, 800 floats per (batch row, head):
//   s0_{k+1} = exp(cum_last,k) s0_k + dS_k,  dS_k = (x o dt w)^T B,
//   G_{k-1} = exp(cum_last,k) G_k + dG_k,    dG_k = (exp(cum) o dy)^T C,
// from init_state (or 0) and dstate (or 0); G_{-1} is d init_state.
//
// What bounded the CUDA-core kernel it replaces (ssd_bwd_kernel<bf16, 50,
// 16>, 1.3140 ms at b 2, S 2048, H 64 on one H100 80GB HBM3 at 700 W, 54x
// its byte bound): one block per (head, batch row) walked all the
// sub-chunks twice in sequence, ~20 us a sub-chunk on the CUDA cores, and
// halving the heads changed nothing: the chain was the bound.  This route
// breaks the chain into four launches, no atomics (two calls give the same
// bits), every sum in a fixed order:
//
// 1. ssd_bwd_tc_local_kernel, one block per (4 heads, sub-chunk, batch row)
//    (1024 blocks at b 2, S 2048, H 64, against 128), 16 warps, warp 4 w +
//    hh on head hh: dS_k^T = (B o dt w)^T x and dG_k^T = (C o exp(cum))^T dy
//    (16 x 56, K = the 64 rows, warp w taking column tiles w and w + 4 of
//    the 7 over P padded to 56) on mma.sync m16n8k16, and the sub-chunk's
//    decay exp(cum_last).  dS_k goes to slot k + 1 of the states scratch
//    (b, H, nsub + 1, P, N), dG_k to slot k of the adjoints (b, H, nsub, P,
//    N), both fp32.
// 2. ssd_bwd_tc_serial_kernel, one thread per 4 elements of a state: the
//    states forward and, on as many other threads, the adjoints backward,
//    in place (slot k of the states becomes s0_k, the last the final state;
//    slot k of the adjoints G_k), each step an fma in fp32, the loads of 16
//    steps issued before their fmas so that a chain waits on memory once
//    per 16 sub-chunks.
// 3. ssd_bwd_tc_grad_kernel, the same grid: every gradient of the
//    sub-chunk from s0_k, G_k and s0_{k+1}.  Warp 4 w + hh owns rows 16 w ..
//    16 w + 15 (i) of head hh and computes both triangles from its own rows:
//    left of the diagonal (j <= i, w + 1 column blocks) C B^T and dy x^T,
//    M's row sums and dC's L o dy (x dt)^T B; right of it (j >= i, 4 - w
//    blocks) B_i C_j^T and x_i dy_j^T, the transposed scores whose row sums
//    are M's column sums, so that no warp needs another's scores; then dB's
//    (L o dy xdt^T)^T C and dxdt's (L o C B^T)^T dy, each score block
//    turned into an A fragment in registers (exp2 of a cum difference an
//    element, from cum in log2 units).  Each warp does five score blocks,
//    whatever its strip.  B G^T, dy s0 and (x dt w) G on mma.sync too
//    (K = P as three k16 steps and one m16n8k8).  dB and dC of the 4 heads
//    are summed in the block, in order, into partials (b, H / 4, S, N) fp32
//    (head 0's to 4 KB of shared memory, each next head adding its own, a
//    barrier of the strip's 4 warps between); dcum's reverse cumsum is a
//    warp scan per head, which stores ddt and the sub-chunk's dt da.
// 4. ssd_bwd_reduce_kernel (ssd_scan_bwd_reduce.cuh, every route's last
//    launch): dB and dC over the H / 4 groups and dA over the batch rows and
//    sub-chunks, in order, one thread an output element.
//
// x and dy come to shared memory by cp.async, a 32-bit word of the block's
// 400-byte row slices at a time (a warp reads 128 contiguous bytes), each
// word straight to its head's tile of 112-byte rows (P padded to 56 with
// zeros): head h's 50 columns start at byte 100 h, which ldmatrix cannot
// address, and at 112 bytes the eight rows of an ldmatrix fall in distinct
// banks.  B and C come by cp.async of 16 bytes.  No TMA stage: a stage would
// hold a second copy of x and dy (51 KB) beside the tiles, and a block
// would no longer leave room for a second on its SM.  The grad kernel's
// loads of dt, s0_k, s0_{k+1} and G_k are in flight with the copies, one
// wait for all; it then puts s0_k in bf16 and G_k in bf16 hi + lo to tiles
// [p][n] of 48-byte rows.
//
// Rounding: only products' operands are bf16.  B o dt w (in dS) and G in
// B G^T are bf16 pairs hi + lo, two products each: with one bf16 each dA
// missed 1e-2 of its largest value at S 65 and 97 (a CPU model of these
// roundings, tests/test_torch_ssd_bwd.py:_tc_bwd_model).  One bf16 each:
// L o C B^T, L o dy (x dt)^T, C o exp(cum), x o dt o w and G in dB, s0.
// The states, adjoints, every dcum term, M's sums and the reverse cumsum are
// fp32.
//
// What bounds it: at b 2, S 2048, H 64 the function reads and writes ~81 MB
// (x, dy and dx 26 MB each): 0.0243 ms at 3.35 TB/s; its products are ~4.4
// GFLOP (chip_smoke.py's count), 0.0044 ms at the dense bf16 peak.  The
// design moves more: x and dy are read twice (phases 1 and 3), the blocks
// of a sub-chunk read its B and C once each (4 MB), and the scratch goes
// out and back: dS and dG 13.1 MB each out of phase 1, read and rewritten
// by phase 2, s0 (twice: as s0_k and as s0_{k+1}) and G read by phase 3,
// the dB / dC partials 8.4 MB out and in: ~280 MB in all, 0.083 ms at 3.35
// TB/s, the design's floor (the 50 MB L2 keeps some of the scratch between
// launches).
// Registers and shared memory (ptxas): the local kernel 62 registers, 69,760
// bytes, two blocks an SM; the serial kernel 109 registers; the grad kernel
// 64 registers (two blocks an SM) with 84 bytes of spill stores, 110,208
// bytes; no other spill.
// Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py's kernels phase):
// 0.1827 ms at b 2, S 2048, H 64 (7.5x the byte bound; the CUDA-core kernel
// took 1.3140), 0.1635 at S 1800 from an initial state, 0.1865 at b 1, S
// 4096, 0.0995 at H 32.  Each launch's share (launch/ssd_bwd_probe.py time
// --heads hymba): the grad kernel more than half, the local kernel a
// quarter.  The grad kernel is not bound by its bytes: variants at one
// block an SM (122 registers, no spill) or compiled once per strip were no
// faster, and one that skips its global loads kept most of its time; its
// HMMA are a small share of its SASS, address arithmetic and the scores'
// elementwise work most of it, and they bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"
#include "ssd_scan_bwd_reduce.cuh"

namespace {

constexpr int Q = 64;                       // rows per sub-chunk
constexpr int HP = 50, HN = 16;             // P, N
constexpr int PN = HP * HN;                 // a state's elements
constexpr int HEADS = 4;                    // heads per block
constexpr int THREADS = 4 * HEADS * 32;     // 4 warps a head, 16 rows each
constexpr int PT = 7;                       // column tiles of 8 over P padded to 56
constexpr int XLD = 56;                     // a head's x / dy tile row: 112 bytes
constexpr int XTILE = Q * XLD;              // elements of a head's x or dy tile
constexpr int BLD = 24;                     // a B / C tile row: 48 bytes
constexpr int SLD = 24;                     // a state tile row [p][n]: 48 bytes
constexpr int STILE = 56 * SLD;             // rows p padded to 56
constexpr int ROW_WORDS = HEADS * HP / 2;   // the block's slice of an x row: 100 words
constexpr int SERIAL_THREADS = 256;
constexpr int SERIAL_AHEAD = 16;            // sub-chunks whose loads are issued together

// a head's vectors over the sub-chunk's rows, fp32: cum (log2 units), dt,
// exp(cum), w = exp(cum_last - cum), dcum, x.dxdt; the 4 warps' parts of
// <G_k, s0_{k+1}>; exp(cum_last)
constexpr int V_C = 0, V_D = 64, V_EC = 128, V_W = 192, V_DC = 256, V_XDX = 320, V_GS = 384,
              V_EL = 388, VEC = 392;

// shared memory in bytes: the tiles both kernels load, then the grad
// kernel's state tiles and its per-head dB and dC
constexpr int SM_X = 0;                             // bf16 [HEADS][Q][XLD]
constexpr int SM_DY = SM_X + HEADS * XTILE * 2;     // bf16 [HEADS][Q][XLD]
constexpr int SM_B = SM_DY + HEADS * XTILE * 2;     // bf16 [Q][BLD]
constexpr int SM_C = SM_B + Q * BLD * 2;            // bf16 [Q][BLD]
constexpr int SM_V = SM_C + Q * BLD * 2;            // fp32 [HEADS][VEC]
constexpr int SM_LOCAL = SM_V + HEADS * VEC * 4;
constexpr int SM_S0 = SM_LOCAL;                     // bf16 [HEADS][56][SLD]: s0_k
constexpr int SM_GH = SM_S0 + HEADS * STILE * 2;    // G_k in bf16
constexpr int SM_GL = SM_GH + HEADS * STILE * 2;    // the bf16 of what that leaves
constexpr int SM_XB = SM_GL + HEADS * STILE * 2;    // fp32 [Q][HN]: dB's running sum over heads
constexpr int SM_XC = SM_XB + Q * HN * 4;           // fp32 [Q][HN]: dC's
constexpr int SM_GRAD = SM_XC + Q * HN * 4;

static_assert(SM_B % 16 == 0 && SM_C % 16 == 0 && SM_V % 16 == 0 && SM_S0 % 16 == 0 &&
                  SM_GH % 16 == 0 && SM_GL % 16 == 0 && SM_XB % 16 == 0 && SM_XC % 16 == 0,
              "16-byte rows for ldmatrix and the vector stores");
static_assert(2 * (SM_GRAD + 1024) <= 233472, "two blocks of the grad kernel per SM");

__device__ __forceinline__ float2 bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// bf16 pair u times (f.x, f.y) as a bf16 pair hi and the bf16 pair of what
// rounding to hi leaves (hopper::pack_bf16_rest)
__device__ __forceinline__ void scale_split(uint32_t u, float2 f, uint32_t& hi, uint32_t& lo) {
  const float2 v = bf2(u);
  hi = hopper::pack_bf16(v.x * f.x, v.y * f.y);
  lo = hopper::pack_bf16_rest(v.x * f.x, v.y * f.y);
}

// D(16 x 8, fp32) += A(16 x 8, bf16) * B(8 x 8, bf16): mma_m16n8k16's
// layouts cut at k 8, a[h] = A[g + 8 h][2 q + {0, 1}], b = B[2 q + {0, 1}][g]
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&d)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) d[r][c] = 0.f;
}

// A fragments of rows i0 .. i0 + 15 of a row-major tile of XLD columns,
// K = P padded to 56: k-step kp < 3 of 16 columns, or (kp 3) the last 8
__device__ __forceinline__ void frag_p(uint32_t (&a)[4], const __nv_bfloat16* tile, int i0, int kp,
                                       int lane) {
  const int mi = lane / 8, lr = lane % 8;
  hopper::ldmatrix_x4(a, tile + (i0 + lr + 8 * (mi % 2)) * XLD + 16 * kp + 8 * (mi / 2));
}
__device__ __forceinline__ void frag_p8(uint32_t (&a)[2], const __nv_bfloat16* tile, int i0,
                                        int lane) {
  const int mi = lane / 8, lr = lane % 8;
  hopper::ldmatrix_x2(a, tile + (i0 + lr + 8 * (mi % 2)) * XLD + 48);
}

// d[2] (+)= (rows i0 .. i0 + 15 of tile ta) (rows j0 .. j0 + 15 of tile
// tb)^T, both row-major over K = P: the two 16 x 8 blocks of a 16 x 16
// score block.  The A fragments are read from shared memory each time:
// held in registers for a warp's 5 score blocks they would keep the
// kernel from two blocks an SM.
__device__ __forceinline__ void scores_p(float (&d)[2][4], const __nv_bfloat16* ta, int i0,
                                         const __nv_bfloat16* tb, int j0, int lane) {
  const int mi = lane / 8, lr = lane % 8;
  const __nv_bfloat16* rows = tb + (j0 + lr + 8 * (mi / 2)) * XLD + 8 * (mi % 2);
#pragma unroll
  for (int kp = 0; kp < 3; ++kp) {
    uint32_t a[4], bb[4];
    frag_p(a, ta, i0, kp, lane);
    hopper::ldmatrix_x4(bb, rows + 16 * kp);
    hopper::mma_m16n8k16(d[0], a, bb[0], bb[1]);
    hopper::mma_m16n8k16(d[1], a, bb[2], bb[3]);
  }
  uint32_t a[2], bb[2];
  frag_p8(a, ta, i0, lane);
  hopper::ldmatrix_x2(bb, tb + (j0 + lr + 8 * (mi % 2)) * XLD + 48);
  mma_m16n8k8(d[0], a[0], a[1], bb[0]);
  mma_m16n8k8(d[1], a[0], a[1], bb[1]);
}

// d[2] (+)= a * (rows j0 .. j0 + 15 of a [j][n] tile of 16 columns)^T, K = N
__device__ __forceinline__ void scores_n(float (&d)[2][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int j0, int lane) {
  const int mi = lane / 8, lr = lane % 8;
  uint32_t bb[4];
  hopper::ldmatrix_x4(bb, tile + (j0 + lr + 8 * (mi / 2)) * BLD + 8 * (mi % 2));
  hopper::mma_m16n8k16(d[0], a, bb[0], bb[1]);
  hopper::mma_m16n8k16(d[1], a, bb[2], bb[3]);
}

// d[2] += a (16 x 16 over rows j0 .. j0 + 15) * (those rows of a [j][n] tile
// of 16 columns): K = the rows
__device__ __forceinline__ void times_rows_n(float (&d)[2][4], const uint32_t (&a)[4],
                                             const __nv_bfloat16* tile, int j0, int lane) {
  const int mi = lane / 8, lr = lane % 8;
  uint32_t bb[4];
  hopper::ldmatrix_x4_trans(bb, tile + (j0 + lr + 8 * (mi % 2)) * BLD + 8 * (mi / 2));
  hopper::mma_m16n8k16(d[0], a, bb[0], bb[1]);
  hopper::mma_m16n8k16(d[1], a, bb[2], bb[3]);
}

// d[2] (+)= (rows i0 .. i0 + 15 of tile ta, each row r times scale[r] when
// given, rounded to bf16) (a [p][n] state tile): K = P as three k16 steps
// and one k8
__device__ __forceinline__ void times_state(float (&d)[2][4], const __nv_bfloat16* ta, int i0,
                                            const __nv_bfloat16* st, int lane,
                                            const float* scale = nullptr) {
  const int mi = lane / 8, lr = lane % 8;
#pragma unroll
  for (int kp = 0; kp < 3; ++kp) {
    uint32_t a[4], bb[4];
    frag_p(a, ta, i0, kp, lane);
    if (scale)  // a[r]: row i0 + lane / 4 + 8 (r % 2)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = hopper::scale_bf16x2(a[r], make_float2(scale[r % 2], scale[r % 2]));
    hopper::ldmatrix_x4_trans(bb, st + (16 * kp + lr + 8 * (mi % 2)) * SLD + 8 * (mi / 2));
    hopper::mma_m16n8k16(d[0], a, bb[0], bb[1]);
    hopper::mma_m16n8k16(d[1], a, bb[2], bb[3]);
  }
  uint32_t a[2], bb[2];
  frag_p8(a, ta, i0, lane);
  if (scale)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      a[r] = hopper::scale_bf16x2(a[r], make_float2(scale[r], scale[r]));
  hopper::ldmatrix_x2_trans(bb, st + (48 + lr) * SLD + 8 * (mi % 2));
  mma_m16n8k8(d[0], a[0], a[1], bb[0]);
  mma_m16n8k8(d[1], a[0], a[1], bb[1]);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issues the loads of rows c0 .. c0 + 63 of the block's 4 heads (zeros past
// S), asynchronous (cp.async) straight to their tiles: x and dy a 32-bit
// word at a time to each head's tile of 112-byte rows (columns 50 .. 55
// zero; a warp reads 128 contiguous bytes), B and C 16 bytes at a time.
// Warp hh < HEADS also loads head h0 + hh's dt of rows lane and lane + 32,
// returned, for scan_dt.  Nothing waits here, so the caller's own loads
// overlap these.
__device__ __forceinline__ float2 issue_subchunk(
    unsigned char* sm, const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
    const float* __restrict__ dt, int b, int c0, int rows, int S, int H, int h0, int b_sb,
    int b_ss, int c_sb, int c_ss) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float2 d = make_float2(0.f, 0.f);
  if (warp < HEADS) {
    const float* col = dt + ((size_t)b * S + c0) * H + h0 + warp;
    if (lane < rows) d.x = __ldg(col + (size_t)lane * H);
    if (lane + 32 < rows) d.y = __ldg(col + (size_t)(lane + 32) * H);
  }
  uint32_t* xt = reinterpret_cast<uint32_t*>(sm + SM_X);
  uint32_t* dyt = reinterpret_cast<uint32_t*>(sm + SM_DY);
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
  const uint32_t* dyw = reinterpret_cast<const uint32_t*>(dy);
#pragma unroll 4
  for (int e = tid; e < Q * ROW_WORDS; e += THREADS) {
    const int row = e / ROW_WORDS, word = e % ROW_WORDS, hd = word / (HP / 2);
    const int at = (hd * Q + row) * (XLD / 2) + word % (HP / 2);
    if (row < rows) {
      const size_t src = ((size_t)(b * S + c0 + row) * H + h0) * (HP / 2) + word;
      cp_async4(xt + at, xw + src);
      cp_async4(dyt + at, dyw + src);
    } else {
      xt[at] = 0u;
      dyt[at] = 0u;
    }
  }
  if (tid < 4 * Q) {  // B and C: two 16-byte halves a row
    const bool is_c = tid >= 2 * Q;
    const int e = tid % (2 * Q), row = e / 2, half = e % 2;
    unsigned char* dst = sm + (is_c ? SM_C : SM_B) + row * BLD * 2 + 16 * half;
    if (row < rows) {
      const __nv_bfloat16* src = is_c ? Cm + (size_t)b * c_sb + (size_t)(c0 + row) * c_ss
                                      : Bm + (size_t)b * b_sb + (size_t)(c0 + row) * b_ss;
      cp_async16(dst, reinterpret_cast<const uint4*>(src) + half);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  for (int e = tid; e < 2 * HEADS * Q * 3; e += THREADS) {  // columns 50 .. 55
    uint32_t* t = e < HEADS * Q * 3 ? xt : dyt;
    const int f = e % (HEADS * Q * 3);
    t[(f / 3) * (XLD / 2) + HP / 2 + f % 3] = 0u;
  }
  return d;
}

// Waits for this thread's copies; warp hh < HEADS scans dt A of head h0 +
// hh (log2 units) into the head's vectors, lane l holding rows l and l +
// 32.  The caller's __syncthreads makes the tiles and vectors visible.
__device__ __forceinline__ void scan_dt(unsigned char* sm, const float* __restrict__ A, int h0,
                                        float2 d) {
  cp_async_wait_all();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= HEADS) return;
  const float a2 = A[h0 + warp] * LOG2E;
  float s0 = d.x * a2, s1 = d.y * a2;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, s0, off);
    const float u1 = __shfl_up_sync(0xffffffffu, s1, off);
    if (lane >= off) {
      s0 += u0;
      s1 += u1;
    }
  }
  s1 += __shfl_sync(0xffffffffu, s0, 31);
  const float cl = __shfl_sync(0xffffffffu, s1, 31);
  float* v = reinterpret_cast<float*>(sm + SM_V) + warp * VEC;
  v[V_C + lane] = s0;
  v[V_C + lane + 32] = s1;
  v[V_D + lane] = d.x;
  v[V_D + lane + 32] = d.y;
  v[V_EC + lane] = ex2(s0);
  v[V_EC + lane + 32] = ex2(s1);
  v[V_W + lane] = ex2(cl - s0);
  v[V_W + lane + 32] = ex2(cl - s1);
  if (lane == 0) v[V_EL] = ex2(cl);
}

// ---- 1. the local increments dS_k, dG_k and the decay of each sub-chunk
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_tc_local_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                        const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                        float* __restrict__ states, float* __restrict__ adj,
                        float* __restrict__ decay, int S, int H, int b_sb, int b_ss, int c_sb,
                        int c_ss) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int h0 = blockIdx.x * HEADS, k = blockIdx.y, b = blockIdx.z, nsub = gridDim.y;
  const int c0 = k * Q, rows = min(Q, S - c0);
  scan_dt(sm, A, h0,
          issue_subchunk(sm, x, dy, Bm, Cm, dt, b, c0, rows, S, H, h0, b_sb, b_ss, c_sb, c_ss));
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hh = warp % HEADS, w = warp / HEADS;
  const int g = lane / 4, tq = lane % 4, mi = lane / 8, lr = lane % 8;
  const size_t bh = (size_t)b * H + h0 + hh;
  const float* v = reinterpret_cast<const float*>(sm + SM_V) + hh * VEC;
  const __nv_bfloat16* bt = reinterpret_cast<const __nv_bfloat16*>(sm + SM_B);
  const __nv_bfloat16* ct = reinterpret_cast<const __nv_bfloat16*>(sm + SM_C);
  const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(sm + SM_X) + hh * XTILE;
  const __nv_bfloat16* dyh = reinterpret_cast<const __nv_bfloat16*>(sm + SM_DY) + hh * XTILE;

  // dS^T and dG^T (n, p) of head hh, column tiles w and w + 4 (< 7), K =
  // the 64 rows j: the A fragments (B o dt w)^T (a bf16 pair) and (C o
  // exp(cum))^T from B and C read transposed, x's and dy's B fragments
  // read transposed from their tiles
  float ds[2][4], dg[2][4];
  zero(ds);
  zero(dg);
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk) {
    uint32_t ba[4], ca[4];
    hopper::ldmatrix_x4_trans(ba, bt + (16 * kk + lr + 8 * (mi / 2)) * BLD + 8 * (mi % 2));
    hopper::ldmatrix_x4_trans(ca, ct + (16 * kk + lr + 8 * (mi / 2)) * BLD + 8 * (mi % 2));
    const int j0 = 16 * kk + 2 * tq;
    const float2 d0 = *reinterpret_cast<const float2*>(v + V_D + j0);
    const float2 d1 = *reinterpret_cast<const float2*>(v + V_D + j0 + 8);
    const float2 w0 = *reinterpret_cast<const float2*>(v + V_W + j0);
    const float2 w1 = *reinterpret_cast<const float2*>(v + V_W + j0 + 8);
    const float2 f0 = make_float2(d0.x * w0.x, d0.y * w0.y);
    const float2 f1 = make_float2(d1.x * w1.x, d1.y * w1.y);
    const float2 e0 = *reinterpret_cast<const float2*>(v + V_EC + j0);
    const float2 e1 = *reinterpret_cast<const float2*>(v + V_EC + j0 + 8);
    uint32_t hi[4], lo[4], ce[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      scale_split(ba[c], c < 2 ? f0 : f1, hi[c], lo[c]);
      ce[c] = hopper::scale_bf16x2(ca[c], c < 2 ? e0 : e1);
    }
    const int jr = (16 * kk + lr + 8 * (mi % 2)) * XLD;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int pt = w + 4 * t;
      if (pt >= PT) continue;
      uint32_t xb[2], db[2];
      hopper::ldmatrix_x2_trans(xb, xh + jr + 8 * pt);
      hopper::ldmatrix_x2_trans(db, dyh + jr + 8 * pt);
      hopper::mma_m16n8k16(ds[t], hi, xb[0], xb[1]);
      hopper::mma_m16n8k16(ds[t], lo, xb[0], xb[1]);
      hopper::mma_m16n8k16(dg[t], ce, db[0], db[1]);
    }
  }
  float* so = states + (bh * (nsub + 1) + k + 1) * PN;
  float* go = adj + (bh * nsub + k) * PN;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pt = w + 4 * t, n = g + 8 * (e / 2), p = 8 * pt + 2 * tq + e % 2;
      if (pt < PT && p < HP) {
        so[p * HN + n] = ds[t][e];
        go[p * HN + n] = dg[t][e];
      }
    }
  if (w == 0 && lane == 0) decay[bh * nsub + k] = v[V_EL];
}

// ---- 2. the serial pass: one thread per 4 elements (a float4) of a (batch
// row, head)'s state, the states forward (the first nbh * PN / 4 threads)
// or the adjoints backward (the next), in place
__global__ void __launch_bounds__(SERIAL_THREADS)
ssd_bwd_tc_serial_kernel(const float* __restrict__ init, const float* __restrict__ dstate,
                         float* __restrict__ states, float* __restrict__ adj,
                         const float* __restrict__ decay, float* __restrict__ dinit, int nbh,
                         int nsub) {
  constexpr int PN4 = PN / 4;
  const size_t n = (size_t)nbh * PN4, idx = (size_t)blockIdx.x * SERIAL_THREADS + threadIdx.x;
  if (idx >= 2 * n) return;
  const bool adjoint = idx >= n;  // n is a multiple of 32 (nbh of 4): a warp takes one kind
  const size_t i = adjoint ? idx - n : idx, bh = i / PN4;
  const float* el = decay + bh * nsub;
  auto fma4 = [](float f, float4 a, float4 d) {
    return make_float4(fmaf(f, a.x, d.x), fmaf(f, a.y, d.y), fmaf(f, a.z, d.z),
                       fmaf(f, a.w, d.w));
  };
  if (!adjoint) {
    float4* st = reinterpret_cast<float4*>(states + bh * (size_t)(nsub + 1) * PN) + i % PN4;
    float4 s = init ? reinterpret_cast<const float4*>(init)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    st[0] = s;
    for (int k0 = 0; k0 < nsub; k0 += SERIAL_AHEAD) {
      float4 d[SERIAL_AHEAD];
      float f[SERIAL_AHEAD];
#pragma unroll
      for (int u = 0; u < SERIAL_AHEAD; ++u)
        if (k0 + u < nsub) {
          d[u] = st[(size_t)(k0 + u + 1) * PN4];
          f[u] = el[k0 + u];
        }
#pragma unroll
      for (int u = 0; u < SERIAL_AHEAD; ++u)
        if (k0 + u < nsub) {
          s = fma4(f[u], s, d[u]);
          st[(size_t)(k0 + u + 1) * PN4] = s;
        }
    }
    return;
  }
  float4* gs = reinterpret_cast<float4*>(adj + bh * (size_t)nsub * PN) + i % PN4;
  float4 g = dstate ? reinterpret_cast<const float4*>(dstate)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = nsub - 1; k0 >= 0; k0 -= SERIAL_AHEAD) {
    float4 d[SERIAL_AHEAD];
    float f[SERIAL_AHEAD];
#pragma unroll
    for (int u = 0; u < SERIAL_AHEAD; ++u)
      if (k0 - u >= 0) {
        d[u] = gs[(size_t)(k0 - u) * PN4];
        f[u] = el[k0 - u];
      }
#pragma unroll
    for (int u = 0; u < SERIAL_AHEAD; ++u)
      if (k0 - u >= 0) {
        gs[(size_t)(k0 - u) * PN4] = g;
        g = fma4(f[u], g, d[u]);
      }
  }
  if (dinit) reinterpret_cast<float4*>(dinit)[i] = g;
}

// ---- 3. the gradients of each sub-chunk
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_tc_grad_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                       const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                       const float* __restrict__ states, const float* __restrict__ adj,
                       __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                       float* __restrict__ dBp, float* __restrict__ dCp,
                       float* __restrict__ dAp, int S, int H, int b_sb, int b_ss, int c_sb,
                       int c_ss) {
  using hopper::mma_m16n8k16;
  using hopper::pack_bf16;
  extern __shared__ __align__(16) unsigned char sm[];
  const int h0 = blockIdx.x * HEADS, k = blockIdx.y, b = blockIdx.z, nsub = gridDim.y;
  const int c0 = k * Q, rows = min(Q, S - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hh = warp % HEADS, w = warp / HEADS;
  const int g = lane / 4, tq = lane % 4;
  const int h = h0 + hh;
  const size_t bh = (size_t)b * H + h;
  float* v = reinterpret_cast<float*>(sm + SM_V) + hh * VEC;
  const __nv_bfloat16* bt = reinterpret_cast<const __nv_bfloat16*>(sm + SM_B);
  const __nv_bfloat16* ct = reinterpret_cast<const __nv_bfloat16*>(sm + SM_C);
  const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(sm + SM_X) + hh * XTILE;
  const __nv_bfloat16* dyh = reinterpret_cast<const __nv_bfloat16*>(sm + SM_DY) + hh * XTILE;
  __nv_bfloat16* s0t = reinterpret_cast<__nv_bfloat16*>(sm + SM_S0) + hh * STILE;
  __nv_bfloat16* ght = reinterpret_cast<__nv_bfloat16*>(sm + SM_GH) + hh * STILE;
  __nv_bfloat16* glt = reinterpret_cast<__nv_bfloat16*>(sm + SM_GL) + hh * STILE;
  const size_t part = ((size_t)(b * (H / HEADS) + blockIdx.x) * S + c0) * HN;

  const float2 dtr =
      issue_subchunk(sm, x, dy, Bm, Cm, dt, b, c0, rows, S, H, h0, b_sb, b_ss, c_sb, c_ss);
  {  // head hh's s0_k in bf16, G_k in bf16 hi + lo, and <G_k, s0_{k+1}>, by
     // its 4 warps, their loads in flight with the tiles' (rows 50 .. 55 of
     // the state tiles zero)
    const float4* s0g = reinterpret_cast<const float4*>(states + (bh * (nsub + 1) + k) * PN);
    const float4* s1g = s0g + PN / 4;
    const float4* gg = reinterpret_cast<const float4*>(adj + (bh * nsub + k) * PN);
    const int t = w * 32 + lane;
    constexpr int PER = (PN / 4 + 127) / 128;  // float4s of each a thread
    float4 s[PER], s1[PER], G[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = t + 128 * u;
      if (e < PN / 4) {
        s[u] = __ldg(s0g + e);
        s1[u] = __ldg(s1g + e);
        G[u] = __ldg(gg + e);
      }
    }
    scan_dt(sm, A, h0, dtr);
    float gs = 0.f;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = t + 128 * u;
      if (e >= PN / 4) continue;
      gs = fmaf(G[u].x, s1[u].x,
                fmaf(G[u].y, s1[u].y, fmaf(G[u].z, s1[u].z, fmaf(G[u].w, s1[u].w, gs))));
      const int at = (e / 4) * SLD + 4 * (e % 4);
      *reinterpret_cast<uint2*>(s0t + at) =
          make_uint2(pack_bf16(s[u].x, s[u].y), pack_bf16(s[u].z, s[u].w));
      *reinterpret_cast<uint2*>(ght + at) =
          make_uint2(pack_bf16(G[u].x, G[u].y), pack_bf16(G[u].z, G[u].w));
      *reinterpret_cast<uint2*>(glt + at) = make_uint2(hopper::pack_bf16_rest(G[u].x, G[u].y),
                                                       hopper::pack_bf16_rest(G[u].z, G[u].w));
    }
    for (int e = t; e < 3 * 6 * (HN / 2); e += 128) {  // rows 50 .. 55, three tiles
      __nv_bfloat16* tile = e < 48 ? s0t : e < 96 ? ght : glt;
      const int f = e % 48;
      reinterpret_cast<uint32_t*>(tile + (HP + f / 8) * SLD)[f % 8] = 0u;
    }
    gs = warp_sum(gs);
    if (lane == 0) v[V_GS + w] = gs;
  }
  __syncthreads();

  const int i0 = 16 * w, r0 = i0 + g, r1 = r0 + 8;
  const float ci[2] = {v[V_C + r0], v[V_C + r1]};
  const float di[2] = {v[V_D + r0], v[V_D + r1]};
  const float eci[2] = {v[V_EC + r0], v[V_EC + r1]};
  const float wi[2] = {v[V_W + r0], v[V_W + r1]};
  const int mi = lane / 8, lr = lane % 8;
  float* exb = reinterpret_cast<float*>(sm + SM_XB);
  float* exc = reinterpret_cast<float*>(sm + SM_XC);
  // The 4 heads' dB (or dC) of strip w summed in order over the exchange:
  // head 0's written, each next head adds its own, head 3 stores the sum's
  // rows below S to the group's partials; barrier 1 + w joins the strip's
  // 4 warps
  auto head_sum = [&](const float (&d)[2][4], float* ex, float* out) {
#pragma unroll
    for (int t = 0; t < HEADS; ++t) {
      if (hh == t) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int at = (r0 + 8 * hf) * HN + 8 * nt + 2 * tq;
            float2 sum = make_float2(d[nt][2 * hf], d[nt][2 * hf + 1]);
            if (t > 0) {
              const float2 o = *reinterpret_cast<const float2*>(ex + at);
              sum = make_float2(o.x + sum.x, o.y + sum.y);
            }
            if (t < HEADS - 1)
              *reinterpret_cast<float2*>(ex + at) = sum;
            else if (r0 + 8 * hf < rows)
              *reinterpret_cast<float2*>(out + at) = sum;
          }
      }
      if (t < HEADS - 1) hopper::named_bar_sync(1 + w, HEADS * 32);
    }
  };
  // element e of a 16 x 8 block nt of the 16 x 16 score block at column j0:
  // row r0 + 8 (e / 2), column j0 + 8 nt + 2 tq + e % 2

  // (a) left of the diagonal, column blocks kk <= w: CB = C_i B_j^T, DX =
  // dy_i x_j^T; M's row sums; S2 = L o DX o dt_j as an A fragment, dC +=
  // S2 B_j.  Then dy s0_k: exp(cum) C.(dy s0) and dC's last term.
  float rowm[2] = {0.f, 0.f}, t1[2];
  {
    uint32_t ca[4];
    hopper::ldmatrix_x4(ca, ct + (i0 + lr + 8 * (mi % 2)) * BLD + 8 * (mi / 2));
    float accc[2][4];
    zero(accc);
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (kk > w) break;
      float cb[2][4], dxs[2][4];
      zero(cb);
      zero(dxs);
      scores_n(cb, ca, bt, 16 * kk, lane);
      scores_p(dxs, dyh, i0, xh, 16 * kk, lane);
      uint32_t sa[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = 16 * kk + 8 * nt + 2 * tq;
        const float2 cj = *reinterpret_cast<const float2*>(v + V_C + j);
        const float2 dj = *reinterpret_cast<const float2*>(v + V_D + j);
        float s2[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + 8 * (e / 2), jj = j + e % 2;
          const float L = jj <= i ? ex2(ci[e / 2] - (e % 2 ? cj.y : cj.x)) : 0.f;
          s2[e] = L * dxs[nt][e] * (e % 2 ? dj.y : dj.x);
          if (jj < i) rowm[e / 2] = fmaf(s2[e], cb[nt][e], rowm[e / 2]);
        }
        sa[2 * nt] = pack_bf16(s2[0], s2[1]);
        sa[2 * nt + 1] = pack_bf16(s2[2], s2[3]);
      }
      times_rows_n(accc, sa, bt, 16 * kk, lane);
    }
    float ds0[2][4];
    zero(ds0);
    times_state(ds0, dyh, i0, s0t, lane);
    float cd[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 c = bf2(*reinterpret_cast<const uint32_t*>(
            ct + (r0 + 8 * hf) * BLD + 8 * nt + 2 * tq));
        cd[hf] = fmaf(c.x, ds0[nt][2 * hf], fmaf(c.y, ds0[nt][2 * hf + 1], cd[hf]));
        accc[nt][2 * hf] = fmaf(eci[hf], ds0[nt][2 * hf], accc[nt][2 * hf]);
        accc[nt][2 * hf + 1] = fmaf(eci[hf], ds0[nt][2 * hf + 1], accc[nt][2 * hf + 1]);
      }
    head_sum(accc, exc, dCp + part);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rowm[hf] = quad_sum(rowm[hf]);
      t1[hf] = eci[hf] * quad_sum(cd[hf]);
    }
  }

  // (b) right of the diagonal, column blocks kk >= w: T1 = B_i C_j^T, R2 =
  // x_i dy_j^T, Lt[i][j] = exp(cum_j - cum_i) for j >= i; M's column sums
  // dt_i sum_{j > i} Lt T1 R2; T2 = Lt o R2 o dt_i as an A fragment, dB +=
  // T2 C_j.  Then dB += (x o dt w)_i G_k (G's bf16 hi).
  uint32_t ba[4];
  hopper::ldmatrix_x4(ba, bt + (i0 + lr + 8 * (mi % 2)) * BLD + 8 * (mi / 2));
  float colm[2] = {0.f, 0.f};
  {
    float accb[2][4];
    zero(accb);
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (kk < w) continue;
      float t1s[2][4], r2[2][4];
      zero(t1s);
      zero(r2);
      scores_n(t1s, ba, ct, 16 * kk, lane);
      scores_p(r2, xh, i0, dyh, 16 * kk, lane);
      uint32_t ta[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = 16 * kk + 8 * nt + 2 * tq;
        const float2 cj = *reinterpret_cast<const float2*>(v + V_C + j);
        float t2[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + 8 * (e / 2), jj = j + e % 2;
          const float Lt = jj >= i ? ex2((e % 2 ? cj.y : cj.x) - ci[e / 2]) : 0.f;
          const float lr2 = Lt * r2[nt][e];
          if (jj > i) colm[e / 2] = fmaf(lr2, t1s[nt][e], colm[e / 2]);
          t2[e] = lr2 * di[e / 2];
        }
        ta[2 * nt] = pack_bf16(t2[0], t2[1]);
        ta[2 * nt + 1] = pack_bf16(t2[2], t2[3]);
      }
      times_rows_n(accb, ta, ct, 16 * kk, lane);
    }
    const float dw[2] = {di[0] * wi[0], di[1] * wi[1]};
    times_state(accb, xh, i0, ght, lane, dw);
    head_sum(accb, exb, dBp + part);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) colm[hf] = di[hf] * quad_sum(colm[hf]);
  }

  // (c) dxdt = w (B_i G_k^T) + sum_{j >= i} Lt o T1 dy_j, one column tile of
  // P at a time: T1's A fragments first (recomputed from B_i C_j^T), then
  // per tile B G^T (G's hi and lo) and the 4 - w products; dx = dt dxdt
  // out, x.(B G^T) and x.dxdt summed per row
  float xg[2] = {0.f, 0.f}, xdx[2] = {0.f, 0.f};
  {
    uint32_t t1a[Q / 16][4];
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (kk < w) continue;
      float t1s[2][4];
      zero(t1s);
      scores_n(t1s, ba, ct, 16 * kk, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = 16 * kk + 8 * nt + 2 * tq;
        const float2 cj = *reinterpret_cast<const float2*>(v + V_C + j);
        float l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + 8 * (e / 2), jj = j + e % 2;
          l[e] = jj >= i ? ex2((e % 2 ? cj.y : cj.x) - ci[e / 2]) * t1s[nt][e] : 0.f;
        }
        t1a[kk][2 * nt] = pack_bf16(l[0], l[1]);
        t1a[kk][2 * nt + 1] = pack_bf16(l[2], l[3]);
      }
    }
    __nv_bfloat16* out = dx + (((size_t)b * S + c0) * H + h) * HP;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      float bg[4] = {0.f, 0.f, 0.f, 0.f}, acc[4] = {0.f, 0.f, 0.f, 0.f};
      {
        uint32_t gh[2], gl[2];
        hopper::ldmatrix_x2(gh, ght + (8 * pt + lr) * SLD + 8 * (mi % 2));
        hopper::ldmatrix_x2(gl, glt + (8 * pt + lr) * SLD + 8 * (mi % 2));
        mma_m16n8k16(bg, ba, gh[0], gh[1]);
        mma_m16n8k16(bg, ba, gl[0], gl[1]);
      }
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        if (kk < w) continue;
        uint32_t yb[2];
        hopper::ldmatrix_x2_trans(yb, dyh + (16 * kk + lr + 8 * (mi % 2)) * XLD + 8 * pt);
        mma_m16n8k16(acc, t1a[kk], yb[0], yb[1]);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r0 + 8 * hf, p = 8 * pt + 2 * tq;
        const float2 xv = bf2(*reinterpret_cast<const uint32_t*>(xh + r * XLD + p));
        const float g0 = bg[2 * hf], g1 = bg[2 * hf + 1];
        const float d0 = fmaf(wi[hf], g0, acc[2 * hf]), d1 = fmaf(wi[hf], g1, acc[2 * hf + 1]);
        xg[hf] = fmaf(xv.x, g0, fmaf(xv.y, g1, xg[hf]));
        xdx[hf] = fmaf(xv.x, d0, fmaf(xv.y, d1, xdx[hf]));
        if (r < rows && p < HP)
          *reinterpret_cast<uint32_t*>(out + (size_t)r * H * HP + p) =
              pack_bf16(di[hf] * d0, di[hf] * d1);
      }
    }
  }

  // (d) dcum and x.dxdt of the strip's rows to the head's vectors
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float gterm = wi[hf] * di[hf] * quad_sum(xg[hf]);
    const float xd = quad_sum(xdx[hf]);
    if (tq == 0) {
      v[V_DC + r0 + 8 * hf] = rowm[hf] - colm[hf] + t1[hf] - gterm;
      v[V_XDX + r0 + 8 * hf] = xd;
    }
  }
  __syncthreads();

  // (e) per head (warp hh), dcum's reverse cumsum da (with <G_k, s0_{k+1}>
  // on row 63), ddt and the sub-chunk's dt da
  if (warp < HEADS) {  // warp hh, w 0
    float dc[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) dc[hf] = v[V_DC + lane + 32 * hf];
    if (lane == 31) dc[1] += ((v[V_GS] + v[V_GS + 1]) + v[V_GS + 2]) + v[V_GS + 3];
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
    const float a = A[h];
    float da = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = lane + 32 * hf;
      if (i < rows) ddt[((size_t)b * S + c0 + i) * H + h] = fmaf(a, dc[hf], v[V_XDX + i]);
      da = fmaf(v[V_D + i], dc[hf], da);
    }
    da = warp_sum(da);
    if (lane == 0) dAp[bh * nsub + k] = da;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The "tc" route: bf16 at (P, N) = (50, 16), H a multiple of 4, every
// pointer 16-byte aligned and the B / C strides multiples of 8 elements.
// init, dstate and dinit may be null.  Scratch, fp32: states (b, H, nsub +
// 1, 50, 16) and adj (b, H, nsub, 50, 16), nsub = ceil(S / 64), decay and
// dAp (b, H, nsub), dBp and dCp (b, H / 4, S, 16).  Four launches; returns
// the first cudaError_t that is not cudaSuccess, or cudaErrorInvalidValue
// for what the kernels do not take.
extern "C" int ssd_scan_bwd_tc(const void* x, const void* dt, const void* A, const void* B,
                               const void* C, const void* dy, const void* init,
                               const void* dstate, void* dx, void* ddt, void* dA, void* dB,
                               void* dC, void* dinit, void* states, void* adj, void* decay,
                               void* dBp, void* dCp, void* dAp, int nb, int S, int H, int b_sb,
                               int b_ss, int c_sb, int c_ss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1 || S < 1 || H < 1 || H % HEADS != 0 || b_sb % 8 || b_ss % 8 || c_sb % 8 ||
      c_ss % 8 || !aligned16(x) || !aligned16(dy) || !aligned16(B) || !aligned16(C) ||
      !aligned16(states) || !aligned16(adj) || !aligned16(init) || !aligned16(dstate) ||
      !aligned16(dinit))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nsub = (S + Q - 1) / Q;
  if (nsub > 65535 || nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  const bf* dyb = static_cast<const bf*>(dy);
  const bf* Bb = static_cast<const bf*>(B);
  const bf* Cb = static_cast<const bf*>(C);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* st = static_cast<float*>(states);
  float* gs = static_cast<float*>(adj);
  float* el = static_cast<float*>(decay);
  float* pb = static_cast<float*>(dBp);
  float* pc = static_cast<float*>(dCp);
  float* pa = static_cast<float*>(dAp);
  const dim3 grid(H / HEADS, nsub, nb);

  static hopper::SmemRaised raised_local, raised_grad;
  cudaError_t err = hopper::allow_smem(ssd_bwd_tc_local_kernel, SM_LOCAL, raised_local);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hopper::allow_smem(ssd_bwd_tc_grad_kernel, SM_GRAD, raised_grad);
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_tc_local_kernel<<<grid, THREADS, SM_LOCAL, s>>>(xb, dtf, Af, Bb, Cb, dyb, st, gs, el,
                                                          S, H, b_sb, b_ss, c_sb, c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t elems = 2 * (size_t)nb * H * (PN / 4);  // a thread per 4 of each
  ssd_bwd_tc_serial_kernel<<<(unsigned)((elems + SERIAL_THREADS - 1) / SERIAL_THREADS),
                             SERIAL_THREADS, 0, s>>>(
      static_cast<const float*>(init), static_cast<const float*>(dstate), st, gs, el,
      static_cast<float*>(dinit), nb * H, nsub);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_tc_grad_kernel<<<grid, THREADS, SM_GRAD, s>>>(
      xb, dtf, Af, Bb, Cb, dyb, st, gs, static_cast<bf*>(dx), static_cast<float*>(ddt), pb, pc,
      pa, S, H, b_sb, b_ss, c_sb, c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  return launch_reduce<bf>(pb, pc, pa, dB, dC, dA, nb, S, H / HEADS, H, HN, nsub, s);
}
