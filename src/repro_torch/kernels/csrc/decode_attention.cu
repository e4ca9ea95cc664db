// decode_attention: one query token per (batch row, head) against the KV
// cache, softmax over cache positions < length, split over the sequence.
//
// Replaces the TPU kernel kernels/decode_attention.py:decode_attention
// (_decode_kernel) of the JAX package.
//
// Layout: q and out (B, H, hd); the cache k, v (B, S, KV, hd) is read in
// place, with no transpose.  length (1 <= length <= S) is a runtime int, or
// an int32 in device memory (clamped to [0, S]) that every block reads at
// its start: a decode step computes it on the card, so a captured CUDA graph
// of the step replays with each step's length.  With a device length the
// host cannot see it, so the split plan is made for all S keys, and a split
// wholly past `length` runs no tile and adds nothing to the merge.
//
// lse, where the caller passes it: fp32 (B, H), each row's natural
// log-sum-exp of its scaled scores over the keys attended, written by the
// split merge.  A rank of a sequence-sharded cache attends its own slice
// and combines its (out, lse) with the other ranks' into the exact softmax
// (models/attention.py).  A device length of 0 (a slice wholly past the
// token's position) gives out = 0 and lse = -inf, which that combine weighs
// 0: every split then leaves m = NEG_INF and l = 0, and the merge's
// O / max(L, tiny) is 0 and log(L) is -inf.
//
// What bounds it on an H100: each cache element is read once and used for
// 2*G operations (G query heads per KV head), so the bytes of the first
// `length` cache rows bound it: at the served shape (B 8, KV 2, hd 64,
// length 1024) 4.2 MB, 1.25 us at 3.35 TB/s.  At that size the floor that
// really limits it is latency: one launch, one or two round trips to device
// memory (~1 us each) and the serial wgmma -> softmax -> wgmma chain of each
// 64-key tile, ~5-8 us in all.
//
// What the design does about it (bf16, decode_wgmma_kernel): one launch per
// call, nothing allocated but the output.  A block per (split, KV head,
// batch row); a split is a run of 64-key tiles, and the host's split plan
// (kernels/decode_attention.py) sizes the splits so that B*KV*splits fills
// the SMs.  A producer warp asks TMA, at once, for the block's K and V tiles
// (4D maps of the cache in place, 128-byte swizzle) into a ring of W_STAGES
// stages, so all of a split's bytes are in flight after one round trip.  One
// consumer warpgroup runs both products on the tensor cores with the
// operands swapped, since the G <= 8 query heads of a KV head are exactly
// wgmma's N = 8: S^T (64 keys x 8) = K_tile . Q^T (K-major A and B), then
// O^T (hd x 8) += V^T . P^T, V^T being the V tile read as an MN-major A and
// P written to shared memory keys-contiguous as two bf16 tiles, its rounding
// and the remainder, whose two products keep ~16 bits of P: the reference
// takes P . V in fp32, and one bf16 P would cost ~16x its error (the tensor
// cores are idle here, so the second product is free).  wgmma m64n8k16 was
// chosen over mma.sync because it reads the TMA tiles from shared memory in
// their swizzled layout, with no ldmatrix pass through registers.  Keys past
// `length` score -inf (TMA zero-fills keys past S, and a zero key would
// score 0).  The splits of one (batch row, KV head) form a thread-block
// cluster: each block leaves its (m, l, O) in shared memory and, after a
// cluster barrier, every block merges a share of the outputs by reading the
// others' through distributed shared memory.
//
// fp32 (decode_split_kernel and decode_combine_kernel) stays on the CUDA
// cores, split into 64-key chunks with fp32 scratch from the caller and a
// second merging launch: it exists for parity runs, not for speed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int DCHUNK = 64;   // keys per block
constexpr int DWARPS = 4;
constexpr int DTHREADS = 32 * DWARPS;
constexpr int MAXG = 8;      // query heads per KV head

// The keys attended: `length`, or, where the caller passes `length_dev`, the
// int32 there clamped to [0, S].
__device__ __forceinline__ int keys_attended(const int* length_dev, int length, int S) {
  return length_dev ? min(max(*length_dev, 0), S) : length;
}

template <int HD>
__global__ void __launch_bounds__(DTHREADS)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o_part,
                    float* __restrict__ m_part, float* __restrict__ l_part, int S, int H,
                    int KV, int length_arg, const int* __restrict__ length_dev, int n_splits,
                    float scale) {
  static_assert(DCHUNK == 64, "phase 2 gives each lane two keys");
  constexpr int PER = HD / 32;  // dims per lane: lane*PER .. lane*PER+PER-1
  __shared__ float Ss[MAXG][DCHUNK];
  __shared__ float Ms[MAXG], Ls[MAXG];
  __shared__ float Acc[DWARPS][MAXG][HD];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, h0 = kvh * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = split * DCHUNK;
  const int length = keys_attended(length_dev, length_arg, S);
  if (j0 >= length) {  // no key here: m = NEG_INF, l = 0, O = 0 weigh 0 in the combine
    for (int i = threadIdx.x; i < G * HD; i += DTHREADS) {
      const size_t r = ((size_t)b * H + h0 + i / HD) * n_splits + split;
      o_part[r * HD + i % HD] = 0.f;
      if (i % HD == 0) {
        m_part[r] = NEG_INF;
        l_part[r] = 0.f;
      }
    }
    return;
  }

  float qr[MAXG][PER];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < PER; ++e)
      qr[g][e] = g < G ? q[((size_t)b * H + h0 + g) * HD + lane * PER + e] : 0.f;

  // scores: warp w takes keys w, w+4, ...; lanes split head_dim
  for (int jj = warp; jj < DCHUNK; jj += DWARPS) {
    const int j = j0 + jj;
    if (j < length) {
      const float* kr = k + (((size_t)b * S + j) * KV + kvh) * HD + lane * PER;
      float kv[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) kv[e] = kr[e];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < PER; ++e) part = fmaf(qr[g][e], kv[e], part);
          part = warp_sum(part);
          if (lane == 0) Ss[g][jj] = part * scale;
        }
      }
    } else if (lane < G) {
      Ss[lane][jj] = NEG_INF;
    }
  }
  __syncthreads();

  // chunk softmax statistics, one warp per query head
  for (int g = warp; g < G; g += DWARPS) {
    const float a = Ss[g][lane], c = Ss[g][lane + 32];
    const float mx = warp_max(fmaxf(a, c));
    const float pa = expf(a - mx), pc = expf(c - mx);
    Ss[g][lane] = pa;
    Ss[g][lane + 32] = pc;
    const float sum = warp_sum(pa + pc);
    if (lane == 0) {
      Ms[g] = mx;
      Ls[g] = sum;
    }
  }
  __syncthreads();

  // p @ v: the same key split as the scores, then a sum over the warps
  float acc[MAXG][PER];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[g][e] = 0.f;
  for (int jj = warp; jj < DCHUNK; jj += DWARPS) {
    const int j = j0 + jj;
    if (j < length) {
      const float* vr = v + (((size_t)b * S + j) * KV + kvh) * HD + lane * PER;
      float vv[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) vv[e] = vr[e];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float p = Ss[g][jj];
#pragma unroll
          for (int e = 0; e < PER; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G)
#pragma unroll
      for (int e = 0; e < PER; ++e) Acc[warp][g][lane * PER + e] = acc[g][e];
  __syncthreads();

  for (int i = threadIdx.x; i < G * HD; i += DTHREADS) {
    const int g = i / HD, d = i % HD;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) sum += Acc[w][g][d];
    const size_t r = ((size_t)b * H + h0 + g) * n_splits + split;
    o_part[r * HD + d] = sum;
    if (d == 0) {
      m_part[r] = Ms[g];
      l_part[r] = Ls[g];
    }
  }
}

// One block per (batch row, head), one thread per head_dim element; thread
// 0 writes the row's log-sum-exp where `lse` is given.
__global__ void decode_combine_kernel(const float* __restrict__ o_part,
                                      const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      float* __restrict__ out, float* __restrict__ lse,
                                      int n_splits, int HD) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* mp = m_part + (size_t)bh * n_splits;
  const float* lp = l_part + (size_t)bh * n_splits;
  float M = NEG_INF;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, mp[s]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(mp[s] - M);
    L = fmaf(lp[s], w, L);
    o = fmaf(o_part[((size_t)bh * n_splits + s) * HD + d], w, o);
  }
  out[(size_t)bh * HD + d] = o / fmaxf(L, 1e-30f);
  if (lse != nullptr && d == 0) lse[bh] = M + logf(L);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           float* o_part, float* m_part, float* l_part, int B, int S, int H, int KV,
           int length, const int* length_dev, int n_splits, float scale, cudaStream_t s) {
  const dim3 grid(n_splits, KV, B);
  decode_split_kernel<HD><<<grid, DTHREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      o_part, m_part, l_part, S, H, KV, length, length_dev, n_splits, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<B * H, HD, 0, s>>>(o_part, m_part, l_part,
                                             static_cast<float*>(out), lse, n_splits, HD);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- bf16 path, wgmma
constexpr int W_TILE = DCHUNK;            // keys per tile
constexpr int W_STAGES = 4;               // ring of K/V tiles
constexpr int W_THREADS = 128 + 32;       // one consumer warpgroup, one producer warp

template <int HD>
struct DecodeTiles {
  static constexpr int ATOMS = HD / 64;             // 64-wide column blocks of hd
  static constexpr int KV_ATOM = W_TILE * 128;      // 64 keys of 128 bytes
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;
  static constexpr int STAGE = 2 * KV_BYTES;        // K then V
  static constexpr int Q_ATOM = MAXG * 128;         // 8 query heads of 128 bytes
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int P_TILE = MAXG * W_TILE * 2;  // P: 8 heads x 64 keys, bf16
  static constexpr int P_BYTES = 2 * P_TILE;        // its rounding, then the remainder
  static constexpr int F32 = MAXG * HD + 2 * MAXG + 4 * MAXG;  // O, m, l, per-warp partials
  static constexpr int SMEM =
      W_STAGES * STAGE + Q_BYTES + P_BYTES + F32 * 4 + (1 + 2 * W_STAGES) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(W_THREADS)
decode_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int H,
                    int KV, int length_arg,
                    const int* __restrict__ length_dev, int tiles_per_split, float scale_log2) {
  using namespace hopper;
  using T = DecodeTiles<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kvs = smem;                  // stage s: K at s * STAGE, V after it
  unsigned char* qs = kvs + W_STAGES * T::STAGE;
  unsigned char* ps = qs + T::Q_BYTES;
  float* obuf = reinterpret_cast<float*>(ps + T::P_BYTES);  // [MAXG][HD], unnormalised
  float* mbuf = obuf + MAXG * HD;             // [MAXG] running max (log2 units)
  float* lbuf = mbuf + MAXG;                  // [MAXG] running sum
  float* red = lbuf + MAXG;                   // [4 warps][MAXG]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(red + 4 * MAXG);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + W_STAGES;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, h0 = kvh * G;
  const int t0 = blockIdx.x * tiles_per_split;
  // With a device length a split may lie wholly past it (ntiles <= 0): it
  // loads and runs no tile but still reaches both cluster barriers, leaving
  // m = NEG_INF, l = 0 and O = 0, which the merge weighs 0.  Split 0 holds
  // key 0 unless the length is 0, where every split is empty.
  const int length = keys_attended(length_dev, length_arg, S);
  const int ntiles = min(tiles_per_split, (length + W_TILE - 1) / W_TILE - t0);
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {  // producer warp: one thread issues every load
    if (lane == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      // the 8 query rows from h0: rows past the group belong to the next KV
      // head (or read zero past H); their columns of S and O are never stored
      mbar_arrive_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a) tma_load_3d(qs + a * T::Q_ATOM, &qmap, qbar, 64 * a, h0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % W_STAGES;
        if (t >= W_STAGES) mbar_wait(&empty[s], ((t / W_STAGES) + 1) & 1);
        unsigned char* ks = kvs + s * T::STAGE;
        const int key0 = (t0 + t) * W_TILE;
        mbar_arrive_expect_tx(&full[s], T::STAGE);
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load_4d(ks + a * T::KV_ATOM, &kmap, &full[s], 64 * a, kvh, key0, b);
          tma_load_4d(ks + T::KV_BYTES + a * T::KV_ATOM, &vmap, &full[s], 64 * a, kvh, key0, b);
        }
      }
    }
    __syncwarp();
  } else {
    // Accumulator layout of m64n8 (see hopper.cuh): this thread holds rows
    // r and r + 8 (keys of S^T, dims of O^T) of columns c and c + 1 (heads).
    const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
    float o[T::ATOMS][4];
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[a][i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % W_STAGES;
      mbar_wait(&full[s], (t / W_STAGES) & 1);
      const unsigned char* ks = kvs + s * T::STAGE;
      const unsigned char* vs = ks + T::KV_BYTES;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da = make_desc(ks + (kk / 4) * T::KV_ATOM + (kk % 4) * 32, 16, 1024);
        const uint64_t db = make_desc(qs + (kk / 4) * T::Q_ATOM + (kk % 4) * 32, 16, 1024);
        wgmma_ss_n8<0, 0>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scores in log2 units; keys >= length are masked
      const int key0 = (t0 + t) * W_TILE;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = sc[2 * hh + e] * scale_log2;
          if (key0 + r + 8 * hh >= length) v = NEG_INF;
          sc[2 * hh + e] = v;
          mx[e] = fmaxf(mx[e], v);
        }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
      if (lane < 4) {
        red[warp * MAXG + c] = mx[0];
        red[warp * MAXG + c + 1] = mx[1];
      }
      named_bar_sync(1, 128);
      float corr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float tm = red[c + e];
#pragma unroll
        for (int w = 1; w < 4; ++w) tm = fmaxf(tm, red[w * MAXG + c + e]);
        const float mn = fmaxf(m[e], tm);
        corr[e] = exp2f(m[e] - mn);
        m[e] = mn;
        l[e] *= corr[e];
      }
      // P as wgmma's K-major B: row = head, 64 keys of 128 bytes, 16-byte
      // chunks swizzled by XOR with the row, as TMA lays out Q
      __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(ps);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[2 * hh + e] - m[e]);
          l[e] += p;
          const int n = c + e, k = r + 8 * hh;
          const int at = n * 64 + (((k >> 3) ^ n) << 3) + (k & 7);
          const __nv_bfloat16 hi = __float2bfloat16(p);
          pb[at] = hi;
          pb[T::P_TILE / 2 + at] = __float2bfloat16(p - __bfloat162float(hi));
        }
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[a][i] *= corr[i % 2];
      fence_proxy_async();
      named_bar_sync(1, 128);
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a) fence_regs(o[a]);
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a)
#pragma unroll
        for (int kk = 0; kk < W_TILE / 16; ++kk) {
          const uint64_t da = make_desc(vs + a * T::KV_ATOM + kk * 2048, T::KV_ATOM, 1024);
          wgmma_ss_n8<1, 0>(o[a], da, make_desc(ps + kk * 32, 16, 1024), 1);
          wgmma_ss_n8<1, 0>(o[a], da, make_desc(ps + T::P_TILE + kk * 32, 16, 1024), 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a) fence_regs(o[a]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // this block's (m, l, O) of each head, for the cluster's merge
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) l[e] += __shfl_xor_sync(0xffffffffu, l[e], off);
    if (lane < 4) {
      red[warp * MAXG + c] = l[0];
      red[warp * MAXG + c + 1] = l[1];
    }
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) obuf[(c + e) * HD + 64 * a + r + 8 * hh] = o[a][2 * hh + e];
    named_bar_sync(1, 128);
    if (warp == 0 && lane < 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mbuf[c + e] = m[e];
        lbuf[c + e] = red[c + e] + red[MAXG + c + e] + red[2 * MAXG + c + e] + red[3 * MAXG + c + e];
      }
    }
  }

  // Merge: block `rank` of the cluster writes every splits-th share of the
  // G x HD outputs, reading all blocks' (m, l, O) through distributed shared
  // memory; the second barrier keeps each block's shared memory alive until
  // the others have read it.
  __syncwarp();
  cluster_sync();
  const int splits = gridDim.x, rank = cluster_rank();
  for (int i = rank * W_THREADS + threadIdx.x; i < G * HD; i += splits * W_THREADS) {
    const int c = i / HD, d = i % HD;
    float mr[MAX_CLUSTER], M = NEG_INF;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {
      mr[q] = q < splits ? ld_dsmem_f32(mbuf + c, q) : NEG_INF;
      M = fmaxf(M, mr[q]);
    }
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {
      if (q < splits) {
        const float w = exp2f(mr[q] - M);
        L = fmaf(ld_dsmem_f32(lbuf + c, q), w, L);
        O = fmaf(ld_dsmem_f32(obuf + c * HD + d, q), w, O);
      }
    }
    out[((size_t)b * H + h0 + c) * HD + d] = __float2bfloat16(O / fmaxf(L, 1e-30f));
    // M is in log2 units (scores times scale * log2 e)
    if (lse != nullptr && d == 0)
      lse[(size_t)b * H + h0 + c] = (M + log2f(L)) * 0.6931471805599453f;
  }
  cluster_sync();
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                 int S, int H, int KV, int length, const int* length_dev, int splits,
                 int tiles_per_split, float scale, cudaStream_t stream) {
  using T = DecodeTiles<HD>;
  static hopper::SmemRaised raised;
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[3] = {HD, (uint64_t)H, (uint64_t)B};
  const uint64_t qstr[2] = {HD * 2, (uint64_t)H * HD * 2};
  const uint32_t qbox[3] = {64, MAXG, 1};
  const uint64_t kdims[4] = {HD, (uint64_t)KV, (uint64_t)S, (uint64_t)B};
  const uint64_t kstr[3] = {HD * 2, (uint64_t)KV * HD * 2, (uint64_t)S * KV * HD * 2};
  const uint32_t kbox[4] = {64, 1, W_TILE, 1};
  if (!hopper::make_map_bf16(&qmap, q, 3, qdims, qstr, qbox) ||
      !hopper::make_map_bf16(&kmap, k, 4, kdims, kstr, kbox) ||
      !hopper::make_map_bf16(&vmap, v, 4, kdims, kstr, kbox))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(hopper::launch_cluster(
      decode_wgmma_kernel<HD>, raised, dim3(splits, KV, B), W_THREADS, T::SMEM, splits, stream,
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), lse, S, H, KV, length, length_dev,
      tiles_per_split, scale * 1.4426950408889634f));
}

}  // namespace

extern "C" int decode_attention_chunk() { return DCHUNK; }
extern "C" int decode_attention_max_group() { return MAXG; }

// fp32 (the parity path): hd 64 or 128; H / KV <= MAXG; length_dev null and
// n_splits = ceil(length / DCHUNK), or length_dev an int32 on the device and
// n_splits = ceil(S / DCHUNK).  o_part (B, H, n_splits, hd), m_part and
// l_part (B, H, n_splits) are fp32 scratch; lse null, or fp32 (B, H).
// Returns the cudaError_t of the launches.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    void* out, void* lse, void* o_part, void* m_part,
                                    void* l_part, int B, int S, int H, int KV, int hd,
                                    int length, const void* length_dev, int n_splits,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ls = static_cast<float*>(lse);
  const int* ld = static_cast<const int*>(length_dev);
  if ((ld ? S : length) > n_splits * DCHUNK) return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return launch<64>(q, k, v, out, ls, op, mp, lp, B, S, H, KV, length, ld, n_splits, scale, s);
  if (hd == 128)
    return launch<128>(q, k, v, out, ls, op, mp, lp, B, S, H, KV, length, ld, n_splits, scale,
                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16, one launch: splits * tiles_per_split 64-key tiles cover length (or,
// with length_dev an int32 on the device, all S keys), the last split holds
// at least one of those tiles, splits <= hopper::MAX_CLUSTER; hd 64 or 128,
// H / KV <= MAXG; q, k, v 16-byte aligned (TMA).  Returns the cudaError_t of
// the launch, or cudaErrorInvalidValue for what the kernel does not take.
// lse null, or fp32 (B, H).
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int B, int S, int H, int KV, int hd, int length,
                                     const void* length_dev, int splits, int tiles_per_split,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ld = static_cast<const int*>(length_dev);
  const int planned = ld ? S : length;
  const int tiles = (planned + W_TILE - 1) / W_TILE;
  if (planned < 1 || planned > S || KV < 1 || H % KV || H / KV > MAXG || splits < 1 ||
      splits > hopper::MAX_CLUSTER || tiles_per_split < 1 ||
      (splits - 1) * tiles_per_split >= tiles || splits * tiles_per_split < tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return launch_wgmma<64>(q, k, v, out, static_cast<float*>(lse), B, S, H, KV, length, ld,
                            splits, tiles_per_split, scale, s);
  if (hd == 128)
    return launch_wgmma<128>(q, k, v, out, static_cast<float*>(lse), B, S, H, KV, length, ld,
                             splits, tiles_per_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
