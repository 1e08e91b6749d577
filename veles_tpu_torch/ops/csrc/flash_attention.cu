// Flash-attention forward, dq and dk/dv for Hopper (sm_90a), on the FP32
// units.
//
// Replaces the TPU kernels of veles_tpu/ops/pallas_attention.py, for f32
// storage with f32 operands:
//   `_fwd_kernel` (B1)  -> flash_fwd
//   `_dq_kernel`  (B2)  -> flash_dq
//   `_dkv_kernel` (B3)  -> flash_dkv
// The other pairs, whose operands are bf16-exact, run on the tensor cores
// (flash_attention_tc.cu); an f32 × f32 product is not exact in bf16
// pieces, so the f32/f32 parity mode stays here.
// with `flash_chunk`'s contract: q (B, Sq, H, D) against k/v (B, Sk, H, D),
// causal on GLOBAL positions (q_off + row >= k_off + col), an optional
// bound on LOCAL key columns (col < kv_len; kv_len < 0 = none), out and
// an f32 lse (B, Sq, H).  The backward takes delta = sum(dO * O) - g_lse
// (computed by the caller), recomputes p = exp(s - lse) and returns
// dq, dk, dv in the storage type.
//
// Numerics follow the TPU kernel exactly: scale = 1/sqrt(D) applied to
// the f32 score after the product; masked scores are NEG_INF = -1e30;
// probabilities are re-masked to 0 explicitly (never by underflow);
// l is floored at 1e-30, so a fully masked row gets out = 0 and a
// finite lse; every operand of a product is rounded to the operand
// type OD first (q, k, v, dO at load time, p and ds before their
// products), as `_dot` casts; every sum is f32 with fused multiply-adds;
// no fast math.  The kernels are templates over the storage T and OD
// (each float or bf16), instantiated for float/float only.
//
// What bounds it on the H100: operations.  At the LM training shape
// (B=8, S=1024, H=16, D=128, causal) the forward does ~34 GFLOP on
// ~0.13 GB of bf16 operands, far above the ~20 f32 operations per byte
// at which the FP32 units become the limit.  Design, one CTA of 256
// threads per tile, all sums in registers:
//   * forward and dq: one CTA per (query tile of 64 rows, batch·head);
//     the key/value tiles (64 keys) stream through shared memory; the
//     running (m, l) of the online softmax live in shared memory, the
//     output (64 x D) in registers (each thread 4 rows x 8 columns);
//   * dk/dv: one CTA per (key tile of 64 keys, batch·head); the query,
//     dO, lse and delta tiles stream through; dk and dv accumulate in
//     registers, so no atomics and no cross-CTA reduction;
//   * key tiles that the causal or kv_len mask hides from every row of
//     a query tile are skipped (and query tiles hidden from every key
//     of a key tile) — the TPU kernel computes them and adds exactly
//     zero, so the result is the same;
//   * shared-memory rows are padded to D_MAX + 1 floats so that the
//     16 threads of a half-warp that read 16 different rows at one
//     head-dim index hit 16 different banks.
// The products run on the FP32 units (no wgmma, no TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int MAX_D = 128;       // largest head dim
constexpr int DP = MAX_D + 1;    // padded row stride of q/k/v/dO tiles
constexpr int SP = BK + 1;       // padded row stride of score tiles
constexpr int THREADS = 256;     // 16 x 16 thread grid
constexpr float NEG_INF = -1e30f;
constexpr float L_FLOOR = 1e-30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// Rounds an f32 value to the operand type (identity for float).
template <typename OD>
__device__ __forceinline__ float round_od(float x) {
  return to_f<OD>(from_f<OD>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

struct Geometry {
  int B, H, Sq, Sk, D;
  float scale;
  int causal, q_off, k_off, kv_len;

  // Whether local query row `row` attends local key `col`: both exist,
  // the causal rule on global positions, the kv_len bound on local
  // columns (`_mask_tile`).
  __device__ __forceinline__ bool attend(int row, int col) const {
    if (row >= Sq || col >= Sk) return false;
    if (causal && q_off + row < k_off + col) return false;
    if (kv_len >= 0 && col >= kv_len) return false;
    return true;
  }

  // Key tiles [0, n) that can hold a key some row of the query tile
  // starting at q0 attends; the tiles past it are fully masked.
  __device__ __forceinline__ int key_tiles(int q0) const {
    int last = Sk;
    if (kv_len >= 0) last = min(last, kv_len);
    if (causal) {
      const int last_row = min(q0 + BQ, Sq) - 1;
      last = min(last, q_off + last_row - k_off + 1);
    }
    return last <= 0 ? 0 : (last + BK - 1) / BK;
  }

  // First query tile whose rows can attend a key of the tile at c0.
  __device__ __forceinline__ int first_query_tile(int c0) const {
    if (!causal) return 0;
    const int first_row = k_off + c0 - q_off;
    return first_row <= 0 ? 0 : first_row / BQ;
  }
};

// Loads rows [r0, r0 + 64) of one (batch, head) slice of a (B, S, H, D)
// tensor into a padded shared tile, rounded to OD; rows past S are 0.
template <typename T, typename OD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, int H, int D, int b,
                                          int h) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int gr = r0 + r;
    float x = 0.0f;
    if (gr < S) x = round_od<OD>(to_f<T>(src[((size_t)(b * S + gr) * H + h) * D + d]));
    dst[r * DP + d] = x;
  }
}

// Loads a (B, S, H) f32 row vector's entries [r0, r0 + 64) for (b, h).
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int S, int H, int b,
                                          int h) {
  if (threadIdx.x < BQ) {
    const int gr = r0 + threadIdx.x;
    dst[threadIdx.x] = gr < S ? src[(size_t)(b * S + gr) * H + h] : 0.0f;
  }
}

constexpr size_t FWD_SMEM = sizeof(float) * (BQ * DP + BK * DP + BQ * SP + 3 * BQ);
constexpr size_t DQ_SMEM = sizeof(float) * (2 * BQ * DP + 2 * BK * DP + BQ * SP + 2 * BQ);
constexpr size_t DKV_SMEM = sizeof(float) * (2 * BQ * DP + 2 * BK * DP + BQ * SP + 2 * BQ);

// B1: forward with an online softmax over key tiles.  Shared memory:
// the query tile, ONE key/value buffer (k for the scores, then v for the
// product), the probability tile and the running row statistics.
template <typename T, typename OD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ lse, Geometry g) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* kvs = qs + BQ * DP;
  float* ps = kvs + BK * DP;
  float* row_m = ps + BQ * SP;
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;

  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D = g.D;

  load_tile<T, OD>(qs, q, q0, g.Sq, g.H, D, b, h);
  if (threadIdx.x < BQ) {
    row_m[threadIdx.x] = NEG_INF;
    row_l[threadIdx.x] = 0.0f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = g.key_tiles(q0);
  for (int t = 0; t < nk; ++t) {
    const int c0 = t * BK;
    __syncthreads();  // the previous tile's v and p are consumed
    load_tile<T, OD>(kvs, k, c0, g.Sk, g.H, D, b, h);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = kvs[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        ps[r * SP + c] = g.attend(q0 + r, c0 + c) ? s[i][j] * g.scale : NEG_INF;
      }
    __syncthreads();  // scores complete; k no longer needed
    load_tile<T, OD>(kvs, v, c0, g.Sk, g.H, D, b, h);
    // Row statistics: each warp owns 8 rows, each lane 2 of the 64 keys.
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float m_old = row_m[r];
      const float a0 = ps[r * SP + lane];
      const float a1 = ps[r * SP + lane + 32];
      const float new_m = fmaxf(m_old, warp_max(fmaxf(a0, a1)));
      const float corr = expf(m_old - new_m);
      const float p0 = g.attend(q0 + r, c0 + lane) ? expf(a0 - new_m) : 0.0f;
      const float p1 = g.attend(q0 + r, c0 + lane + 32) ? expf(a1 - new_m) : 0.0f;
      const float psum = warp_sum(p0 + p1);
      ps[r * SP + lane] = round_od<OD>(p0);
      ps[r * SP + lane + 32] = round_od<OD>(p1);
      if (lane == 0) {
        row_m[r] = new_m;
        row_l[r] = row_l[r] * corr + psum;
        row_c[r] = corr;
      }
    }
    __syncthreads();  // p, corr and v ready
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], vb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = tx + 16 * j;
        vb[j] = d < D ? kvs[kk * DP + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= g.Sq) continue;
    const float l_safe = fmaxf(row_l[r], L_FLOOR);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < D)
        out[((size_t)(b * g.Sq + row) * g.H + h) * D + d] = from_f<T>(acc[i][j] / l_safe);
    }
  }
  if (threadIdx.x < BQ && q0 + threadIdx.x < g.Sq) {
    const int r = threadIdx.x;
    lse[(size_t)(b * g.Sq + q0 + r) * g.H + h] =
        row_m[r] + logf(fmaxf(row_l[r], L_FLOOR));
  }
}

// The (64 x 64) score and dP tiles of one thread-grid step:
// s = q·kᵀ and dp = dO·vᵀ for rows ty + 16i, columns tx + 16j.
__device__ __forceinline__ void scores_and_dp(const float* qs,
                                              const float* dos,
                                              const float* ks,
                                              const float* vs, int D,
                                              int tx, int ty,
                                              float s[4][4],
                                              float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = qs[(ty + 16 * i) * DP + d];
      da[i] = dos[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = ks[(tx + 16 * j) * DP + d];
      vb[j] = vs[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
}

// B2: dq = sum_j ds·k over key tiles, one CTA per query tile.
template <typename T, typename OD>
__global__ void __launch_bounds__(THREADS)
flash_dq(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dq, Geometry g) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * DP;
  float* ks = dos + BQ * DP;
  float* vs = ks + BK * DP;
  float* dss = vs + BK * DP;
  float* lse_s = dss + BQ * SP;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int D = g.D;

  load_tile<T, OD>(qs, q, q0, g.Sq, g.H, D, b, h);
  load_tile<T, OD>(dos, dout, q0, g.Sq, g.H, D, b, h);
  load_rows(lse_s, lse, q0, g.Sq, g.H, b, h);
  load_rows(delta_s, delta, q0, g.Sq, g.H, b, h);
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = g.key_tiles(q0);
  for (int t = 0; t < nk; ++t) {
    const int c0 = t * BK;
    __syncthreads();
    load_tile<T, OD>(ks, k, c0, g.Sk, g.H, D, b, h);
    load_tile<T, OD>(vs, v, c0, g.Sk, g.H, D, b, h);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores_and_dp(qs, dos, ks, vs, D, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        float ds = 0.0f;
        if (g.attend(q0 + r, c0 + c)) {
          const float p = expf(s[i][j] * g.scale - lse_s[r]);
          ds = p * (dp[i][j] - delta_s[r]) * g.scale;
        }
        dss[r * SP + c] = round_od<OD>(ds);
      }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float da[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = dss[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = tx + 16 * j;
        kb[j] = d < D ? ks[kk * DP + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(da[i], kb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.Sq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dq[((size_t)(b * g.Sq + row) * g.H + h) * D + d] = from_f<T>(acc[i][j]);
    }
  }
}

// B3: dk = sum_i dsᵀ·q and dv = sum_i pᵀ·dO over query tiles, one CTA
// per key tile (each key's sums stay in one CTA: no atomics).
template <typename T, typename OD>
__global__ void __launch_bounds__(THREADS)
flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dk, T* __restrict__ dv, Geometry g) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * DP;
  float* qs = vs + BK * DP;
  float* dos = qs + BQ * DP;
  float* pds = dos + BQ * DP;  // p, then ds, of the current tile
  float* lse_s = pds + BQ * SP;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const int c0 = blockIdx.x * BK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int D = g.D;

  load_tile<T, OD>(ks, k, c0, g.Sk, g.H, D, b, h);
  load_tile<T, OD>(vs, v, c0, g.Sk, g.H, D, b, h);
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  const bool any_key = g.kv_len < 0 || c0 < g.kv_len;
  const int nq = any_key ? (g.Sq + BQ - 1) / BQ : 0;
  for (int t = g.first_query_tile(c0); t < nq; ++t) {
    const int q0 = t * BQ;
    __syncthreads();
    load_tile<T, OD>(qs, q, q0, g.Sq, g.H, D, b, h);
    load_tile<T, OD>(dos, dout, q0, g.Sq, g.H, D, b, h);
    load_rows(lse_s, lse, q0, g.Sq, g.H, b, h);
    load_rows(delta_s, delta, q0, g.Sq, g.H, b, h);
    __syncthreads();
    // Thread tile: query rows ty + 16i, keys tx + 16j.
    float s[4][4], dp[4][4];
    scores_and_dp(qs, dos, ks, vs, D, tx, ty, s, dp);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        float p = 0.0f;
        ds[i][j] = 0.0f;
        if (g.attend(q0 + r, c0 + c)) {
          p = expf(s[i][j] * g.scale - lse_s[r]);
          ds[i][j] = p * (dp[i][j] - delta_s[r]) * g.scale;
        }
        pds[r * SP + c] = round_od<OD>(p);
      }
    __syncthreads();
    // dv[key][d] += p[row][key]·dO[row][d]; this thread: keys ty + 16i.
    for (int r = 0; r < BQ; ++r) {
      float pa[4], da[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = pds[r * SP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = tx + 16 * j;
        da[j] = d < D ? dos[r * DP + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dv_acc[i][j] = fmaf(pa[i], da[j], dv_acc[i][j]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pds[(ty + 16 * i) * SP + tx + 16 * j] = round_od<OD>(ds[i][j]);
    __syncthreads();
    for (int r = 0; r < BQ; ++r) {
      float sa[4], qa[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = pds[r * SP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = tx + 16 * j;
        qa[j] = d < D ? qs[r * DP + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dk_acc[i][j] = fmaf(sa[i], qa[j], dk_acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + ty + 16 * i;
    if (key >= g.Sk) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        const size_t at = ((size_t)(b * g.Sk + key) * g.H + h) * D + d;
        dk[at] = from_f<T>(dk_acc[i][j]);
        dv[at] = from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

bool valid(const Geometry& g) {
  return g.B >= 1 && g.H >= 1 && g.B * g.H <= 65535 && g.Sq >= 1 &&
         g.Sk >= 1 && g.D >= 1 && g.D <= MAX_D;
}

Geometry geometry(int B, int H, int Sq, int Sk, int D, float scale,
                  int causal, int q_off, int k_off, int kv_len) {
  return Geometry{B, H, Sq, Sk, D, scale, causal, q_off, k_off, kv_len};
}

// Sets the dynamic shared-memory limit and launches; returns the launch
// error (cudaGetLastError) or 0.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Storage and operand type codes: 0 = float32, 1 = bfloat16.
template <typename T, typename OD>
int fwd_typed(const void* q, const void* k, const void* v, void* out,
              float* lse, Geometry g, cudaStream_t s) {
  return launch(flash_fwd<T, OD>, dim3((g.Sq + BQ - 1) / BQ, g.B * g.H),
                FWD_SMEM, s, (const T*)q, (const T*)k, (const T*)v,
                (T*)out, lse, g);
}

template <typename T, typename OD>
int dq_typed(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, Geometry g,
             cudaStream_t s) {
  return launch(flash_dq<T, OD>, dim3((g.Sq + BQ - 1) / BQ, g.B * g.H),
                DQ_SMEM, s, (const T*)q, (const T*)k, (const T*)v,
                (const T*)dout, lse, delta, (T*)dq, g);
}

template <typename T, typename OD>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dk, void* dv,
              Geometry g, cudaStream_t s) {
  return launch(flash_dkv<T, OD>, dim3((g.Sk + BK - 1) / BK, g.B * g.H),
                DKV_SMEM, s, (const T*)q, (const T*)k, (const T*)v,
                (const T*)dout, lse, delta, (T*)dk, (T*)dv, g);
}

}  // namespace

extern "C" {

// Geometry the kernels take; the Python wrapper checks against these.
int veles_flash_max_d() { return MAX_D; }
int veles_flash_tile() { return BQ; }

int veles_flash_fwd(int storage, int od, const void* q, const void* k,
                    const void* v, void* out, float* lse, int B, int H,
                    int Sq, int Sk, int D, float scale, int causal,
                    int q_off, int k_off, int kv_len, void* stream) {
  const Geometry g = geometry(B, H, Sq, Sk, D, scale, causal, q_off, k_off, kv_len);
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == 0 && od == 0) return fwd_typed<float, float>(q, k, v, out, lse, g, s);
  return (int)cudaErrorInvalidValue;  // the other pairs: flash_attention_tc.cu
}

int veles_flash_dq(int storage, int od, const void* q, const void* k,
                   const void* v, const void* dout, const float* lse,
                   const float* delta, void* dq, int B, int H, int Sq,
                   int Sk, int D, float scale, int causal, int q_off,
                   int k_off, int kv_len, void* stream) {
  const Geometry g = geometry(B, H, Sq, Sk, D, scale, causal, q_off, k_off, kv_len);
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == 0 && od == 0) return dq_typed<float, float>(q, k, v, dout, lse, delta, dq, g, s);
  return (int)cudaErrorInvalidValue;  // the other pairs: flash_attention_tc.cu
}

int veles_flash_dkv(int storage, int od, const void* q, const void* k,
                    const void* v, const void* dout, const float* lse,
                    const float* delta, void* dk, void* dv, int B, int H,
                    int Sq, int Sk, int D, float scale, int causal,
                    int q_off, int k_off, int kv_len, void* stream) {
  const Geometry g = geometry(B, H, Sq, Sk, D, scale, causal, q_off, k_off, kv_len);
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == 0 && od == 0) return dkv_typed<float, float>(q, k, v, dout, lse, delta, dk, dv, g, s);
  return (int)cudaErrorInvalidValue;  // the other pairs: flash_attention_tc.cu
}

const char* veles_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
