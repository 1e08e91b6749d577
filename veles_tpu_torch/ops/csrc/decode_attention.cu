// Split-K flash-decode attention for Hopper (sm_90a), float32 arithmetic.
//
// Replaces two TPU kernels of veles_tpu/ops/pallas_attention.py, both
// launched by `pallas_decode_attention`: at most 16 query rows per
// (batch, head) against a gathered key/value table, with an explicit
// per-row key mask.
//
//   B4 `_decode_kernel`: float32 keys and values.
//   B5 `_decode_kernel_quant`: keys and values stored as int8 or
//     float8_e4m3 codes with a float32 scale per (position, head); the
//     value is code · scale.  The codes are loaded at their stored width
//     (one byte) and dequantized in registers, so the kernel reads a
//     quarter of B4's bytes and never writes an f32 copy of the table.
//
// One template, `flash_decode<T, QUANT, ROWS>`, computes both.  A
// dequantized element is exactly the f32 product code · scale, rounded
// once, that `dequantize()` forms (int8 through the exact 2^23 + code
// float, e4m3 two codes at a time through the e4m3x2 -> f16x2
// conversion and exact widening), and everything after the load is B4's
// arithmetic, so B5 on (codes, scales) equals B4 on the dequantized
// table bit for bit.
//
// What bounds it on the H100.  A call reads the whole k/v table once
// (B·L·H·D·4 bytes each; B5 B·L·H·(D + 4)) and does 4·Sq·D float32
// operations per key and head: bytes at Sq = 1 (B4 0.040 ms, B5 0.0104
// ms at B = 8, L = 1024, H = 16, D = 128), the FP32 units for B5 at
// Sq = 16 (4·16·128 operations per 256 bytes of codes).  The design
// streams every k/v byte once with copies in flight while it computes,
// and keeps the multiply-adds fed from registers:
//
//   * One block of 256 threads per (batch·head, split of KEYS_PER_SPLIT
//     = 256 keys): 512 blocks at B·H = 128 and L = 1024, 2 (f32) or 4
//     (codes) resident per SM at Sq = 1.  The split's keys arrive as
//     tiles of TILE_KEYS = 64 rows in a ring of three shared-memory
//     stages (two for f32 past one row) filled by 16-byte `cp.async`
//     copies, neighbouring threads on neighbouring addresses: first the
//     key tiles, then the value tiles, so the value tiles load while
//     the scores and the softmax are computed.  A deeper ring measured
//     slower for codes: every block's first copies are requested at
//     once, and the first tile waits behind them all.  q and the
//     mask rows are loaded ahead of the ring's first copies.  A row
//     whose byte width is not a multiple of 16 (f32 rows at D % 4 != 0,
//     code rows at D % 16 != 0) or an unaligned table takes a scalar
//     copy into the same layout: the arithmetic from shared memory is
//     the same on both paths.
//   * Scores, key-parallel: four lanes own a key, lane j holds its
//     4-element chunks j, j + 4, ... and runs each row's dot product over
//     them in registers, q broadcast from shared memory; the four
//     partial sums meet in a fixed butterfly (no warp reduction per key
//     and row).  A one-row launch gives each lane group one key of a
//     tile; a multi-row launch gives it two keys for half the rows, so a
//     q chunk read feeds two keys.  Each score is the same sum either way.
//     The register tiles hold a power of two of rows at or above Sq
//     (1, 4, 8, 16), rows past Sq on zero queries, so the loops over
//     rows have no branch to hold the loads back.
//   * Softmax over the split: a warp per row, a fixed tree over the 256
//     slots (slots past the table or masked count as masked).
//   * p·V: lanes over d (a 4-element chunk each), warps over keys (warp
//     w takes keys 8w..8w+7 of every tile, in order); the eight warps'
//     partial sums meet in a fixed tree, warp w adding warp w + 4, then
//     w + 2, then w + 1.
//   * The merge is a second launch, `merge_pass`, one block per
//     (batch·head) with threads over (row, d), by logsumexp weights
//     exp(lse_j − lse_total) in split order — the merge the JAX package
//     leaves to XLA.  A table of one split writes its output directly.
//     A merge inside the kernel (the last block of a (b, h) to arrive,
//     found by an atomic counter, merging in split order) measured 11 µs
//     slower for B4's decode step on the H100 and under 1 µs faster for
//     B5's (PERF.md), so the second launch stays.
//
// Each query row is computed alone: its scores, softmax statistics,
// sums and merge never mix rows, split boundaries sit at fixed
// multiples of KEYS_PER_SPLIT from key 0, and every reduction tree is
// fixed.  So a row's result depends only on its q row, its mask row
// and the keys it attends: not on Sq (a one-row step equals the same
// row of a 16-row verify chunk), not on B, and not on L beyond its
// unmasked keys (a split wholly masked or past the table adds exact
// zeros).  Masking follows the TPU kernel: masked scores are NEG_INF =
// -1e30, masked probabilities are 0, l is floored at 1e-30, so a row
// with no key gets out = 0 and a finite lse.  Operands and sums are
// float32 with fused multiply-adds (no tensor cores, no TF32): serving
// promises f32 math, and only the order of the sums differs from the
// plain version.
//
// Layouts (all contiguous): q (B, Sq, H, D), k/v (B, L, H, D) of float,
// int8 or e4m3 codes, k_scale/v_scale (B, L, H) float (B5 only),
// mask (B, Sq, L) bytes (nonzero = attend), out (B, Sq, H, D);
// partials o_part (B, H, nsplit, Sq, D) and lse_part (B, H, nsplit, Sq).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int MAX_SQ = 16;
constexpr int MAX_D = 128;
constexpr int KEYS_PER_SPLIT = 256;
constexpr int TILE_KEYS = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Ring stages: f32 tiles are 32 KB (three stages for one row, two for
// more, whose row tiles take the shared memory), code tiles 9.5 KB.
template <typename T, int ROWS>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 4 && ROWS > 1 ? 2 : 3;
}

// 4-byte words per key row of a tile in shared memory: whole 16-byte
// chunks; code rows padded to ≡ 4 mod 8 words so that the eight keys a
// warp reads in the scores fall in distinct banks (f32 rows stay
// unpadded: a quarter-warp's two keys then share banks, a two-way
// conflict on one of the scores' loads, for a ring an eighth smaller).
__host__ __device__ inline int row_words(int D, int elem_bytes) {
  int w = (D * elem_bytes + 15) / 16 * 4;
  if (elem_bytes == 1 && w % 8 == 0) w += 4;
  return w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// Chunk c (elements 4c..4c+3) of a row in shared memory as floats: for
// B4 the stored values, for B5 each code's exact value times the
// position's scale, the product rounded once (__fmul_rn: never fused).
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static __device__ __forceinline__ float4 load(const unsigned char* row,
                                                int c, float) {
    return reinterpret_cast<const float4*>(row)[c];
  }
};

template <>
struct Chunk<int8_t> {
  // float(2^23 + (code + 128)) is exact; less 2^23 + 128 it is the code.
  static __device__ __forceinline__ float code(uint32_t biased, int e) {
    return __int_as_float(__byte_perm(biased, 0x4b000000u, 0x7440 + e)) -
           8388736.0f;
  }
  static __device__ __forceinline__ float4 load(const unsigned char* row,
                                                int c, float s) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[c] ^ 0x80808080u;
    return make_float4(__fmul_rn(code(w, 0), s), __fmul_rn(code(w, 1), s),
                       __fmul_rn(code(w, 2), s), __fmul_rn(code(w, 3), s));
  }
};

template <>
struct Chunk<__nv_fp8_e4m3> {
  // Two e4m3 codes to two halves in one conversion (every e4m3 value is
  // a half), then widened exactly.
  static __device__ __forceinline__ float2 pair(uint32_t bits) {
    const __half2_raw raw = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(bits), __NV_E4M3);
    return __half22float2(__half2(raw));
  }
  static __device__ __forceinline__ float4 load(const unsigned char* row,
                                                int c, float s) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[c];
    const float2 lo = pair(w & 0xffffu), hi = pair(w >> 16);
    return make_float4(__fmul_rn(lo.x, s), __fmul_rn(lo.y, s),
                       __fmul_rn(hi.x, s), __fmul_rn(hi.y, s));
  }
};

// A ring stage: a tile's rows, then (B5) its keys' scales.
template <typename T>
__host__ __device__ inline int stage_bytes(int D) {
  return TILE_KEYS * 4 * row_words(D, sizeof(T)) +
         (sizeof(T) == 1 ? TILE_KEYS * 4 : 0);
}

// The ring, the q rows, the scores and the mask rows; at least the p·V
// reduction's (WARPS/2, ROWS, D) floats, which reuse them at the end.
template <typename T, int ROWS>
size_t smem_bytes(int D) {
  const size_t qw = (D + 3) & ~3;
  const size_t all = stages<T, ROWS>() * (size_t)stage_bytes<T>(D) +
                     ROWS * qw * 4 + ROWS * KEYS_PER_SPLIT * 5;
  return std::max(all, (size_t)(WARPS / 2) * ROWS * qw * 4);
}

// QUANT: T is a code type and k_scale/v_scale hold the (B, L, H) scales;
// otherwise T is float and they are unused.  ROWS: the rows the
// register tiles hold, 1, 4, 8 or 16, the first at or above Sq: rows
// past Sq are computed on zero queries and dropped, so every loop over
// rows runs without a branch, and each row's arithmetic is the same
// whatever ROWS is.  `vec`: every k/v row is 16-byte aligned (the
// 16-byte cp.async path).
template <typename T, bool QUANT, int ROWS>
__global__ void __launch_bounds__(THREADS, ROWS > 8   ? 2
                                           : ROWS > 1 ? 3
                                           : sizeof(T) == 4 ? 3 : 4)
flash_decode(const float* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale,
             const unsigned char* __restrict__ mask,
             float* __restrict__ o_part, float* __restrict__ lse_part,
             float* __restrict__ out, int Sq,
             int L, int H, int D, int nsplit, float scale, int vec) {
  using Raw = std::conditional_t<sizeof(T) == 4, float, unsigned char>;
  constexpr int STAGES = stages<T, ROWS>();
  // 16-byte copies of one full tile per thread (vec path).
  constexpr int COPIES = TILE_KEYS * (MAX_D * (int)sizeof(T) / 16) / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float row_m[MAX_SQ], row_l[MAX_SQ];

  const int row_bytes = 4 * row_words(D, sizeof(T));
  const int stage = stage_bytes<T>(D);
  const int qw = (D + 3) & ~3;   // q row and chunked row length
  const int nchunk = qw / 4;
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + STAGES * stage);
  float* ps = qs + ROWS * qw;   // (ROWS, KEYS_PER_SPLIT): scores, then p
  unsigned char* ms =
      reinterpret_cast<unsigned char*>(ps + ROWS * KEYS_PER_SPLIT);

  const int bh = blockIdx.x / nsplit;
  const int split = blockIdx.x - bh * nsplit;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = split * KEYS_PER_SPLIT;
  const int nk = min(KEYS_PER_SPLIT, L - k0);
  const int ntile = (nk + TILE_KEYS - 1) / TILE_KEYS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // This thread's 16-byte copies of a tile, the same in every tile: the
  // key (high half) and the shared-memory offset (low half); the table
  // offset from the tile's first key follows from them.
  const int per_row = D * (int)sizeof(T) / 16;
  const int key_bytes = H * D * (int)sizeof(T);
  int copy_at[COPIES];
#pragma unroll
  for (int m = 0; m < COPIES; ++m) {
    const int x = tid + m * THREADS;
    const int kk = vec ? min(x / per_row, TILE_KEYS) : TILE_KEYS;
    copy_at[m] = kk << 16 | (kk < TILE_KEYS ? kk * row_bytes +
                                                  16 * (x - kk * per_row)
                                            : 0);
  }

  // Ring load i: key tile i for i < ntile, value tile i − ntile after;
  // one commit group each (empty past the last tile).
  auto issue = [&](int i) {
    if (i < 2 * ntile) {
      const bool is_v = i >= ntile;
      const int t = is_v ? i - ntile : i;
      const T* src = (is_v ? v : k) +
                     (((size_t)b * L + k0 + t * TILE_KEYS) * H + h) * D;
      unsigned char* dst = ring + (i % STAGES) * stage;
      const int keys = min(TILE_KEYS, nk - t * TILE_KEYS);
      if (vec) {
        const unsigned char* from = reinterpret_cast<const unsigned char*>(src);
#pragma unroll
        for (int m = 0; m < COPIES; ++m) {
          const int kk = copy_at[m] >> 16;
          const int at = copy_at[m] & 0xffff;
          if (kk < keys)
            cp_async16(dst + at, from + kk * key_bytes + (at - kk * row_bytes));
        }
      } else {
        const Raw* raw = reinterpret_cast<const Raw*>(src);
        for (int x = tid; x < keys * qw; x += THREADS) {
          const int kk = x / qw;
          const int d = x - kk * qw;
          reinterpret_cast<Raw*>(dst + kk * row_bytes)[d] =
              d < D ? raw[(size_t)kk * H * D + d] : Raw(0);
        }
      }
      if constexpr (QUANT) {
        const size_t at = ((size_t)b * L + k0 + t * TILE_KEYS) * H + h;
        float* dsc = reinterpret_cast<float*>(dst + TILE_KEYS * row_bytes);
        if (tid < keys)
          cp_async4(dsc + tid,
                    (is_v ? v_scale : k_scale) + at + (size_t)tid * H);
      }
    }
    cp_async_commit();
  };

  // q and the mask rows: loads issued ahead of the ring's first copies,
  // stored to shared memory after them.
  constexpr int QN = (ROWS * MAX_D + THREADS - 1) / THREADS;
  constexpr int MN = ROWS * KEYS_PER_SPLIT / THREADS;
  float qreg[QN];
  bool mreg[MN];
#pragma unroll
  for (int m = 0; m < QN; ++m) {
    const int x = tid + m * THREADS;
    const int r = x / qw;
    const int d = x - r * qw;
    qreg[m] = r < Sq && d < D
                  ? q[((size_t)(b * Sq + r) * H + h) * D + d] : 0.0f;
  }
#pragma unroll
  for (int m = 0; m < MN; ++m) {
    const int x = tid + m * THREADS;
    const int r = x / nk;
    mreg[m] = x < Sq * nk &&
              mask[(size_t)(b * Sq + r) * L + k0 + x - r * nk] != 0;
  }
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
#pragma unroll
  for (int m = 0; m < QN; ++m)
    if (tid + m * THREADS < ROWS * qw) qs[tid + m * THREADS] = qreg[m];
#pragma unroll
  for (int m = 0; m < MN; ++m) {
    const int x = tid + m * THREADS;
    const int r = x / nk;
    if (x < Sq * nk) ms[r * KEYS_PER_SPLIT + x - r * nk] = mreg[m];
  }

  // Scores, key-parallel: four lanes (j = 0..3) own a key, lane j holds
  // the key's chunks j, j + 4, ... and sums each row's products over them
  // in order; the four partial sums meet in a fixed butterfly.  A block
  // of one row gives each lane group one key of the tile and every lane
  // the row; otherwise a group owns keys g and g + 32 for half the rows
  // (every second row), so each q chunk read feeds two keys.
  constexpr int KEYS = ROWS == 1 ? 1 : 2;         // keys per lane group
  constexpr int RN = ROWS == 1 ? 1 : ROWS / 2;    // rows per thread
  const int j = tid & 3;
  const int g = ROWS == 1 ? tid >> 2 : (tid >> 2) & 31;
  const int r0 = ROWS == 1 ? 0 : tid >> 7;
  const int rstep = ROWS == 1 ? 1 : 2;
  for (int i = 0; i < ntile; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(i + STAGES - 1);
    const unsigned char* tile = ring + (i % STAGES) * stage;
    const float* tsc =
        reinterpret_cast<const float*>(tile + TILE_KEYS * row_bytes);
    float sum[KEYS][RN];
#pragma unroll
    for (int e = 0; e < KEYS; ++e)
#pragma unroll
      for (int n = 0; n < RN; ++n) sum[e][n] = 0.0f;
#pragma unroll
    for (int x = 0; x < MAX_D / 16; ++x) {
      const int c = j + 4 * x;
      if (c < nchunk) {
        float4 kv[KEYS];
#pragma unroll
        for (int e = 0; e < KEYS; ++e)
          kv[e] = Chunk<T>::load(tile + (g + 32 * e) * row_bytes, c,
                                 QUANT ? tsc[g + 32 * e] : 1.0f);
#pragma unroll
        for (int n = 0; n < RN; ++n) {
          const float4 qv = reinterpret_cast<const float4*>(
              qs + (r0 + rstep * n) * qw)[c];
#pragma unroll
          for (int e = 0; e < KEYS; ++e) {
            sum[e][n] = fmaf(qv.x, kv[e].x, sum[e][n]);
            sum[e][n] = fmaf(qv.y, kv[e].y, sum[e][n]);
            sum[e][n] = fmaf(qv.z, kv[e].z, sum[e][n]);
            sum[e][n] = fmaf(qv.w, kv[e].w, sum[e][n]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < KEYS; ++e) {
      const int ks = i * TILE_KEYS + g + 32 * e;
#pragma unroll
      for (int n = 0; n < RN; ++n) {
        const int r = r0 + rstep * n;
        float x = sum[e][n];
        x += __shfl_xor_sync(FULL, x, 1);
        x += __shfl_xor_sync(FULL, x, 2);
        if (r < Sq && ((n + e) & 3) == j)
          ps[r * KEYS_PER_SPLIT + ks] =
              ks < nk && ms[r * KEYS_PER_SPLIT + ks] ? x * scale : NEG_INF;
      }
    }
  }
  __syncthreads();

  // The split's softmax statistics: a warp per row, lane over slots
  // lane + 32·x; a slot past the table counts as masked.
  for (int r = warp; r < Sq; r += WARPS) {
    float* pr = ps + r * KEYS_PER_SPLIT;
    const unsigned char* mr = ms + r * KEYS_PER_SPLIT;
    float m = NEG_INF;
#pragma unroll
    for (int x = 0; x < KEYS_PER_SPLIT / 32; ++x) {
      const int kk = lane + 32 * x;
      if (kk < nk) m = fmaxf(m, pr[kk]);
    }
    m = warp_max(m);
    float l = 0.0f;
#pragma unroll
    for (int x = 0; x < KEYS_PER_SPLIT / 32; ++x) {
      const int kk = lane + 32 * x;
      const float p = kk < nk && mr[kk] ? expf(pr[kk] - m) : 0.0f;
      pr[kk] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      row_m[r] = m;
      row_l[r] = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();

  // p·V: lane over chunk `lane` of d, warp over keys 8·warp..8·warp+7 of
  // each value tile, in order, four at a time.
  float acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  for (int t = 0; t < ntile; ++t) {
    const int i = ntile + t;
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(i + STAGES - 1);
    const unsigned char* tile = ring + (i % STAGES) * stage;
    const float* tsc =
        reinterpret_cast<const float*>(tile + TILE_KEYS * row_bytes);
    if (lane < nchunk) {
#pragma unroll
      for (int quad = 0; quad < 2; ++quad) {
        const int kk0 = 8 * warp + 4 * quad;
        const int ks0 = t * TILE_KEYS + kk0;
        const int nq = min(4, nk - ks0);
        if (nq > 0) {
          float4 vv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vv[e] = e < nq ? Chunk<T>::load(tile + (kk0 + e) * row_bytes,
                                            lane, QUANT ? tsc[kk0 + e] : 1.0f)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                ps + r * KEYS_PER_SPLIT + ks0);
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (e < nq) {
                acc[r][0] = fmaf(p[e], vv[e].x, acc[r][0]);
                acc[r][1] = fmaf(p[e], vv[e].y, acc[r][1]);
                acc[r][2] = fmaf(p[e], vv[e].z, acc[r][2]);
                acc[r][3] = fmaf(p[e], vv[e].w, acc[r][3]);
              }
            }
          }
        }
      }
    }
  }

  // The warps' partial sums in a fixed tree, in the drained ring and the
  // rows after it (dead by now): warp w adds warp w + half's, half =
  // WARPS/2, ..., 1; warp 0 ends with all.
  cp_async_wait<0>();
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(ring);   // (WARPS/2, ROWS, nchunk)
  const bool active = lane < nchunk;
#pragma unroll
  for (int half = WARPS / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half && active)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        red[((warp - half) * ROWS + r) * nchunk + lane] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
    if (warp < half && active)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 o = red[(warp * ROWS + r) * nchunk + lane];
        acc[r][0] += o.x;
        acc[r][1] += o.y;
        acc[r][2] += o.z;
        acc[r][3] += o.w;
      }
    __syncthreads();
  }
  if (warp == 0 && active) {
    // One split: its normalized sum is the output (the merge's weight
    // is exactly 1).  Otherwise the split's partial.
    float* dst = nsplit == 1 ? nullptr
                             : o_part + ((size_t)bh * nsplit + split) * Sq * D;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < Sq) {
        float* orow = dst ? dst + (size_t)r * D
                          : out + ((size_t)(b * Sq + r) * H + h) * D;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * lane + e < D) orow[4 * lane + e] = acc[r][e] / row_l[r];
      }
    }
  }
  if (nsplit == 1) return;
  if (tid < Sq)
    lse_part[((size_t)bh * nsplit + split) * Sq + tid] =
        row_m[tid] + logf(row_l[tid]);
}

// The merge of a launch of more than one split: one block per
// (batch·head), threads over (row, d), the splits by logsumexp weights
// exp(lse_j − lse_total) in split order.
__global__ void __launch_bounds__(THREADS)
merge_pass(const float* __restrict__ o_part,
           const float* __restrict__ lse_part, float* __restrict__ out,
           int Sq, int H, int D, int nsplit) {
  __shared__ float row_total[MAX_SQ];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const float* lse = lse_part + (size_t)bh * nsplit * Sq;
  const float* part = o_part + (size_t)bh * nsplit * Sq * D;
  const int tid = threadIdx.x;
  if (tid < Sq) {
    float top = NEG_INF;
    for (int s = 0; s < nsplit; ++s) top = fmaxf(top, lse[s * Sq + tid]);
    float sum = 0.0f;
    for (int s = 0; s < nsplit; ++s) sum += expf(lse[s * Sq + tid] - top);
    row_total[tid] = top + logf(sum);
  }
  __syncthreads();
  for (int x = tid; x < Sq * D; x += THREADS) {
    const int r = x / D;
    const int d = x - r * D;
    float o = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(lse[s * Sq + r] - row_total[r]);
      o = fmaf(part[((size_t)s * Sq + r) * D + d], w, o);
    }
    out[((size_t)(b * Sq + r) * H + h) * D + d] = o;
  }
}

// Allows the kernel the largest dynamic shared memory of any of its
// shapes, once per device (so a launch inside a CUDA graph capture makes
// no such call).
template <typename T, bool QUANT, int ROWS>
cudaError_t configure() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done.load() >> (dev & 63) & 1)) return err;
  err = cudaFuncSetAttribute(flash_decode<T, QUANT, ROWS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<T, ROWS>(MAX_D));
  if (err == cudaSuccess) done.fetch_or(1ull << (dev & 63));
  return err;
}

template <typename T, bool QUANT>
int launch(const float* q, const T* k, const T* v, const float* k_scale,
           const float* v_scale, const unsigned char* mask, float* o_part,
           float* lse_part, float* out, int B, int Sq, int L,
           int H, int D, float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sq > MAX_SQ || L < 1 || D < 1 ||
      D > MAX_D)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (L + KEYS_PER_SPLIT - 1) / KEYS_PER_SPLIT;
  const int vec = (D * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = Sq == 1 ? 1 : Sq <= 4 ? 4 : Sq <= 8 ? 8 : MAX_SQ;
  const cudaError_t configured =
      rows == 1   ? configure<T, QUANT, 1>()
      : rows == 4 ? configure<T, QUANT, 4>()
      : rows == 8 ? configure<T, QUANT, 8>()
                  : configure<T, QUANT, MAX_SQ>();
  if (configured != cudaSuccess) return (int)configured;
  auto kernel = rows == 1   ? flash_decode<T, QUANT, 1>
                : rows == 4 ? flash_decode<T, QUANT, 4>
                : rows == 8 ? flash_decode<T, QUANT, 8>
                            : flash_decode<T, QUANT, MAX_SQ>;
  const size_t smem = rows == 1   ? smem_bytes<T, 1>(D)
                      : rows == 4 ? smem_bytes<T, 4>(D)
                      : rows == 8 ? smem_bytes<T, 8>(D)
                                  : smem_bytes<T, MAX_SQ>(D);
  kernel<<<B * H * nsplit, THREADS, smem, s>>>(
      q, k, v, k_scale, v_scale, mask, o_part, lse_part, out, Sq,
      L, H, D, nsplit, scale, vec);
  if (nsplit > 1 && cudaPeekAtLastError() == cudaSuccess)
    merge_pass<<<B * H, THREADS, 0, s>>>(o_part, lse_part, out, Sq, H, D,
                                         nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry the kernel takes; the Python wrapper checks against these.
int veles_decode_max_sq() { return MAX_SQ; }
int veles_decode_max_d() { return MAX_D; }
int veles_decode_keys_per_split() { return KEYS_PER_SPLIT; }

// Launches the kernel (and, past one split, the merge) on `stream` and
// returns the launch error (cudaGetLastError), or 0.  Allocates nothing:
// the caller passes the partial buffers, sized (B·H·nsplit·Sq·D) and
// (B·H·nsplit·Sq) floats with nsplit = ceil(L / KEYS_PER_SPLIT) (unused
// when nsplit is 1).
int veles_decode_attention(const float* q, const float* k, const float* v,
                           const unsigned char* mask, float* o_part,
                           float* lse_part, float* out,
                           int B, int Sq, int L, int H, int D, float scale,
                           void* stream) {
  return launch<float, false>(q, k, v, nullptr, nullptr, mask, o_part,
                              lse_part, out, B, Sq, L, H, D,
                              scale, stream);
}

// B5: k/v are int8 (code_kind 0) or float8_e4m3 (code_kind 1) codes,
// k_scale/v_scale their (B, L, H) float scales; otherwise as above.
int veles_decode_attention_quant(const float* q, const void* k,
                                 const void* v, const float* k_scale,
                                 const float* v_scale,
                                 const unsigned char* mask, float* o_part,
                                 float* lse_part, float* out,
                                 int B, int Sq, int L, int H, int D,
                                 float scale, int code_kind, void* stream) {
  if (code_kind == 0)
    return launch<int8_t, true>(
        q, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        k_scale, v_scale, mask, o_part, lse_part, out, B, Sq, L,
        H, D, scale, stream);
  if (code_kind == 1)
    return launch<__nv_fp8_e4m3, true>(
        q, static_cast<const __nv_fp8_e4m3*>(k),
        static_cast<const __nv_fp8_e4m3*>(v), k_scale, v_scale, mask,
        o_part, lse_part, out, B, Sq, L, H, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}

const char* veles_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
