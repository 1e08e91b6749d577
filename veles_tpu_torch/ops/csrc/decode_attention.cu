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
//     Each dequantized element is exactly the f32 product code · scale
//     that the plain version forms, and everything after the load is
//     B4's arithmetic: B5 on (codes, scales) equals B4 on the
//     dequantized table bit for bit.
//
// What bounds it on the H100: bytes.  A decode step reads the whole
// k/v table once (B·L·H·D·4 bytes each, B·L·H·D·1 + B·L·H·4 for B5)
// and does 4·Sq·D operations per key, far below the ~20 float32
// operations per byte at which the FP32 units would become the limit
// (B5: ~5 per byte at Sq = 1, still below).  So the design keeps every
// k/v byte to one read from device memory:
//
//   pass 1 (`decode_partial`): one block per (batch·head, key split of
//     KEYS_PER_SPLIT keys).  The (Sq, D) queries sit in shared memory.
//     Each warp takes one key at a time and reads its D values with
//     neighbouring lanes on neighbouring addresses; the Sq scores are
//     warp-reduced.  The block then forms the split's masked softmax
//     (max m, exp, sum l) and the partial output p·V/l, reading each
//     value row once with one thread per head-dim element.  It writes
//     the split's partial out (Sq, D) and lse = m + log(l).
//   pass 2 (`decode_merge`): one block per (batch·head) merges the
//     splits by logsumexp weights exp(lse_j − lse_total) — the merge
//     the JAX package leaves to XLA after the Pallas call.
//
// The grid of pass 1 is (B·H, ceil(L / KEYS_PER_SPLIT)), so the 132 SMs
// fill at the serving shapes (B·H = 128 and up to 16 splits).  Masking
// follows the TPU kernel exactly: masked scores are NEG_INF = -1e30,
// masked probabilities are 0, l is floored at 1e-30, so a row with no
// key in a split contributes weight 0, and a row with no key at all
// gets out = 0 and a finite lse.  Operands and sums are float32 with
// fused multiply-adds (no tensor cores, no TF32): serving promises f32
// math, and only the order of the sums differs from the plain version.
//
// Every query row is computed the same way whatever Sq is (its scores,
// softmax statistics, sums and merge never mix rows), so a row of a
// 16-row verify chunk equals the same row launched alone, bit for bit.
//
// Layouts (all contiguous): q (B, Sq, H, D), k/v (B, L, H, D) of float,
// int8 or e4m3 codes, k_scale/v_scale (B, L, H) float (B5 only),
// mask (B, Sq, L) bytes (nonzero = attend), out (B, Sq, H, D);
// partials o_part (B, H, nsplit, Sq, D) and lse_part (B, H, nsplit, Sq).

#include <cstdint>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SQ = 16;
constexpr int MAX_D = 128;
constexpr int KEYS_PER_SPLIT = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

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

// A stored element as float: the identity for B4, the exact value of
// an int8 or e4m3 code for B5 (cuda_fp8.h's conversion; every e4m3
// value is a float).
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// QUANT: T is a code type and k_scale/v_scale hold the (B, L, H) scales;
// otherwise T is float and they are unused.
template <typename T, bool QUANT>
__global__ void __launch_bounds__(THREADS)
decode_partial(const float* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v,
               const float* __restrict__ k_scale,
               const float* __restrict__ v_scale,
               const unsigned char* __restrict__ mask,
               float* __restrict__ o_part, float* __restrict__ lse_part,
               int Sq, int L, int H, int D, int nsplit, float scale) {
  __shared__ float qs[MAX_SQ][MAX_D];
  __shared__ float ps[MAX_SQ][KEYS_PER_SPLIT];
  __shared__ unsigned char ms[MAX_SQ][KEYS_PER_SPLIT];
  __shared__ float row_m[MAX_SQ];
  __shared__ float row_l[MAX_SQ];
  __shared__ float ksc[QUANT ? KEYS_PER_SPLIT : 1];
  __shared__ float vsc[QUANT ? KEYS_PER_SPLIT : 1];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int split = blockIdx.y;
  const int k0 = split * KEYS_PER_SPLIT;
  const int nk = min(KEYS_PER_SPLIT, L - k0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < Sq * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    qs[r][d] = q[((size_t)(b * Sq + r) * H + h) * D + d];
  }
  for (int i = threadIdx.x; i < Sq * nk; i += THREADS) {
    const int r = i / nk;
    const int kk = i - r * nk;
    ms[r][kk] = mask[(size_t)(b * Sq + r) * L + k0 + kk] != 0;
  }
  if constexpr (QUANT) {
    for (int kk = threadIdx.x; kk < nk; kk += THREADS) {
      const size_t at = (size_t)(b * L + k0 + kk) * H + h;
      ksc[kk] = k_scale[at];
      vsc[kk] = v_scale[at];
    }
  }
  __syncthreads();

  // Scores: one warp per key, lanes over the head dim (lane + 32·j).
  for (int kk = warp; kk < nk; kk += WARPS) {
    const T* krow = k + ((size_t)(b * L + k0 + kk) * H + h) * D;
    float kv[MAX_D / 32];
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j) {
      const int d = lane + 32 * j;
      if constexpr (QUANT)
        kv[j] = d < D ? to_float(krow[d]) * ksc[kk] : 0.0f;
      else
        kv[j] = d < D ? krow[d] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < MAX_SQ; ++r) {
      if (r >= Sq) break;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < MAX_D / 32; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc = fmaf(qs[r][d], kv[j], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) ps[r][kk] = ms[r][kk] ? acc * scale : NEG_INF;
    }
  }
  __syncthreads();

  // The split's softmax statistics: one warp per query row.
  for (int r = warp; r < Sq; r += WARPS) {
    float m = NEG_INF;
    for (int kk = lane; kk < nk; kk += 32) m = fmaxf(m, ps[r][kk]);
    m = warp_max(m);
    float l = 0.0f;
    for (int kk = lane; kk < nk; kk += 32) {
      const float p = ms[r][kk] ? expf(ps[r][kk] - m) : 0.0f;
      ps[r][kk] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      row_m[r] = m;
      row_l[r] = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();

  // Partial output p·V / l: one thread per head-dim element.
  const int d = threadIdx.x;
  float acc[MAX_SQ];
#pragma unroll
  for (int r = 0; r < MAX_SQ; ++r) acc[r] = 0.0f;
  if (d < D) {
    for (int kk = 0; kk < nk; ++kk) {
      float vv;
      if constexpr (QUANT)
        vv = to_float(v[((size_t)(b * L + k0 + kk) * H + h) * D + d]) *
             vsc[kk];
      else
        vv = v[((size_t)(b * L + k0 + kk) * H + h) * D + d];
#pragma unroll
      for (int r = 0; r < MAX_SQ; ++r)
        if (r < Sq) acc[r] = fmaf(ps[r][kk], vv, acc[r]);
    }
    const size_t base = ((size_t)bh * nsplit + split) * Sq;
#pragma unroll
    for (int r = 0; r < MAX_SQ; ++r)
      if (r < Sq) o_part[(base + r) * D + d] = acc[r] / row_l[r];
  }
  if (threadIdx.x < Sq) {
    const int r = threadIdx.x;
    lse_part[((size_t)bh * nsplit + split) * Sq + r] =
        row_m[r] + logf(row_l[r]);
  }
}

__global__ void __launch_bounds__(THREADS)
decode_merge(const float* __restrict__ o_part,
             const float* __restrict__ lse_part, float* __restrict__ out,
             int Sq, int H, int D, int nsplit) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int d = threadIdx.x;
  if (d >= D) return;
  for (int r = 0; r < Sq; ++r) {
    const float* lse = lse_part + (size_t)bh * nsplit * Sq + r;
    float top = NEG_INF;
    for (int j = 0; j < nsplit; ++j) top = fmaxf(top, lse[(size_t)j * Sq]);
    float sum = 0.0f;
    for (int j = 0; j < nsplit; ++j) sum += expf(lse[(size_t)j * Sq] - top);
    const float total = top + logf(sum);
    float acc = 0.0f;
    for (int j = 0; j < nsplit; ++j) {
      const float w = expf(lse[(size_t)j * Sq] - total);
      acc = fmaf(o_part[(((size_t)bh * nsplit + j) * Sq + r) * D + d], w,
                 acc);
    }
    out[((size_t)(b * Sq + r) * H + h) * D + d] = acc;
  }
}

template <typename T, bool QUANT>
int launch(const float* q, const T* k, const T* v, const float* k_scale,
           const float* v_scale, const unsigned char* mask, float* o_part,
           float* lse_part, float* out, int B, int Sq, int L, int H, int D,
           float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sq > MAX_SQ || L < 1 || D < 1 ||
      D > MAX_D)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (L + KEYS_PER_SPLIT - 1) / KEYS_PER_SPLIT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_partial<T, QUANT><<<dim3(B * H, nsplit), THREADS, 0, s>>>(
      q, k, v, k_scale, v_scale, mask, o_part, lse_part, Sq, L, H, D,
      nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge<<<B * H, THREADS, 0, s>>>(o_part, lse_part, out, Sq, H, D,
                                         nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry the kernels take; the Python wrapper checks against these.
int veles_decode_max_sq() { return MAX_SQ; }
int veles_decode_max_d() { return MAX_D; }
int veles_decode_keys_per_split() { return KEYS_PER_SPLIT; }

// Launches both passes on `stream` and returns the first launch error
// (cudaGetLastError after each launch), or 0.  Allocates nothing: the
// caller passes the partial buffers, sized (B·H·nsplit·Sq·D) and
// (B·H·nsplit·Sq) floats with nsplit = ceil(L / KEYS_PER_SPLIT).
int veles_decode_attention(const float* q, const float* k, const float* v,
                           const unsigned char* mask, float* o_part,
                           float* lse_part, float* out, int B, int Sq,
                           int L, int H, int D, float scale,
                           void* stream) {
  return launch<float, false>(q, k, v, nullptr, nullptr, mask, o_part,
                              lse_part, out, B, Sq, L, H, D, scale,
                              stream);
}

// B5: k/v are int8 (code_kind 0) or float8_e4m3 (code_kind 1) codes,
// k_scale/v_scale their (B, L, H) float scales; otherwise as above.
int veles_decode_attention_quant(const float* q, const void* k,
                                 const void* v, const float* k_scale,
                                 const float* v_scale,
                                 const unsigned char* mask, float* o_part,
                                 float* lse_part, float* out, int B,
                                 int Sq, int L, int H, int D, float scale,
                                 int code_kind, void* stream) {
  if (code_kind == 0)
    return launch<int8_t, true>(
        q, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        k_scale, v_scale, mask, o_part, lse_part, out, B, Sq, L, H, D,
        scale, stream);
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
