// Flash-attention forward (B1), dq (B2) and dk/dv (B3) on Hopper's tensor
// cores (sm_90a).
//
// Replaces, for every storage/operand pair whose q, k, v and dO are
// bf16-exact (bf16 storage with f32 or bf16 operands, f32 storage with
// bf16 operands), the TPU kernels of veles_tpu/ops/pallas_attention.py:
//   `_fwd_kernel` (B1)  -> fwd_tc
//   `_dq_kernel`  (B2)  -> dq_tc
//   `_dkv_kernel` (B3)  -> dkv_tc
// with `flash_chunk`'s contract, as flash_attention.cu's FP32 kernels
// (which keep f32 storage with f32 operands): q (B, Sq, H, D)
// against k/v (B, Sk, H, D), causal on GLOBAL positions, an optional
// bound on LOCAL key columns, any Sq/Sk (ragged tails masked), any
// D <= 128 (zero-padded in shared memory), B·H <= 65535; key tiles that
// every row of a query tile is masked from are skipped (and query tiles
// hidden from every key of a key tile).
//
// Numerics are the TPU kernel's: scale = 1/sqrt(D) applied to the f32
// score after the product, masked scores NEG_INF = -1e30, p re-masked to
// exactly 0, l floored at 1e-30, lse in f32; p = exp(s·scale − lse) and
// ds = p·(dp − delta)·scale in the backward; p and ds rounded to the
// operand type OD before their products.  Every product runs on the
// bf16 tensor cores with f32 accumulation:
//   * q·kᵀ and dO·vᵀ multiply bf16 values (the storage, or f32 storage
//     rounded to bf16 on load, as `_dot` casts) — exact in f32;
//   * p·v, pᵀ·dO, ds·k and dsᵀ·q: with bf16 operands p (ds) is rounded to bf16,
//     the TPU's `p.astype(od)`; with f32 operands p (ds) is split into
//     three bf16 terms hi = bf16(x), mid = bf16(x − hi),
//     lo = bf16(x − hi − mid), which cover all 24 significand bits, and
//     each term's product with a bf16 value is exact in f32: three
//     tensor-core products into one f32 accumulator.  Only the order of
//     the sums differs from the TPU kernel.
//
// What bounds it on the H100: operations.  At the LM training shape
// (B=8, S=1024, H=16, D=128, causal, bf16 storage, f32 operands) the
// forward does (1 + 3) x 17.2 GFLOP of bf16 tensor-core products on
// ~0.13 GB, ~530 operations per byte, above the ~295 at which 989
// TFLOP/s against 3.35 TB/s makes the tensor cores the limit.  The
// kernels of flash_attention.cu run every product on the FP32 units,
// reading shared memory for every multiply-add; here:
//   * `wgmma` m64nNk16 (bf16 -> f32) for every product: S = q·kᵀ
//     (dq: and dP = dO·vᵀ; dk/dv: Sᵀ = k·qᵀ and dPᵀ = v·dOᵀ, keys as the
//     M side) with both operands in shared memory; P·V, dS·K, Pᵀ·dO and
//     dSᵀ·q with P (dS) taken straight from the score accumulator's
//     registers as the A operand (the accumulator's fragment layout is
//     the A fragment layout), the other operand MN-major in shared
//     memory;
//   * tiles in shared memory in the 128-byte swizzled layout that `wgmma`
//     reads without bank conflicts: 64 rows x 128 head-dim columns as
//     two blocks of 64 columns (128 bytes a row);
//   * k/v (dk/dv: q/dO, with lse/delta) tiles in a two-stage ring: the
//     next tile is requested before the current one's products finish.
//     bf16 storage with rows that are a multiple of 16 bytes (D % 8 == 0)
//     loads by TMA (one thread, a 4-D tensor map over (D, H, S, B) with
//     128-byte swizzle, out-of-bounds rows and columns filled with zero)
//     completing on an mbarrier; otherwise (f32 storage, which must be
//     rounded to bf16 on the way, or a row TMA cannot address) the
//     threads load, round and store the tile themselves;
//   * forward: one warpgroup (128 threads) per query tile of 64 rows,
//     key tiles of 64; the online softmax (m, l) lives in registers, the
//     row reductions are two quad shuffles; the query tiles start longest
//     first;
//   * dq: as the forward without the online softmax: one warpgroup per
//     query tile, the q and dO tiles loaded once, lse and delta of the
//     thread's rows in registers; per key tile S and dP (two products
//     into two accumulators of one fragment layout), dS elementwise in
//     place of S, then dq += dS·k with k read MN-major from the same
//     shared-memory tile that S read K-major; the 64 x 128 f32 dq
//     accumulator stays in registers;
//   * dk/dv: one CTA per key tile of 64 keys with two warpgroups: the
//     first accumulates dv (Sᵀ, P, Pᵀ·dO), the second dk (Sᵀ, dPᵀ, dS,
//     dSᵀ·q); each keeps one 64 x 128 f32 accumulator in registers, so
//     there are no atomics and no spills, at the cost of computing Sᵀ
//     and dPᵀ in both (both run the same products, which keeps ptxas
//     from serializing the wgmmas of a warpgroup-divergent path).
// A waiting mbarrier traps after 4 s instead of hanging the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int BQ = 64;                  // query rows per tile
constexpr int BK = 64;                  // keys per tile
constexpr int MAX_D = 128;              // largest head dim
constexpr int BLOCK_BYTES = 64 * 128;   // one 64-column block of a tile
constexpr int TILE_BYTES = 2 * BLOCK_BYTES;  // 64 rows x 128 bf16 columns
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

struct Geometry {
  int B, H, Sq, Sk, D;
  float scale;
  int causal, q_off, k_off, kv_len;

  // Whether local query row `row` attends local key `col` (`_mask_tile`).
  __device__ __forceinline__ bool attend(int row, int col) const {
    if (row >= Sq || col >= Sk) return false;
    if (causal && q_off + row < k_off + col) return false;
    if (kv_len >= 0 && col >= kv_len) return false;
    return true;
  }

  // Key tiles [0, n) that can hold a key some row of the query tile
  // starting at q0 attends.
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

// The tensor maps of the TMA route (unused by the other).
struct Maps {
  CUtensorMap a, b, c, d;
};

// -- shared memory, barriers, TMA -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the swizzle repeats every
// 1024 bytes of shared address).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Byte offset of 16-byte chunk `chunk` (columns 8·chunk .. 8·chunk + 7)
// of row r in a swizzled tile: block chunk / 8, the chunk index within
// the 128-byte row XORed with r % 8 (TMA's 128-byte swizzle).
__device__ __forceinline__ int swizzled(int r, int chunk) {
  return (chunk >> 3) * BLOCK_BYTES + r * 128 + (((chunk & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return reinterpret_cast<uint32_t&>(v);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the completion of the barrier's phase of parity `parity`;
// traps after 4 s (a lost transfer faults the launch, not the card).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t spin = 1;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023u) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  }
}

// One TMA box: 64 rows (s0 ..) x 64 columns (d0 ..) of head h, batch b.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int d0, int h, int s0,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(h), "r"(s0), "r"(b)
      : "memory");
}

// Requests rows [r0, r0 + 64) of (b, h) into a swizzled tile; the
// barrier must expect TILE_BYTES for it.
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int r0, int b, int h) {
  tma_box(dst, map, bar, 0, h, r0, b);
  tma_box(dst + BLOCK_BYTES, map, bar, 64, h, r0, b);
}

// Loads rows [r0, r0 + 64) of (b, h) of a (B, S, H, D) tensor into a
// swizzled tile by the threads [tid, nthreads), rounded to bf16, zero past
// S and D; then makes the stores visible to the tensor cores' proxy.
template <typename T>
__device__ __forceinline__ void thread_tile(uint8_t* dst, const T* src, int r0,
                                            int S, int H, int D, int b, int h,
                                            int tid, int nthreads) {
  for (int i = tid; i < 64 * 16; i += nthreads) {
    const int r = i >> 4;
    const int chunk = i & 15;
    const int gr = r0 + r;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = chunk * 8 + 2 * j;
      float x0 = 0.0f, x1 = 0.0f;
      if (gr < S) {
        const T* row = src + (((size_t)b * S + gr) * H + h) * D;
        if (c < D) x0 = to_f<T>(row[c]);
        if (c + 1 < D) x1 = to_f<T>(row[c + 1]);
      }
      w[j] = pack_bf16(x0, x1);
    }
    *reinterpret_cast<uint4*>(dst + swizzled(r, chunk)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma ------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_bits(uint32_t x) {
  return (uint64_t)((x & 0x3FFFFu) >> 4);
}

// Descriptor of a K-major operand at shared address `addr` in a swizzled
// tile: rows of 128 bytes, 8-row groups 1024 bytes apart (the leading
// offset is unused under the 128-byte swizzle).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc_bits(addr) | (desc_bits(16) << 16) | (desc_bits(1024) << 32) |
         (1ull << 62);
}

// Descriptor of an MN-major operand (rows along K, the N columns
// contiguous): the two 64-column blocks BLOCK_BYTES apart, 8-row groups of
// K 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc_bits(addr) | (desc_bits(BLOCK_BYTES) << 16) |
         (desc_bits(1024) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving register accesses across a wgmma fence
// or wait.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][j][e])::"memory");
}

// D (64 x 64, f32) = A·B (+ D when accumulate): A and B K-major bf16
// tiles in shared memory, given by their descriptors.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 128, f32) += A·B: A (64 x 16 bf16) from registers in the
// accumulator's fragment layout, B MN-major in shared memory (transposed).
__device__ __forceinline__ void mma_rs_n128_t(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Accumulator fragments (m64nN, f32): thread t of the warpgroup holds
// rows 16·(t / 32) + (t % 32) / 4 (+ 8) and, for i < N / 8, columns
// 8i + 2·(t % 4) (+ 1): d[4i + 0..1] the first row, d[4i + 2..3] the
// second.  The A operand of an m64nNk16 product from registers has the
// same layout for its 16 columns, so the 64-column score tile's
// columns 16j .. 16j + 15 are d[8j .. 8j + 7].

// Terms of a product's A operand with an operand type OD: one bf16 term
// (OD = bf16: the TPU's `astype`) or three (OD = f32: hi, mid, lo).
template <typename OD>
struct Terms {
  static constexpr int N = 1;
};
template <>
struct Terms<float> {
  static constexpr int N = 3;
};

// The A fragments of a 64 x 64 f32 tile held as accumulator registers
// x[32]: frag[term][j] is k-step j (columns 16j .. 16j + 15).
template <int NT>
__device__ __forceinline__ void a_fragments(const float (&x)[32],
                                            uint32_t (&frag)[NT][4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // e: 0 = (row, cols 16j + ..), 1 = (row + 8, ..), 2 = (row, cols
      // 16j + 8 + ..), 3 = (row + 8, 16j + 8 + ..).
      const int at = (2 * j + (e >> 1)) * 4 + (e & 1) * 2;
      float x0 = x[at], x1 = x[at + 1];
      __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      frag[0][j][e] = reinterpret_cast<uint32_t&>(hi);
      if constexpr (NT == 3) {
        x0 -= __low2float(hi);
        x1 -= __high2float(hi);
        __nv_bfloat162 mid = __floats2bfloat162_rn(x0, x1);
        frag[1][j][e] = reinterpret_cast<uint32_t&>(mid);
        x0 -= __low2float(mid);
        x1 -= __high2float(mid);
        __nv_bfloat162 lo = __floats2bfloat162_rn(x0, x1);
        frag[2][j][e] = reinterpret_cast<uint32_t&>(lo);
      }
    }
}

// acc (64 x 128) += A·B over 64 rows of K: A the fragments of a 64 x 64
// tile (every term), B the MN-major swizzled tile at shared address b.
template <int NT>
__device__ __forceinline__ void mma_terms(float (&acc)[64],
                                          const uint32_t (&frag)[NT][4][4],
                                          uint32_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_rs_n128_t(acc, frag[t][j], desc_mn(b + j * 2048));
}

// acc (64 x 64) = A·Bᵀ over the head dim: A and B swizzled K-major tiles
// at shared addresses a and b, ksteps = ceil(D / 16) steps of 16.
__device__ __forceinline__ void mma_head_dim(float (&acc)[32], uint32_t a,
                                             uint32_t b, int ksteps) {
  for (int j = 0; j < ksteps; ++j) {
    const uint32_t off = (j >> 2) * BLOCK_BYTES + (j & 3) * 32;
    mma_ss_n64(acc, desc_k(a + off), desc_k(b + off), j > 0);
  }
}

// -- B1: forward ------------------------------------------------------------

constexpr size_t FWD_SMEM = 5 * TILE_BYTES + 64 + 1024;

template <typename T, typename OD, bool TMA>
__global__ void __launch_bounds__(128)
fwd_tc(const __grid_constant__ Maps maps, const T* __restrict__ q,
       const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
       float* __restrict__ lse, Geometry g) {
  constexpr int NT = Terms<OD>::N;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ks = qs + TILE_BYTES;      // two stages
  uint8_t* vs = ks + 2 * TILE_BYTES;  // two stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * TILE_BYTES);
  uint64_t* q_bar = bars;
  uint64_t* k_bar = bars + 1;  // [2]
  uint64_t* v_bar = bars + 3;  // [2]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int r0 = q0 + (tid >> 5) * 16 + (lane >> 2);  // rows r0, r0 + 8
  const int cq = (lane & 3) * 2;
  const int D = g.D;
  const int ksteps = (D + 15) >> 4;
  const int nk = g.key_tiles(q0);

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  if (nk > 0) {
    if (TMA) {
      if (tid == 0) {
        for (int i = 0; i < 5; ++i) mbar_init(bars + i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();
      if (tid == 0) {
        mbar_expect(q_bar, TILE_BYTES);
        tma_tile(qs, &maps.a, q_bar, q0, b, h);
        mbar_expect(k_bar, TILE_BYTES);
        tma_tile(ks, &maps.b, k_bar, 0, b, h);
        mbar_expect(v_bar, TILE_BYTES);
        tma_tile(vs, &maps.c, v_bar, 0, b, h);
      }
      mbar_wait(q_bar, 0);
    } else {
      thread_tile<T>(qs, q, q0, g.Sq, g.H, D, b, h, tid, 128);
      thread_tile<T>(ks, k, 0, g.Sk, g.H, D, b, h, tid, 128);
      thread_tile<T>(vs, v, 0, g.Sk, g.H, D, b, h, tid, 128);
      __syncthreads();
    }
    for (int t = 0; t < nk; ++t) {
      const int st = t & 1;
      const int c0 = t * BK;
      uint8_t* kt = ks + st * TILE_BYTES;
      uint8_t* vt = vs + st * TILE_BYTES;
      if (TMA) mbar_wait(k_bar + st, (t >> 1) & 1);
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      hold(s);
      wg_fence();
      mma_head_dim(s, smem_u32(qs), smem_u32(kt), ksteps);
      wg_commit();
      if (t + 1 < nk) {  // the next tile into the other stage
        uint8_t* kn = ks + (st ^ 1) * TILE_BYTES;
        uint8_t* vn = vs + (st ^ 1) * TILE_BYTES;
        if (TMA) {
          if (tid == 0) {
            mbar_expect(k_bar + (st ^ 1), TILE_BYTES);
            tma_tile(kn, &maps.b, k_bar + (st ^ 1), c0 + BK, b, h);
            mbar_expect(v_bar + (st ^ 1), TILE_BYTES);
            tma_tile(vn, &maps.c, v_bar + (st ^ 1), c0 + BK, b, h);
          }
        } else {
          thread_tile<T>(kn, k, c0 + BK, g.Sk, g.H, D, b, h, tid, 128);
          thread_tile<T>(vn, v, c0 + BK, g.Sk, g.H, D, b, h, tid, 128);
        }
      }
      wg_wait();
      hold(s);

      // Online softmax: scale, mask, the running max of each row over its
      // quad, p, the row sums; the output rescaled by the correction.
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = r0 + ((i >> 1) & 1) * 8;
        const int col = c0 + (i >> 2) * 8 + cq + (i & 1);
        s[i] = g.attend(row, col) ? s[i] * g.scale : NEG_INF;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float new_m = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - new_m);
        m[r] = new_m;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int row = r0 + r * 8;
        const int col = c0 + (i >> 2) * 8 + cq + (i & 1);
        s[i] = g.attend(row, col) ? expf(s[i] - m[r]) : 0.0f;
        sum[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
      uint32_t frag[NT][4][4];
      a_fragments<NT>(s, frag);

      if (TMA) mbar_wait(v_bar + st, (t >> 1) & 1);
      hold(o);
      hold(frag);
      wg_fence();
      mma_terms<NT>(o, frag, smem_u32(vt));
      wg_commit();
      wg_wait();
      hold(o);
      __syncthreads();  // both stages' readers are done before a refill
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r * 8;
    if (row >= g.Sq) continue;
    const float l_safe = fmaxf(l[r], L_FLOOR);
    T* dst = out + (((size_t)b * g.Sq + row) * g.H + h) * D;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = i * 8 + cq + e;
        if (d < D) dst[d] = from_f<T>(o[i * 4 + r * 2 + e] / l_safe);
      }
    if ((lane & 3) == 0)
      lse[((size_t)b * g.Sq + row) * g.H + h] = m[r] + logf(l_safe);
  }
}

// -- B3: dk/dv ----------------------------------------------------------------

constexpr size_t DKV_SMEM = 6 * TILE_BYTES + 4 * 64 * sizeof(float) + 64 + 1024;

// lse and delta of rows [q0, q0 + 64) into shared memory (threads 0-127).
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int q0, int b,
                                          int h, const Geometry& g, int tid) {
  if (tid < 128) {
    const int r = tid & 63;
    const int row = q0 + r;
    const float* src = tid < 64 ? lse : delta;
    float* dst = tid < 64 ? lse_s : delta_s;
    dst[r] = row < g.Sq ? src[((size_t)b * g.Sq + row) * g.H + h] : 0.0f;
  }
}

template <typename T, typename OD, bool TMA>
__global__ void __launch_bounds__(256, 1)
dkv_tc(const __grid_constant__ Maps maps, const T* __restrict__ q,
       const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dk,
       T* __restrict__ dv, Geometry g) {
  constexpr int NT = Terms<OD>::N;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + TILE_BYTES;
  uint8_t* qs = vs + TILE_BYTES;       // two stages
  uint8_t* dos = qs + 2 * TILE_BYTES;  // two stages
  float* rows_s = reinterpret_cast<float*>(dos + 2 * TILE_BYTES);
  // rows_s: lse of stage s at 128·s, delta at 128·s + 64.
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows_s + 4 * 64);
  uint64_t* kv_bar = bars;
  uint64_t* qd_bar = bars + 1;  // [2]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;           // 0: dv, 1: dk
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const int c0 = blockIdx.x * BK;
  const int key0 = c0 + ((tid & 127) >> 5) * 16 + (lane >> 2);  // keys key0, key0 + 8
  const int cq = (lane & 3) * 2;
  const int D = g.D;
  const int ksteps = (D + 15) >> 4;
  const bool any_key = g.kv_len < 0 || c0 < g.kv_len;
  const int nq = any_key ? (g.Sq + BQ - 1) / BQ : 0;
  const int t0 = min(g.first_query_tile(c0), nq);
  const int n = nq - t0;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  if (n > 0) {
    if (TMA) {
      if (tid == 0) {
        for (int i = 0; i < 3; ++i) mbar_init(bars + i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();
      if (tid == 0) {
        mbar_expect(kv_bar, 2 * TILE_BYTES);
        tma_tile(ks, &maps.b, kv_bar, c0, b, h);
        tma_tile(vs, &maps.c, kv_bar, c0, b, h);
        mbar_expect(qd_bar, 2 * TILE_BYTES);
        tma_tile(qs, &maps.a, qd_bar, t0 * BQ, b, h);
        tma_tile(dos, &maps.d, qd_bar, t0 * BQ, b, h);
      }
    } else {
      thread_tile<T>(ks, k, c0, g.Sk, g.H, D, b, h, tid, 256);
      thread_tile<T>(vs, v, c0, g.Sk, g.H, D, b, h, tid, 256);
      thread_tile<T>(qs, q, t0 * BQ, g.Sq, g.H, D, b, h, tid, 256);
      thread_tile<T>(dos, dout, t0 * BQ, g.Sq, g.H, D, b, h, tid, 256);
    }
    load_rows(rows_s, rows_s + 64, lse, delta, t0 * BQ, b, h, g, tid);
    __syncthreads();
    if (TMA) mbar_wait(kv_bar, 0);

    for (int it = 0; it < n; ++it) {
      const int st = it & 1;
      const int q0 = (t0 + it) * BQ;
      uint8_t* qt = qs + st * TILE_BYTES;
      uint8_t* dot = dos + st * TILE_BYTES;
      const float* lse_s = rows_s + st * 128;
      const float* delta_s = lse_s + 64;
      if (TMA) mbar_wait(qd_bar + st, (it >> 1) & 1);
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
      hold(s);
      hold(dp);
      wg_fence();
      // Sᵀ = k·qᵀ and dPᵀ = v·dOᵀ in both warpgroups (the first does not
      // need dPᵀ, but a product in one warpgroup alone is a divergent
      // path, on which ptxas serializes every wgmma of the kernel).
      mma_head_dim(s, smem_u32(ks), smem_u32(qt), ksteps);
      mma_head_dim(dp, smem_u32(vs), smem_u32(dot), ksteps);
      wg_commit();
      if (it + 1 < n) {  // the next query tile into the other stage
        const int qn = q0 + BQ;
        uint8_t* qt_n = qs + (st ^ 1) * TILE_BYTES;
        uint8_t* dot_n = dos + (st ^ 1) * TILE_BYTES;
        if (TMA) {
          if (tid == 0) {
            mbar_expect(qd_bar + (st ^ 1), 2 * TILE_BYTES);
            tma_tile(qt_n, &maps.a, qd_bar + (st ^ 1), qn, b, h);
            tma_tile(dot_n, &maps.d, qd_bar + (st ^ 1), qn, b, h);
          }
        } else {
          thread_tile<T>(qt_n, q, qn, g.Sq, g.H, D, b, h, tid, 256);
          thread_tile<T>(dot_n, dout, qn, g.Sq, g.H, D, b, h, tid, 256);
        }
        float* next = rows_s + (st ^ 1) * 128;
        load_rows(next, next + 64, lse, delta, qn, b, h, g, tid);
      }
      wg_wait();
      hold(s);
      hold(dp);

      // pᵀ (and dsᵀ) in place: rows of the tile are keys, columns query
      // rows.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + ((i >> 1) & 1) * 8;
        const int rl = (i >> 2) * 8 + cq + (i & 1);
        const bool on = g.attend(q0 + rl, key);
        const float p = on ? expf(s[i] * g.scale - lse_s[rl]) : 0.0f;
        s[i] = wg == 0 ? p : (on ? p * (dp[i] - delta_s[rl]) * g.scale : 0.0f);
      }
      uint32_t frag[NT][4][4];
      a_fragments<NT>(s, frag);
      hold(acc);
      hold(frag);
      wg_fence();
      // dv += pᵀ·dO (warpgroup 0), dk += dsᵀ·q (warpgroup 1).
      mma_terms<NT>(acc, frag, smem_u32(wg == 0 ? dot : qt));
      wg_commit();
      wg_wait();
      hold(acc);
      __syncthreads();  // both stages' readers are done before a refill
    }
  }

  T* dst = wg == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= g.Sk) continue;
    T* row = dst + (((size_t)b * g.Sk + key) * g.H + h) * D;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = i * 8 + cq + e;
        if (d < D) row[d] = from_f<T>(acc[i * 4 + r * 2 + e]);
      }
  }
}

// -- B2: dq -------------------------------------------------------------------

constexpr size_t DQ_SMEM = 6 * TILE_BYTES + 64 + 1024;

template <typename T, typename OD, bool TMA>
__global__ void __launch_bounds__(128)
dq_tc(const __grid_constant__ Maps maps, const T* __restrict__ q,
      const T* __restrict__ k, const T* __restrict__ v,
      const T* __restrict__ dout, const float* __restrict__ lse,
      const float* __restrict__ delta, T* __restrict__ dq, Geometry g) {
  constexpr int NT = Terms<OD>::N;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + TILE_BYTES;
  uint8_t* ks = dos + TILE_BYTES;     // two stages
  uint8_t* vs = ks + 2 * TILE_BYTES;  // two stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * TILE_BYTES);
  uint64_t* qd_bar = bars;
  uint64_t* kv_bar = bars + 1;  // [2]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int r0 = q0 + (tid >> 5) * 16 + (lane >> 2);  // rows r0, r0 + 8
  const int cq = (lane & 3) * 2;
  const int D = g.D;
  const int ksteps = (D + 15) >> 4;
  const int nk = g.key_tiles(q0);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  // lse and delta of this thread's two rows, in the accumulator's row
  // layout.
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r * 8;
    const size_t at = ((size_t)b * g.Sq + row) * g.H + h;
    lse_r[r] = row < g.Sq ? lse[at] : 0.0f;
    delta_r[r] = row < g.Sq ? delta[at] : 0.0f;
  }

  if (nk > 0) {
    if (TMA) {
      if (tid == 0) {
        for (int i = 0; i < 3; ++i) mbar_init(bars + i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();
      if (tid == 0) {
        mbar_expect(qd_bar, 2 * TILE_BYTES);
        tma_tile(qs, &maps.a, qd_bar, q0, b, h);
        tma_tile(dos, &maps.d, qd_bar, q0, b, h);
        mbar_expect(kv_bar, 2 * TILE_BYTES);
        tma_tile(ks, &maps.b, kv_bar, 0, b, h);
        tma_tile(vs, &maps.c, kv_bar, 0, b, h);
      }
      mbar_wait(qd_bar, 0);
    } else {
      thread_tile<T>(qs, q, q0, g.Sq, g.H, D, b, h, tid, 128);
      thread_tile<T>(dos, dout, q0, g.Sq, g.H, D, b, h, tid, 128);
      thread_tile<T>(ks, k, 0, g.Sk, g.H, D, b, h, tid, 128);
      thread_tile<T>(vs, v, 0, g.Sk, g.H, D, b, h, tid, 128);
      __syncthreads();
    }
    for (int t = 0; t < nk; ++t) {
      const int st = t & 1;
      const int c0 = t * BK;
      uint8_t* kt = ks + st * TILE_BYTES;
      uint8_t* vt = vs + st * TILE_BYTES;
      if (TMA) mbar_wait(kv_bar + st, (t >> 1) & 1);
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
      hold(s);
      hold(dp);
      wg_fence();
      // S = q·kᵀ and dP = dO·vᵀ, both operands K-major.
      mma_head_dim(s, smem_u32(qs), smem_u32(kt), ksteps);
      mma_head_dim(dp, smem_u32(dos), smem_u32(vt), ksteps);
      wg_commit();
      if (t + 1 < nk) {  // the next tiles into the other stage
        uint8_t* kn = ks + (st ^ 1) * TILE_BYTES;
        uint8_t* vn = vs + (st ^ 1) * TILE_BYTES;
        if (TMA) {
          if (tid == 0) {
            mbar_expect(kv_bar + (st ^ 1), 2 * TILE_BYTES);
            tma_tile(kn, &maps.b, kv_bar + (st ^ 1), c0 + BK, b, h);
            tma_tile(vn, &maps.c, kv_bar + (st ^ 1), c0 + BK, b, h);
          }
        } else {
          thread_tile<T>(kn, k, c0 + BK, g.Sk, g.H, D, b, h, tid, 128);
          thread_tile<T>(vn, v, c0 + BK, g.Sk, g.H, D, b, h, tid, 128);
        }
      }
      wg_wait();
      hold(s);
      hold(dp);

      // ds = p·(dp − delta)·scale in place of s, p re-masked to 0.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int col = c0 + (i >> 2) * 8 + cq + (i & 1);
        const bool on = g.attend(r0 + r * 8, col);
        const float p = on ? expf(s[i] * g.scale - lse_r[r]) : 0.0f;
        s[i] = on ? p * (dp[i] - delta_r[r]) * g.scale : 0.0f;
      }
      uint32_t frag[NT][4][4];
      a_fragments<NT>(s, frag);
      hold(acc);
      hold(frag);
      wg_fence();
      // dq += dS·k, k read MN-major from the tile S read K-major.
      mma_terms<NT>(acc, frag, smem_u32(kt));
      wg_commit();
      wg_wait();
      hold(acc);
      __syncthreads();  // both stages' readers are done before a refill
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r * 8;
    if (row >= g.Sq) continue;
    T* dst = dq + (((size_t)b * g.Sq + row) * g.H + h) * D;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = i * 8 + cq + e;
        if (d < D) dst[d] = from_f<T>(acc[i * 4 + r * 2 + e]);
      }
  }
}

// -- host -------------------------------------------------------------------

bool valid(const Geometry& g) {
  return g.B >= 1 && g.H >= 1 && g.B * g.H <= 65535 && g.Sq >= 1 &&
         g.Sk >= 1 && g.D >= 1 && g.D <= MAX_D;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no link against libcuda); null when it cannot be found.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (B, S, H, D) bf16 tensor: boxes of 64 rows of S x
// 64 columns of D at one (b, h), 128-byte swizzle, zero out of bounds.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)D * 2;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {row, row * H, row * H * S};
  cuuint32_t box[4] = {64, 1, 64, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Storage and operand type codes: 0 = float32, 1 = bfloat16.
template <typename T, typename OD>
int fwd_typed(const void* q, const void* k, const void* v, void* out,
              float* lse, Geometry g, bool tma, cudaStream_t s) {
  Maps maps = {};
  const dim3 grid((g.Sq + BQ - 1) / BQ, g.B * g.H);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (!tma) return launch(fwd_tc<T, OD, false>, grid, 128, FWD_SMEM, s, maps,
                            (const T*)q, (const T*)k, (const T*)v, (T*)out,
                            lse, g);
    int err = make_map(&maps.a, q, g.B, g.Sq, g.H, g.D);
    if (!err) err = make_map(&maps.b, k, g.B, g.Sk, g.H, g.D);
    if (!err) err = make_map(&maps.c, v, g.B, g.Sk, g.H, g.D);
    if (err) return err;
    return launch(fwd_tc<T, OD, true>, grid, 128, FWD_SMEM, s, maps,
                  (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, g);
  } else {
    return launch(fwd_tc<T, OD, false>, grid, 128, FWD_SMEM, s, maps,
                  (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, g);
  }
}

template <typename T, typename OD>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dk, void* dv,
              Geometry g, bool tma, cudaStream_t s) {
  Maps maps = {};
  const dim3 grid((g.Sk + BK - 1) / BK, g.B * g.H);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (!tma) return launch(dkv_tc<T, OD, false>, grid, 256, DKV_SMEM, s, maps,
                            (const T*)q, (const T*)k, (const T*)v,
                            (const T*)dout, lse, delta, (T*)dk, (T*)dv, g);
    int err = make_map(&maps.a, q, g.B, g.Sq, g.H, g.D);
    if (!err) err = make_map(&maps.b, k, g.B, g.Sk, g.H, g.D);
    if (!err) err = make_map(&maps.c, v, g.B, g.Sk, g.H, g.D);
    if (!err) err = make_map(&maps.d, dout, g.B, g.Sq, g.H, g.D);
    if (err) return err;
    return launch(dkv_tc<T, OD, true>, grid, 256, DKV_SMEM, s, maps,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
                  delta, (T*)dk, (T*)dv, g);
  } else {
    return launch(dkv_tc<T, OD, false>, grid, 256, DKV_SMEM, s, maps,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
                  delta, (T*)dk, (T*)dv, g);
  }
}

template <typename T, typename OD>
int dq_typed(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, Geometry g,
             bool tma, cudaStream_t s) {
  Maps maps = {};
  const dim3 grid((g.Sq + BQ - 1) / BQ, g.B * g.H);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (!tma) return launch(dq_tc<T, OD, false>, grid, 128, DQ_SMEM, s, maps,
                            (const T*)q, (const T*)k, (const T*)v,
                            (const T*)dout, lse, delta, (T*)dq, g);
    int err = make_map(&maps.a, q, g.B, g.Sq, g.H, g.D);
    if (!err) err = make_map(&maps.b, k, g.B, g.Sk, g.H, g.D);
    if (!err) err = make_map(&maps.c, v, g.B, g.Sk, g.H, g.D);
    if (!err) err = make_map(&maps.d, dout, g.B, g.Sq, g.H, g.D);
    if (err) return err;
    return launch(dq_tc<T, OD, true>, grid, 128, DQ_SMEM, s, maps,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
                  delta, (T*)dq, g);
  } else {
    return launch(dq_tc<T, OD, false>, grid, 128, DQ_SMEM, s, maps,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
                  delta, (T*)dq, g);
  }
}

// TMA takes bf16 rows that are a multiple of 16 bytes at 16-byte-aligned
// addresses.
bool tma_route(int storage, int D, std::initializer_list<const void*> ptrs) {
  if (storage != 1 || D % 8 != 0) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace

extern "C" {

int veles_flash_tc_max_d() { return MAX_D; }

int veles_flash_fwd_tc(int storage, int od, const void* q, const void* k,
                       const void* v, void* out, float* lse, int B, int H,
                       int Sq, int Sk, int D, float scale, int causal,
                       int q_off, int k_off, int kv_len, void* stream) {
  const Geometry g{B, H, Sq, Sk, D, scale, causal, q_off, k_off, kv_len};
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma = tma_route(storage, D, {q, k, v});
  if (storage == 1 && od == 0)
    return fwd_typed<__nv_bfloat16, float>(q, k, v, out, lse, g, tma, s);
  if (storage == 1 && od == 1)
    return fwd_typed<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, lse, g, tma, s);
  if (storage == 0 && od == 1)
    return fwd_typed<float, __nv_bfloat16>(q, k, v, out, lse, g, false, s);
  return (int)cudaErrorInvalidValue;  // f32/f32 runs on the FP32 units
}

int veles_flash_dq_tc(int storage, int od, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int H, int Sq,
                      int Sk, int D, float scale, int causal, int q_off,
                      int k_off, int kv_len, void* stream) {
  const Geometry g{B, H, Sq, Sk, D, scale, causal, q_off, k_off, kv_len};
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma = tma_route(storage, D, {q, k, v, dout});
  if (storage == 1 && od == 0)
    return dq_typed<__nv_bfloat16, float>(q, k, v, dout, lse, delta, dq, g,
                                          tma, s);
  if (storage == 1 && od == 1)
    return dq_typed<__nv_bfloat16, __nv_bfloat16>(q, k, v, dout, lse, delta,
                                                  dq, g, tma, s);
  if (storage == 0 && od == 1)
    return dq_typed<float, __nv_bfloat16>(q, k, v, dout, lse, delta, dq, g,
                                          false, s);
  return (int)cudaErrorInvalidValue;  // f32/f32 runs on the FP32 units
}

int veles_flash_dkv_tc(int storage, int od, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H,
                       int Sq, int Sk, int D, float scale, int causal,
                       int q_off, int k_off, int kv_len, void* stream) {
  const Geometry g{B, H, Sq, Sk, D, scale, causal, q_off, k_off, kv_len};
  if (!valid(g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma = tma_route(storage, D, {q, k, v, dout});
  if (storage == 1 && od == 0)
    return dkv_typed<__nv_bfloat16, float>(q, k, v, dout, lse, delta, dk, dv,
                                           g, tma, s);
  if (storage == 1 && od == 1)
    return dkv_typed<__nv_bfloat16, __nv_bfloat16>(q, k, v, dout, lse, delta,
                                                   dk, dv, g, tma, s);
  if (storage == 0 && od == 1)
    return dkv_typed<float, __nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                           g, false, s);
  return (int)cudaErrorInvalidValue;
}

const char* veles_flash_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
