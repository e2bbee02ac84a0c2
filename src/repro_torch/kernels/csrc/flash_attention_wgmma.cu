// Flash attention for bf16 on Hopper: wgmma on TMA-staged tiles, P split
// into three bf16 terms so that P.V keeps the reference's float32 P.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py),
// whose grid (B, Hq, L/128, L/128) runs in order on one TPU core and carries
// the running max m, denominator l and accumulator acc in VMEM scratch from
// one KV step to the next.  It computes flash_attention_ref
// (src/repro_torch/kernels/ref.py): logits q.k * D**-0.5 in float32, the
// finite -1e30 where masked, probabilities zeroed where masked, out = (p v) / l
// with l == 0 read as 1, rounded to bf16.  The float32 route stays on the
// CUDA-core kernel of flash_attention.cu.
//
// Bound on the H100: operations.  A (query, key) pair the mask allows costs
// 2 D flops for q.k and 2 D for p.v: 4 B Hq pairs D flops, 5.5e11 at
// granite-3-8b's prefill launch (B = 4, Hq = 32, L = 4096 causal, D = 128),
// 0.556 ms at 989e12 bf16 flop/s, against 0.100 ms to move q, k, v and o once.
// This kernel does 8 D flops a pair (P.V three times, below): 1.11 ms at peak.
//
// Design:
//   * grid (Hq, B, query tiles): one CTA per 128-row query tile, the tile
//     index reversed so the longest causal tiles of every head start first;
//   * warp specialisation: warpgroup 0 is the producer (one thread issues
//     every TMA load, the warpgroup gives its registers up with setmaxnreg),
//     warpgroups 1 and 2 are consumers, 64 query rows each, 240 registers;
//   * TMA: q, k and v are 3-D tensor maps (D, L, B H) with 128-byte swizzle
//     and boxes of 64 columns x 128 rows, so rows past L read as zeros and
//     never as the next head's rows; Q is loaded once, K and V go through a
//     ring of two stages (full and empty mbarriers per stage);
//   * S = Q K^T: wgmma m64n128k16, both operands from shared memory
//     (K-major descriptors, 128-byte swizzle), float32 accumulators;
//   * online softmax in registers on the accumulator layout (a row lives in
//     a quad of lanes: shfl.xor 1 and 2), in base 2 with the scale folded
//     into one FMA; the mask code runs only on tiles that straddle the
//     diagonal, the window's edge or L;
//   * O += P V, split: P = P_0 + P_1 + P_2, each term the bf16 truncation of
//     what the terms before it leave (8 significant bits each, so the three
//     hold float32 P exactly), built in registers as wgmma A fragments (S's
//     accumulator layout is the A layout of the next m64nDk16), three wgmma
//     per 16 keys against V read MN-major through the descriptor's
//     transpose bit.  Rounding P to bf16 alone, as SDPA does, moves about
//     12% of the outputs more than one bf16 step (+ 1e-6) from the
//     reference; two terms keep P to 16-17 bits and still miss that gate
//     about once in 4-8 million outputs (a few times per prefill launch of
//     67 million); three keep all 24.  l is summed from the float32 P;
//   * the two consumer warpgroups take turns (named barriers): a turn
//     issues P V of one tile, waits for it and issues S of the next, so one
//     warpgroup's softmax overlaps the other's products, and P (96
//     registers) and S (64) are never live at once beside O (D / 2);
//   * epilogue: acc / l rounded to bf16, rows at or past L not stored;
//   * D = 256 (recurrentgemma's local attention): KV tiles of 64 keys
//     (boxes of 64 rows).  Q (64 KB) and a two-stage ring of 128-key K and
//     V tiles (256 KB) would pass the 227 KB a CTA may opt into; with 64
//     keys the ring is 128 KB, 197 KB in all.  A consumer thread holds O's
//     128 float32 (P V as two m64n128k16 per term, one a 128-column half),
//     S's 32 and P's 48: 176 live at most, as D = 128 holds 160.
//
// The host computes the grid and the tensor maps' geometry
// (kernels/flash_attention.py); the entry checks them against the shapes.
// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is found
// with dlsym in the libcuda.so.1 the runtime has loaded, so no link flag is
// needed.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>

#include <cmath>

#include "mbarrier.cuh"

namespace {

using repro_torch::mbar_arrive;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::smem_addr;

constexpr int kBlockM = 128;  // query rows per CTA: two consumer warpgroups of 64
constexpr int kStages = 2;    // K/V ring depth
constexpr int kThreads = 384;
constexpr int kBoxCols = 64;  // bf16 columns of one 128-byte box
constexpr float kNeg = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// keys per KV tile: 128, or 64 at D = 256, where a 128-key ring (2 x 2 x 64 KB)
// beside Q (64 KB) passes the 227 KB a CTA may opt into, and a 128-key S (64
// registers) beside P (96) and O (128) passes the 240 a consumer thread holds
template <int D>
constexpr int block_n() {
  return D == 256 ? 64 : 128;
}

// shared memory: Q, then K stages, then V stages, then the mbarriers
template <int D>
struct Smem {
  static constexpr int kN = block_n<D>();
  static constexpr int kQBox = kBlockM * kBoxCols * 2;  // 16 KB: 128 rows of 128 bytes
  static constexpr int kKVBox = kN * kBoxCols * 2;      // kN rows of 128 bytes
  static constexpr int kQTile = kBlockM * D * 2;        // bytes of the Q tile
  static constexpr int kKVTile = kN * D * 2;            // bytes of one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBar = kV + kStages * kKVTile;
  // q_full, k_full[kStages], v_full[kStages], kv_empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// named barriers 1 and 2 order the consumer warpgroups' wgmma issue
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from touching a register an in-flight wgmma reads or
// writes: each use after the wait depends on this point
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d[0..64) += A[64 x 16] B[16 x 128]: A and B from shared memory (both K-major);
// scale_d == 0 overwrites d instead.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0..32) += A[64 x 16] B[16 x 64]: A and B from shared memory (both K-major);
// scale_d == 0 overwrites d instead.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  wgmma_ss_n128(d, a, b, scale_d);
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  wgmma_ss_n64(d, a, b, scale_d);
}

// d[0..64) += A[64 x 16] B[16 x 128]: A from registers (a[0..4), bf16 pairs), B from
// shared memory, MN-major (the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

// d[0..32) += A[64 x 16] B[16 x 64]: A from registers (a[0..4), bf16 pairs), B from
// shared memory, MN-major (the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// The KV tiles of kN keys query tile qt visits, and whether a tile needs the
// mask code: kv_tiles and tile_needs_mask of kernels/flash_attention.py, which
// the CPU tests hold against a brute-force mask.
template <int kN>
__device__ __forceinline__ void kv_tiles(int qt, int L, int causal, int window, int* begin,
                                         int* end) {
  const int m0 = qt * kBlockM;
  const int q_last = min(m0 + kBlockM, L) - 1;
  *end = causal ? q_last / kN + 1 : (L + kN - 1) / kN;
  *begin = window > 0 ? max(0, m0 - window + 1) / kN : 0;
}

template <int kN>
__device__ __forceinline__ bool tile_needs_mask(int qt, int kt, int L, int causal, int window) {
  const int m0 = qt * kBlockM, n0 = kt * kN;
  const int q_last = min(m0 + kBlockM, L) - 1;
  return n0 + kN > L || (causal && n0 + kN - 1 > m0) || (window > 0 && n0 <= q_last - window);
}

__device__ __forceinline__ bool allowed(int row, int key, int L, int causal, int window) {
  return key < L && (!causal || key <= row) && (window <= 0 || key > row - window);
}

// Online softmax of one KV tile of kN keys on the accumulator layout.
// s[4 j + 2 i + c] is the logit of row `row + 8 i` against key `key0 + 8 j + c`.  On return
// s holds exp2(logit * scale_log2 - m) (zero where masked), m (the running
// max of logit * scale_log2) and l are updated, and alpha holds each row's
// factor exp2(m_old - m_new).  l is this thread's share of the row sum; the
// quad adds its four at the end.  Maxima and sums run four chains a row:
// while one warpgroup is in its softmax, its warp is often the only one an
// SM sub-partition can issue from, so the latency of a single chain shows.
template <bool kMasked, int kN>
__device__ __forceinline__ void softmax_tile(float (&s)[kN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int row, int key0, int L,
                                             int causal, int window, float scale_log2) {
  if (kMasked) {
#pragma unroll
    for (int e = 0; e < kN / 2; ++e)
      if (!allowed(row + 8 * ((e >> 1) & 1), key0 + 8 * (e >> 2) + (e & 1), L, causal, window))
        s[e] = kNeg;
  }
  // the max of logit * scale_log2 is scale_log2 times the max logit
  // (scale_log2 > 0, and rounding is monotonic)
  float part[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const float x = fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
      part[i][j & 3] = j < 4 ? x : fmaxf(part[i][j & 3], x);
    }
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = fmaxf(fmaxf(part[i][0], part[i][1]), fmaxf(part[i][2], part[i][3]));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    const float m_new = fmaxf(m[i], mx * scale_log2);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    neg_m[i] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        float p = ex2(fmaf(s[e], scale_log2, neg_m[i]));
        if (kMasked && !allowed(row + 8 * i, key0 + 8 * j + c, L, causal, window)) p = 0.0f;
        s[e] = p;
        part[i][j & 3] = (j < 4 && c == 0) ? p : part[i][j & 3] + p;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = l[i] * alpha[i] + ((part[i][0] + part[i][1]) + (part[i][2] + part[i][3]));
}

// bf16x2 of the high halves of a and b (each truncated toward zero), a low
__device__ __forceinline__ uint32_t high_halves(float a, float b) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0x7632;" : "=r"(r) : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)));
  return r;
}

// x less its bf16 truncation: exact in float32
__device__ __forceinline__ float low_part(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 __nv_bfloat16* __restrict__ o, int hq, int hkv, int L,
                                 float scale_log2, int causal, int window) {
  using S = Smem<D>;
  constexpr int kN = S::kN;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + S::kBar;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t kv_empty = v_full + 8 * kStages;

  const int nq = (L + kBlockM - 1) / kBlockM;
  const int qt = nq - 1 - (int)blockIdx.z;  // the longest causal tiles start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (hq / hkv);
  int kt_begin, kt_end;
  kv_tiles<kN>(qt, L, causal, window, &kt_begin, &kt_end);
  const int n_kv = kt_end - kt_begin;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x != 0) return;
    asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)&qmap) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)&kmap) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)&vmap) : "memory");
    mbar_expect_tx(q_full, S::kQTile);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
      tma_load(base + S::kQ + c * S::kQBox, &qmap, q_full, c * kBoxCols, qt * kBlockM, b * hq + h);
    for (int i = 0; i < n_kv; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(kv_empty + 8 * st, (i / kStages - 1) & 1);
      const int n0 = (kt_begin + i) * kN;
      mbar_expect_tx(k_full + 8 * st, S::kKVTile);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(base + S::kK + st * S::kKVTile + c * S::kKVBox, &kmap, k_full + 8 * st,
                 c * kBoxCols, n0, b * hkv + kh);
      mbar_expect_tx(v_full + 8 * st, S::kKVTile);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(base + S::kV + st * S::kKVTile + c * S::kKVBox, &vmap, v_full + 8 * st,
                 c * kBoxCols, n0, b * hkv + kh);
    }
    return;
  }

  // consumers: warpgroup w owns query rows m0 + 64 w .. m0 + 64 w + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int w = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row = qt * kBlockM + 64 * w + 16 * warp + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);                                // and col + 1, of each 8
  // acc[4 j + 2 i + c] is row `row + 8 i`, column 8 j + c + col of the output
  // (at D = 256 the two 128-column halves of P V accumulate into acc[0, 64)
  // and acc[64, 128), which keeps that layout)
  float acc[D / 2], s[kN / 2];
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f}, alpha[2];
  uint32_t p0[kN / 4], p1[kN / 4], p2[kN / 4];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) s[e] = 0.0f;
#pragma unroll
  for (int r = 0; r < kN / 4; ++r) p0[r] = p1[r] = p2[r] = 0u;

  const uint32_t q_base = base + S::kQ + w * 64 * 128;  // 64 rows of 128 bytes into each box
  mbar_wait(q_full, 0);

  // Turn i (0 <= i <= n_kv) issues P V of tile i - 1, waits for it, then
  // issues S = Q K^T of tile i; the other warpgroup runs its softmax
  // meanwhile.  Consumer 0 takes the first turn, and each turn hands over to
  // the other consumer (named barriers 1 and 2: every arrival meets a sync).
  if (w == 1) bar_arrive(1);
  for (int i = 0; i <= n_kv; ++i) {
    bar_sync(1 + w);
    if (i > 0) {
      // O += P_0 V + P_1 V + P_2 V: 16 keys per three wgmma; V's rows are
      // keys, so B is MN-major: 8 keys of 128 bytes per 1024-byte group
      // (SBO), the next 64 columns of D one box further (LBO)
      const int st = (i - 1) % kStages;
      const uint32_t v_base = base + S::kV + st * S::kKVTile;
      mbar_wait(v_full + 8 * st, ((i - 1) / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kN / 16; ++ks) {
        const uint64_t vd = smem_desc(v_base + ks * 16 * 128, S::kKVBox, 1024);
        if constexpr (D == 256) {
          // columns 0-127 from boxes 0 and 1, 128-255 from boxes 2 and 3
          float(&lo)[64] = *reinterpret_cast<float(*)[64]>(&acc[0]);
          float(&hi)[64] = *reinterpret_cast<float(*)[64]>(&acc[64]);
          const uint64_t vd_hi = smem_desc(v_base + 2 * S::kKVBox + ks * 16 * 128, S::kKVBox, 1024);
          wgmma_rs_n128(lo, &p0[4 * ks], vd);
          wgmma_rs_n128(hi, &p0[4 * ks], vd_hi);
          wgmma_rs_n128(lo, &p1[4 * ks], vd);
          wgmma_rs_n128(hi, &p1[4 * ks], vd_hi);
          wgmma_rs_n128(lo, &p2[4 * ks], vd);
          wgmma_rs_n128(hi, &p2[4 * ks], vd_hi);
        } else if constexpr (D == 128) {
          wgmma_rs_n128(acc, &p0[4 * ks], vd);
          wgmma_rs_n128(acc, &p1[4 * ks], vd);
          wgmma_rs_n128(acc, &p2[4 * ks], vd);
        } else {
          wgmma_rs_n64(acc, &p0[4 * ks], vd);
          wgmma_rs_n64(acc, &p1[4 * ks], vd);
          wgmma_rs_n64(acc, &p2[4 * ks], vd);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(p0);
      pin(p1);
      pin(p2);
      if (lane == 0) mbar_arrive(kv_empty + 8 * st);  // tile i - 1's stage is free
    }
    if (i == n_kv) {
      if (w == 0) bar_arrive(2);
      break;
    }

    // S = Q K^T: 16 columns of D per wgmma, four per 128-byte box
    const int st = i % kStages, kt = kt_begin + i;
    const uint32_t k_base = base + S::kK + st * S::kKVTile;
    mbar_wait(k_full + 8 * st, (i / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t col = (ks % 4) * 32;
      wgmma_ss(s, smem_desc(q_base + (ks / 4) * S::kQBox + col, 16, 1024),
               smem_desc(k_base + (ks / 4) * S::kKVBox + col, 16, 1024), ks > 0);
    }
    wgmma_commit();
    bar_arrive(2 - w);
    wgmma_wait_all();
    pin(s);

    if (tile_needs_mask<kN>(qt, kt, L, causal, window))
      softmax_tile<true, kN>(s, m, l, alpha, row, kt * kN + col, L, causal, window, scale_log2);
    else
      softmax_tile<false, kN>(s, m, l, alpha, row, kt * kN + col, L, causal, window, scale_log2);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
    // P = P_0 + P_1 + P_2, each term the bf16 truncation of what the ones
    // before leave: 8 of float32 P's 24 significant bits each, so the three
    // hold P exactly (integer permutes and float32 subtractions, no
    // conversion instructions)
#pragma unroll
    for (int r = 0; r < kN / 4; ++r) {
      float x = s[2 * r], y = s[2 * r + 1];
      p0[r] = high_halves(x, y);
      x = low_part(x);
      y = low_part(y);
      p1[r] = high_halves(x, y);
      p2[r] = high_halves(low_part(x), low_part(y));
    }
  }

  // epilogue: the quad's shares of l, then acc / l in bf16, rows < L only
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFullMask, l[i], 1);
    l[i] += __shfl_xor_sync(kFullMask, l[i], 2);
    const int r = row + 8 * i;
    if (r >= L) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
    __nv_bfloat162* out =
        reinterpret_cast<__nv_bfloat162*>(o + ((int64_t)(b * hq + h) * L + r) * D + col);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      out[4 * j] =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] / denom, acc[4 * j + 2 * i + 1] / denom);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* drv = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (drv == nullptr) drv = dlopen("libcuda.so.1", RTLD_NOW);
    if (drv != nullptr) fn = (EncodeTiled)dlsym(drv, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// geo: dims[3] (innermost first), byte strides of dims 1 and 2, box[3]
bool geometry_ok(const long long* geo, int d, int L, long long heads, int rows) {
  const long long want[8] = {d, L, heads, 2LL * d, 2LL * d * L, kBoxCols, rows, 1};
  for (int i = 0; i < 8; ++i)
    if (geo[i] != want[i]) return false;
  return true;
}

int encode(CUtensorMap* map, const void* ptr, const long long* geo) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)geo[0], (cuuint64_t)geo[1], (cuuint64_t)geo[2]};
  const cuuint64_t strides[2] = {(cuuint64_t)geo[3], (cuuint64_t)geo[4]};
  const cuuint32_t box[3] = {(cuuint32_t)geo[5], (cuuint32_t)geo[6], (cuuint32_t)geo[7]};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "flash_attention_wgmma: cuTensorMapEncodeTiled returned %d\n", (int)r);
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int hq, int hkv, int L,
           int causal, int window, const unsigned* grid, const long long* q_geo,
           const long long* kv_geo, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int err = encode(&qmap, q, q_geo);
  if (err == 0) err = encode(&kmap, k, kv_geo);
  if (err == 0) err = encode(&vmap, v, kv_geo);
  if (err != 0) return err;
  constexpr int smem = Smem<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel_wgmma<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // D**-0.5 rounded once to float32, as the plain version's Python float is, times log2(e)
  const float scale_log2 = (float)(1.0 / std::sqrt((double)D)) * 1.4426950408889634f;
  flash_attention_kernel_wgmma<D><<<dim3(grid[0], grid[1], grid[2]), kThreads, smem, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)o, hq, hkv, L, scale_log2, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q and o [b, hq, L, d], k and v [b, hkv, L, d], bf16, contiguous and
// 16-byte aligned; d is 64, 128 or 256, hq a multiple of hkv; the logits are
// q.k * d**-0.5.  causal != 0 masks keys after the query; window > 0 masks
// keys at or before query - window.  grid is (hq, b, ceil(L / 128)); q_geo
// and kv_geo are the tensor maps' dims, byte strides and boxes
// ({d, L, b * heads}, {2 d, 2 d L}, {64, rows, 1}; rows 128, and 64 for
// kv_geo at d = 256), checked here.  Returns
// cudaGetLastError() after the launch, or the error that kept it from
// launching.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            int b, int hq, int hkv, int L, int d, int causal,
                                            int window, const unsigned* grid,
                                            const long long* q_geo, const long long* kv_geo,
                                            void* stream) {
  if (b <= 0 || hq <= 0 || L <= 0) return (int)cudaGetLastError();
  if (hkv <= 0 || hq % hkv != 0 || b > 65535 || (d != 64 && d != 128 && d != 256))
    return (int)cudaErrorInvalidValue;
  if (grid[0] != (unsigned)hq || grid[1] != (unsigned)b ||
      grid[2] != (unsigned)((L + kBlockM - 1) / kBlockM) || grid[2] > 65535u)
    return (int)cudaErrorInvalidValue;
  const int kv_rows = d == 256 ? block_n<256>() : block_n<128>();
  if (!geometry_ok(q_geo, d, L, (long long)b * hq, kBlockM) ||
      !geometry_ok(kv_geo, d, L, (long long)b * hkv, kv_rows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 256) return launch<256>(q, k, v, o, hq, hkv, L, causal, window, grid, q_geo, kv_geo, s);
  return d == 128 ? launch<128>(q, k, v, o, hq, hkv, L, causal, window, grid, q_geo, kv_geo, s)
                  : launch<64>(q, k, v, o, hq, hkv, L, causal, window, grid, q_geo, kv_geo, s);
}
