// Block-dense SpMM over 128x128 0/1 patches:
//   out[128 R + r, c] = sum_{p in row block R} sum_k bit_p[r][k] * table[128 col_p + k, c]
// for every column c of the flattened [B * W] row.
//
// Replaces spmm_block_pallas (src/repro/kernels/spmm_edgetile.py), a dense
// MXU matmul per float32 patch.  The patches of a row block are a contiguous
// range of the patch CSR, sorted by column block.  The kernel reads each
// patch through what the plan derives from its bitmask (ops._block_layout):
// its column union (the OR of its rows, [4] uint32: the source rows it
// uses), and its edges as staging slots, row by row in CSR order (int16 row
// offsets, [136], then one uint8 slot an edge, padded to 16 bytes).  The
// slot of source column k is the popcount of the union's bits below k.
//
// Bound (H100, dense cell: W = 792, B = 16, 262,144 patches): the contract
// moves patches, table and output once, 7.2 GB = 2.15 ms at 3.35 TB/s, and
// does 3.7e11 adds = 11.1 ms at 33.5e12 float32 adds/s (the data sheet's
// 67 TFLOP/s counts an FMA as two): operations bound by the contract.  The
// design's own traffic is the staging of the source rows each patch uses:
// 0.384 of 128 per patch on the dense cell, 653 GB at W = 792 (195 ms if
// all of it came from device memory; the resident CTAs share one column
// tile whose source rows, 65,536 x 512 B = 33.5 MB, fit the 50 MB L2).
//
// What held the earlier design back: each patch was a serial chain of four
// barriers, a bitmask load, warp 0 alone computing the column union while
// seven warps waited, and a staging of the used rows with plain loads that
// every thread waited on, for 56 adds a thread; nothing of the next patch
// was in flight.  It ran at about 5.9 us a patch step, a third of its
// staging bytes' HBM rate: bound by latency.
//
// This design, one CTA per (row block, 128-float column tile), blockIdx.x
// over row blocks so that the CTAs resident at once share a column tile, two
// CTAs an SM:
//   * a ring of 2-4 stages in dynamic shared memory, each with a "full" and
//     an "empty" mbarrier, each holding one patch's slot lists and its used
//     source rows' tile segments packed by slot (room for the plan's largest
//     list and union popcount, not for 128 rows);
//   * two producer warps run ahead of the consumers: they read 32 patches'
//     column blocks, unions and list offsets at a time, and for each patch
//     issue bulk asynchronous copies (cp.async.bulk, completion on the full
//     barrier by bytes) of the lists and of each used row's 512-byte
//     segment, lane l of warp w copying source columns 32 v + l of the union
//     words v = w, w + 2.  Tables whose rows are not 16-byte aligned take
//     4-byte cp.async copies for the rows, tracked by the same barrier;
//   * 16 consumer warps of 8 destination rows each wait on the full
//     barrier, add the staged float4 of their lane for each edge of each row
//     in list order into register accumulators that live across all the row
//     block's patches, and arrive on the empty barrier.  No __syncthreads
//     runs per patch.
// The slot lists replace a walk of the bitmask's set bits in the kernel,
// which cost a branch for each of a warp's 32 row words a patch (most of
// them empty: 112 edges over 512 words on the dense cell) and took most of
// the kernel's time on the card; a list costs a byte load an edge.  The
// tile stays 128 floats: at 256 the resident CTAs' source slice (67 MB on
// the dense cell) no longer fits L2, and a stage would double.
// The accumulators start at 0 and every row's edges arrive in CSR order
// (ascending source column, patches in ascending column block), so the sums
// are those of csr_chunk_gather and csr_chunk_sum (common.cuh) term for term:
// spmm_block == spmm_edgetile bitwise.  The output is written once; rows of
// a row block without a patch come out 0.  No atomics.
#include "common.cuh"
#include "mbarrier.cuh"

namespace {

using repro_torch::mbar_arrive;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::smem_addr;

constexpr int kBlock = 128;  // patch edge: destination rows and source columns
constexpr int kTile = 128;   // floats of the flattened B*W row per CTA
constexpr int kWords = kBlock / 32;
constexpr int kConsumerWarps = 16;
constexpr int kProducerWarps = 2;
constexpr int kRowsPerWarp = kBlock / kConsumerWarps;
constexpr int kThreads = (kConsumerWarps + kProducerWarps) * 32;
constexpr int kMaxStages = 4;
constexpr int kCtasPerSm = 2;
constexpr int kOffs = 136;            // int16 row offsets per patch (ops.PATCH_OFFS)
constexpr int kOffsBytes = kOffs * 2;  // 272, a multiple of 16
constexpr int kRowBytes = kTile * 4;
static_assert(kRowsPerWarp == 8, "a warp reads its rows' offsets as one 16-byte word");

// stage: [row offsets, kOffsBytes][slots, max_slots][rows, max_used x kRowBytes]
int stage_size(int max_used, int max_slots) {
  return (kOffsBytes + max_slots + max_used * kRowBytes + 127) / 128 * 128;
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory; completes on `bar` by bytes
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void add(float4& acc, const float4 x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    spmm_block_kernel(const int* __restrict__ patch_ptr, const int* __restrict__ patch_col,
                      const uint4* __restrict__ patch_union, const int16_t* __restrict__ patch_offs,
                      const uint8_t* __restrict__ patch_slots,
                      const int64_t* __restrict__ patch_slots_ptr, const float* __restrict__ table,
                      float* __restrict__ out, int64_t width, int max_used, int max_slots,
                      int stage_bytes, int n_stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t rb = blockIdx.x;
  const int64_t c0 = (int64_t)blockIdx.y * kTile;
  const int ncols = (int)min((int64_t)kTile, width - c0);
  const int rows_at = kOffsBytes + max_slots;  // staged rows, 16-byte aligned
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + n_stages * stage_bytes;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kMaxStages + s); };
  const int p_begin = __ldg(patch_ptr + rb);
  const int p_end = __ldg(patch_ptr + rb + 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      // each producer warp arrives once, with the bytes it stages (and each
      // producer lane once more through its cp.async copies if !kVec)
      mbar_init(full_bar(s), kProducerWarps * (kVec ? 1 : 33));
      mbar_init(empty_bar(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producers: patch i of the row block goes to stage i % n_stages; warp pw
    // stages the used source columns of the union words pw, pw + kProducerWarps, ...
    const int pw = warp - kConsumerWarps;
    for (int g = p_begin; g < p_end; g += 32) {
      int my_col = 0;
      uint4 my_u = make_uint4(0u, 0u, 0u, 0u);
      int64_t my_list = 0, my_list_end = 0;
      if (g + lane < p_end) {
        my_col = __ldg(patch_col + g + lane);
        my_u = __ldg(patch_union + g + lane);
        my_list = __ldg(patch_slots_ptr + g + lane);
        my_list_end = __ldg(patch_slots_ptr + g + lane + 1);
      }
      const int n_g = min(32, p_end - g);
      for (int j = 0; j < n_g; ++j) {
        const int p = g + j;
        const int i = p - p_begin;
        const int s = i % n_stages;
        const int col = __shfl_sync(repro_torch::kFullMask, my_col, j);
        const uint32_t u[kWords] = {__shfl_sync(repro_torch::kFullMask, my_u.x, j),
                                    __shfl_sync(repro_torch::kFullMask, my_u.y, j),
                                    __shfl_sync(repro_torch::kFullMask, my_u.z, j),
                                    __shfl_sync(repro_torch::kFullMask, my_u.w, j)};
        const int64_t list = __shfl_sync(repro_torch::kFullMask, my_list, j);
        const int list_bytes = (int)(__shfl_sync(repro_torch::kFullMask, my_list_end, j) - list);
        int slot0[kWords + 1] = {0};
        int mine = 0;  // used rows this warp stages
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          slot0[w + 1] = slot0[w] + __popc(u[w]);
          if (w % kProducerWarps == pw) mine += __popc(u[w]);
        }
        if (slot0[kWords] > max_used || list_bytes > max_slots) __trap();  // they size the ring
        mbar_wait(empty_bar(s), ((i / n_stages) & 1) ^ 1);
        const uint32_t st = base + s * stage_bytes;
        const float* src = table + (int64_t)col * kBlock * width + c0;
        if (lane == 0) {
          mbar_expect_tx(full_bar(s),
                         (pw == 0 ? kOffsBytes + list_bytes : 0) + (kVec ? mine * ncols * 4 : 0));
          if (pw == 0) {
            bulk_copy(st, patch_offs + (int64_t)p * kOffs, kOffsBytes, full_bar(s));
            bulk_copy(st + kOffsBytes, patch_slots + list, list_bytes, full_bar(s));
          }
        }
        __syncwarp();
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          if (w % kProducerWarps != pw) continue;
          if (kVec) {
            // lane l copies source column 32 w + l, if used
            if ((u[w] >> lane) & 1u) {
              const int slot = slot0[w] + __popc(u[w] & ((1u << lane) - 1u));
              bulk_copy(st + rows_at + slot * kRowBytes, src + (int64_t)(32 * w + lane) * width,
                        ncols * 4, full_bar(s));
            }
          } else {
            // the word's used rows in slot order, lane l copying columns l + 32 q
            int slot = slot0[w];
            for (uint32_t m = u[w]; m; m &= m - 1u, ++slot) {
              const float* row = src + (int64_t)(32 * w + __ffs(m) - 1) * width;
              const uint32_t dst = st + rows_at + slot * kRowBytes;
#pragma unroll
              for (int q = 0; q < kTile / 32; ++q) {
                const int c = lane + 32 * q;
                if (c < ncols) cp_async4(dst + 4 * c, row + c);
              }
            }
          }
        }
        if (!kVec) cp_async_arrive(full_bar(s));
      }
    }
    return;
  }

  // consumers: warp w owns destination rows kRowsPerWarp w .. + kRowsPerWarp - 1,
  // lane l their columns 4 l .. 4 l + 3 of the tile
  float4 acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int n_patches = p_end - p_begin;
  for (int i = 0; i < n_patches; ++i) {
    const int s = i % n_stages;
    mbar_wait(full_bar(s), (i / n_stages) & 1);
    const unsigned char* st = smem + s * stage_bytes;
    const int16_t* offs = reinterpret_cast<const int16_t*>(st) + kRowsPerWarp * warp;
    const uint8_t* slots = st + kOffsBytes;
    const float4* rows = reinterpret_cast<const float4*>(st + rows_at) + lane;
    const uint4 o = *reinterpret_cast<const uint4*>(offs);  // the rows' first edges
    const int bound[kRowsPerWarp + 1] = {
        (int)(o.x & 0xffffu), (int)(o.x >> 16), (int)(o.y & 0xffffu), (int)(o.y >> 16),
        (int)(o.z & 0xffffu), (int)(o.z >> 16), (int)(o.w & 0xffffu), (int)(o.w >> 16),
        offs[kRowsPerWarp]};
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      int e = bound[r];
      for (; e + 2 <= bound[r + 1]; e += 2) {
        const float4 x0 = rows[slots[e] * (kTile / 4)];
        const float4 x1 = rows[slots[e + 1] * (kTile / 4)];
        add(acc[r], x0);
        add(acc[r], x1);
      }
      if (e < bound[r + 1]) add(acc[r], rows[slots[e] * (kTile / 4)]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(s));
  }

  const int c = 4 * lane;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* dst = out + (rb * kBlock + warp * kRowsPerWarp + r) * width + c0 + c;
    if (kVec) {
      if (c < ncols) *reinterpret_cast<float4*>(dst) = acc[r];
    } else {
      if (c < ncols) dst[0] = acc[r].x;
      if (c + 1 < ncols) dst[1] = acc[r].y;
      if (c + 2 < ncols) dst[2] = acc[r].z;
      if (c + 3 < ncols) dst[3] = acc[r].w;
    }
  }
}

}  // namespace

// patch_ptr int32 [n_row_blocks + 1], patch_col int32 [NB], patch_union
// uint32 [NB, 4], patch_offs int16 [NB, 136], patch_slots uint8 and
// patch_slots_ptr int64 [NB + 1] as ops.SpmmPlan holds them (unions, offsets
// and slots 16-byte aligned); max_used (0..128) and max_slots bound every
// patch's union popcount and padded list (a patch above either traps).
// table and out float32 [n_row_blocks * 128, width], contiguous.  vec != 0
// promises width % 4 == 0 and 16-byte aligned table and out.  Returns the
// first CUDA error of the set-up or the launch.
extern "C" int spmm_block_launch(const void* patch_ptr, const void* patch_col,
                                 const void* patch_union, const void* patch_offs,
                                 const void* patch_slots, const void* patch_slots_ptr,
                                 const void* table, void* out, int n_row_blocks, long long width,
                                 int max_used, int max_slots, int vec, void* stream) {
  if (n_row_blocks <= 0 || width <= 0) return (int)cudaGetLastError();
  if ((width + kTile - 1) / kTile > 65535 || max_used < 0 || max_used > kBlock || max_slots < 0 ||
      max_slots % 16)
    return (int)cudaErrorInvalidConfiguration;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  // as many stages as fit kCtasPerSm CTAs in the SM's 228 KB (1 KB each reserved)
  const int stage = stage_size(max_used, max_slots);
  const int bar_bytes = 2 * kMaxStages * 8;
  const int budget = min(optin, 228 * 1024 / kCtasPerSm - 1024);
  int n_stages = kMaxStages;
  while (n_stages > 2 && n_stages * stage + bar_bytes > budget) --n_stages;
  const int smem = n_stages * stage + bar_bytes;
  if (smem > optin) return (int)cudaErrorInvalidConfiguration;
  auto kernel = vec ? spmm_block_kernel<true> : spmm_block_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)n_row_blocks, (unsigned)((width + kTile - 1) / kTile));
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)patch_ptr, (const int*)patch_col, (const uint4*)patch_union,
      (const int16_t*)patch_offs, (const uint8_t*)patch_slots, (const int64_t*)patch_slots_ptr,
      (const float*)table, (float*)out, (int64_t)width, max_used, max_slots, stage, n_stages);
  return (int)cudaGetLastError();
}
