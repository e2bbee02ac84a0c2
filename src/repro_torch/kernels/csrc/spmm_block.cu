// Block-dense SpMM over 128x128 0/1 patches:
//   out[128 R + r, c] = sum_{p in row block R} sum_k bit_p[r][k] * table[128 col_p + k, c]
// for every column c of the flattened [B * W] row.
//
// Replaces spmm_block_pallas (src/repro/kernels/spmm_edgetile.py), a dense
// MXU matmul per float32 patch.  Here a patch is a bitmask, [128 rows][4
// words] of uint32 (bit k % 32 of word k / 32 is source column k), and the
// patches of a row block are a contiguous range of the patch CSR, sorted
// by column block.
//
// One CTA per (row block, 128-float column tile); blockIdx.x runs over row
// blocks, so the CTAs resident at once share a column tile.  Per patch:
//   1. load the bitmask (2 KB) into shared memory;
//   2. warp 0 ORs the 128 rows' words into the set of source columns the
//      patch uses and lists them in ascending order;
//   3. the CTA stages those source rows' tile (512 B each) in shared memory;
//   4. warp w owns destination rows 16 w .. 16 w + 15; for each row it walks
//      the row's set bits in ascending k (the loop bound is the row's mask,
//      uniform over the warp) and lane l adds staged columns 4 l .. 4 l + 3
//      into its register accumulators.
// The accumulators live across all patches of the row block and start at
// 0, and every row's neighbors arrive in ascending source order, so the
// sums are those of csr_row_sum (common.cuh) term for term: spmm_block ==
// spmm_edgetile bitwise.  The output is written once; rows of a row block
// without a patch come out 0.  No atomics.
//
// Bound (H100, dense cell: W = 792, B = 16, 262,144 patches): the contract
// moves patches, table and output once, 7.2 GB = 2.15 ms at 3.35 TB/s, and
// does 3.7e11 adds = 11.1 ms at 33.5e12 float32 adds/s (the data sheet's
// 67 TFLOP/s counts an FMA as two): operations bound by the contract.
// The design's own traffic is the staging, up to 1.70 TB through shared memory (508 ms if all of it came from device memory); the resident
// CTAs share one column tile whose source rows (34 MB) fit the 50 MB L2.
#include "common.cuh"

namespace {

constexpr int kBlock = 128;  // patch edge: destination rows and source columns
constexpr int kTile = 128;   // floats of the flattened B*W row per CTA
constexpr int kWords = kBlock / 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlock / kWarps;

struct Smem {
  float4 src[kBlock][kTile / 4];  // staged source rows of this tile, 64 KB
  uint32_t bits[kBlock][kWords];  // the patch, 2 KB
  int used[kBlock];               // source columns with a set bit, ascending
  int n_used;
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    spmm_block_kernel(const int* __restrict__ patch_ptr, const int* __restrict__ patch_col,
                      const uint32_t* __restrict__ patch_bits, const float* __restrict__ table,
                      float* __restrict__ out, int64_t width) {
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t rb = blockIdx.x;
  const int64_t c0 = (int64_t)blockIdx.y * kTile;
  const int ncols = (int)min((int64_t)kTile, width - c0);

  float acc[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  const int p_end = patch_ptr[rb + 1];
  for (int p = patch_ptr[rb]; p < p_end; ++p) {
    __syncthreads();  // every warp is done with the previous patch
    const uint32_t* pb = patch_bits + (int64_t)p * kBlock * kWords;
    for (int i = tid; i < kBlock * kWords; i += kThreads) (&s.bits[0][0])[i] = __ldg(pb + i);
    __syncthreads();
    if (warp == 0) {
      int base = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        uint32_t m = 0;
        for (int r = lane; r < kBlock; r += 32) m |= s.bits[r][w];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m |= __shfl_xor_sync(repro_torch::kFullMask, m, off);
        const bool has = (m >> lane) & 1u;
        const unsigned ballot = __ballot_sync(repro_torch::kFullMask, has);
        if (has) s.used[base + __popc(ballot & ((1u << lane) - 1u))] = w * 32 + lane;
        base += __popc(ballot);
      }
      if (lane == 0) s.n_used = base;
    }
    __syncthreads();
    const int n_used = s.n_used;
    const float* src = table + (int64_t)patch_col[p] * kBlock * width + c0;
    if (kVec) {
      // width % 4 == 0, so ncols % 4 == 0 and every row start is 16-byte aligned
      const int nvec = ncols >> 2;
      for (int i = tid; i < n_used * (kTile / 4); i += kThreads) {
        const int k = s.used[i / (kTile / 4)];
        const int q = i % (kTile / 4);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (q < nvec) v = __ldg(reinterpret_cast<const float4*>(src + (int64_t)k * width) + q);
        s.src[k][q] = v;
      }
    } else {
      for (int i = tid; i < n_used * kTile; i += kThreads) {
        const int k = s.used[i / kTile];
        const int c = i % kTile;
        reinterpret_cast<float*>(s.src[k])[c] = c < ncols ? __ldg(src + (int64_t)k * width + c) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        uint32_t m = s.bits[r][w];
        while (m) {
          const int k = w * 32 + __ffs(m) - 1;
          m &= m - 1;
          const float4 x = s.src[k][lane];
          acc[i][0] += x.x;
          acc[i][1] += x.y;
          acc[i][2] += x.z;
          acc[i][3] += x.w;
        }
      }
    }
  }

  const int c = 4 * lane;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float* dst = out + (rb * kBlock + warp * kRowsPerWarp + i) * width + c0 + c;
    if (kVec) {
      if (c < ncols) *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c + q < ncols) dst[q] = acc[i][q];
    }
  }
}

template <bool kVec>
int launch(const int* patch_ptr, const int* patch_col, const uint32_t* patch_bits,
           const float* table, float* out, int n_row_blocks, int64_t width, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(spmm_block_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)n_row_blocks, (unsigned)((width + kTile - 1) / kTile));
  spmm_block_kernel<kVec><<<grid, kThreads, smem, stream>>>(patch_ptr, patch_col, patch_bits,
                                                           table, out, width);
  return (int)cudaGetLastError();
}

}  // namespace

// patch_ptr int32 [n_row_blocks + 1], patch_col int32 [NB], patch_bits uint32
// [NB, 128, 4]; table and out float32 [n_row_blocks * 128, width], contiguous.
// vec != 0 promises width % 4 == 0 and 16-byte aligned table and out.
// Returns cudaGetLastError() after the launch.
extern "C" int spmm_block_launch(const void* patch_ptr, const void* patch_col,
                                 const void* patch_bits, const void* table, void* out,
                                 int n_row_blocks, long long width, int vec, void* stream) {
  if (n_row_blocks <= 0 || width <= 0) return (int)cudaGetLastError();
  if ((width + kTile - 1) / kTile > 65535) return (int)cudaErrorInvalidConfiguration;
  if (vec)
    return launch<true>((const int*)patch_ptr, (const int*)patch_col, (const uint32_t*)patch_bits,
                        (const float*)table, (float*)out, n_row_blocks, (int64_t)width,
                        (cudaStream_t)stream);
  return launch<false>((const int*)patch_ptr, (const int*)patch_col, (const uint32_t*)patch_bits,
                       (const float*)table, (float*)out, n_row_blocks, (int64_t)width,
                       (cudaStream_t)stream);
}
