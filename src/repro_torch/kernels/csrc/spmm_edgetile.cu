// Neighbor-sum SpMM over the CSR: out[v, f] = sum_{e in row v} table[indices[e], f]
// for every column f of the flattened F = B * W row.
//
// Replaces spmm_edge_tile_pallas (src/repro/kernels/spmm_edgetile.py).
//
// Bound (H100): bytes.  Every edge gathers one F-float source row, E * F * 4
// bytes, against E * F adds (0.25 flop/byte); the contract (table, CSR and
// output moved once) is far below that.  On the main cell (R-MAT 2^20 / 10M,
// F = 3168 at W = 792, B = 4) the gathers are 253 GB, 75.6 ms at 3.35 TB/s,
// and the table (13.3 GB) is far larger than the 50 MB L2.
//
// What held the earlier design back (one warp per (row, coloring), 32 columns
// a pass, one float a lane): it walked a row's index list once per 32
// columns per coloring (100 times at W = 792, B = 4), kept four 128-byte
// gathers in flight a warp, left a hub row to one warp per coloring, and
// swept every column of the table at once, so no gather hit L2.  It reached
// half of the HBM gather rate.
//
// This design: the work unit is (row v, chunk of 128 floats of the F-float
// row); one warp owns it and sums it with csr_chunk_sum (common.cuh): lanes
// gather a float4 each (512 B a warp instruction), eight gathers in flight
// a warp, indices loaded 32 at a time.  A hub row is split by columns into
// F / 128 warps, never by edges, so each element still adds its neighbors in
// CSR order into one accumulator that starts at 0 (the order fused_count.cu's
// csr_chunk_gather uses, and spmm_block.cu's).  Rows run on blockIdx.x
// and chunks on blockIdx.y, so the CTAs resident at once share one chunk:
// its source slice is n_rows * 512 B (33.5 MB on the dense cell, 2^16
// vertices, which stays in L2; 537 MB on the main cell, which does not).
// The indices are read once per chunk (25 x 80 MB on the main cell at
// W = 792, 0.6 ms at HBM rate).  No atomics: every output element is written
// once, so the result is deterministic, and rows without edges (zero-degree
// and pad rows) come out exactly zero.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 128;  // floats of the flattened row per warp

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    spmm_csr_kernel(const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                    const float* __restrict__ table, float* __restrict__ out, int64_t n_rows,
                    int64_t width) {
  const int64_t v = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (v >= n_rows) return;  // the whole warp leaves together
  const int64_t c0 = (int64_t)blockIdx.y * kChunk;
  repro_torch::csr_chunk_sum<kVec>(indptr, indices, table + c0, width, v,
                                   (int)min((int64_t)kChunk, width - c0), out + v * width + c0);
}

}  // namespace

// table and out are [n_rows, width] float32 (width = B * W), contiguous;
// indptr [n_rows + 1] int64; indices int32.  vec != 0 promises width % 4 == 0
// and 16-byte aligned table and out.  Returns cudaGetLastError() after the
// launch.
extern "C" int spmm_edgetile_launch(const void* indptr, const void* indices, const void* table,
                                    void* out, long long n_rows, long long width, int vec,
                                    void* stream) {
  if (n_rows <= 0 || width <= 0) return (int)cudaGetLastError();
  const long long chunks = (width + kChunk - 1) / kChunk;
  const long long row_blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (chunks > 65535 || row_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)row_blocks, (unsigned)chunks);
  if (vec)
    spmm_csr_kernel<true><<<grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        (const int64_t*)indptr, (const int32_t*)indices, (const float*)table, (float*)out,
        (int64_t)n_rows, (int64_t)width);
  else
    spmm_csr_kernel<false><<<grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        (const int64_t*)indptr, (const int32_t*)indices, (const float*)table, (float*)out,
        (int64_t)n_rows, (int64_t)width);
  return (int)cudaGetLastError();
}
