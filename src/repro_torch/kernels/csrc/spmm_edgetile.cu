// Neighbor-sum SpMM over the CSR: out[v, b, :] = sum_{e in row v} table[indices[e], b, :].
//
// Replaces spmm_edge_tile_pallas (src/repro/kernels/spmm_edgetile.py).  One
// warp per (destination row, coloring), lanes over the W columns of that
// coloring; see csr_row_sum in common.cuh for the edge walk.  No atomics:
// every output element is written once, by the warp that owns its row, so
// the result is deterministic, and rows with no edges (zero-degree and pad
// rows) come out exactly zero.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    spmm_csr_kernel(const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                    const float* __restrict__ table, float* __restrict__ out, int64_t n_rows,
                    int B, int W) {
  const int64_t v = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (v >= n_rows) return;  // the whole warp leaves together
  const int b = blockIdx.y;
  const int64_t row_stride = (int64_t)B * W;
  repro_torch::csr_row_sum(indptr, indices, table + (int64_t)b * W, row_stride, v, W,
                           out + v * row_stride + (int64_t)b * W);
}

}  // namespace

// table and out are [n_rows, B, W] float32, contiguous; indptr [n_rows + 1]
// int64; indices int32.  Returns cudaGetLastError() after the launch.
extern "C" int spmm_edgetile_launch(const void* indptr, const void* indices, const void* table,
                                    void* out, long long n_rows, int B, int W, void* stream) {
  if (n_rows <= 0 || B <= 0 || W <= 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock), (unsigned)B);
  spmm_csr_kernel<<<grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int32_t*)indices, (const float*)table, (float*)out,
      (int64_t)n_rows, B, W);
  return (int)cudaGetLastError();
}
