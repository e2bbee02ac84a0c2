// Color-set combine: out[r, s] = sum_j left[r, idx1[s, j]] * m[r, idx2[s, j]],
// r over the (vertex, coloring) rows of [n, B, *] tables.
//
// Replaces color_combine_pallas (src/repro/kernels/color_combine.py).  One
// thread per (row, s): blockDim = (ts, 256 / ts) puts ts output columns of
// one s-tile on x and rows on y; each block stages its s-tile's packed
// split entries ([J][ts] int32) in shared memory when they fit in 48 KB,
// else reads them through the read-only path, and then strides over rows.
// The j loop is combine_dot (common.cuh): fmaf in ascending j, the same
// arithmetic as the fused kernel's second phase.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 48 * 1024;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
    color_combine_kernel(const float* __restrict__ left, const float* __restrict__ m,
                         const int32_t* __restrict__ pairs, float* __restrict__ out,
                         int64_t rows, int A, int Bw, int S, int J, int ts, int stage) {
  extern __shared__ int32_t s_pairs[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int32_t* g_tile = pairs + (int64_t)blockIdx.x * J * ts;
  if (stage) {
    for (int i = ty * ts + tx; i < J * ts; i += ts * blockDim.y) s_pairs[i] = __ldg(g_tile + i);
    __syncthreads();
  }
  const int32_t* col = (stage ? (const int32_t*)s_pairs : g_tile) + tx;
  const int s = blockIdx.x * ts + tx;
  if (s >= S) return;  // no barrier follows
  for (int64_t r = (int64_t)blockIdx.y * blockDim.y + ty; r < rows;
       r += (int64_t)gridDim.y * blockDim.y) {
    out[r * S + s] = repro_torch::combine_dot(left + r * A, m + r * Bw, col, J, ts);
  }
}

}  // namespace

// left [rows, A], m [rows, Bw], out [rows, S] float32 contiguous; pairs is
// the packed [ceil(S / ts)][J][ts] int32 split table.  Returns
// cudaGetLastError() after the launch.
extern "C" int color_combine_launch(const void* left, const void* m, const void* pairs, void* out,
                                    long long rows, int A, int Bw, int S, int J, int ts,
                                    void* stream) {
  if (rows <= 0 || S <= 0) return (int)cudaGetLastError();
  const int ry = kThreads / ts;
  const int n_tiles = (S + ts - 1) / ts;
  const long long want_y = (rows + ry - 1) / ry;
  dim3 grid((unsigned)n_tiles, (unsigned)(want_y < kMaxGridY ? want_y : kMaxGridY));
  const size_t stage_bytes = (size_t)J * ts * sizeof(int32_t);
  const int stage = stage_bytes <= (size_t)kStageBytes;
  color_combine_kernel<<<grid, dim3(ts, ry), stage ? stage_bytes : 0, (cudaStream_t)stream>>>(
      (const float*)left, (const float*)m, (const int32_t*)pairs, (float*)out, (int64_t)rows, A,
      Bw, S, J, ts, stage);
  return (int)cudaGetLastError();
}
