// Fused neighbor sum and color-set combine:
//   out[v, b, s] = sum_j left[v, b, idx1[s, j]] * M[v, b, idx2[s, j]],
//   M[v, b, :]   = sum_{e in row v} right[indices[e], b, :]
// without writing M to device memory.
//
// Replaces fused_count_pallas (src/repro/kernels/fused_count.py).  One CTA
// per block of R destination rows and one coloring b.  Phase 1 builds the
// [R, W] block of M in dynamic shared memory with csr_row_sum (one warp per
// row, the SpMM kernel's exact edge order); after a barrier, phase 2 runs
// combine_dot (the combine kernel's exact j loop) for every (row, s) of the
// block, reading M from shared memory.  R comes from the host: R * W * 4
// bytes must fit the per-block shared memory limit.
#include "common.cuh"

namespace {

// 32 warps: at the widest right child one CTA fills an SM's shared memory,
// so the CTA itself must carry enough warps to keep gathers in flight.
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    fused_count_kernel(const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                       const float* __restrict__ left, const float* __restrict__ right,
                       const int32_t* __restrict__ pairs, float* __restrict__ out,
                       int64_t n_rows, int B, int A, int W, int S, int J, int ts, int R) {
  extern __shared__ float m_blk[];  // [R][W]
  const int b = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * R;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int64_t right_stride = (int64_t)B * W;
  for (int r = warp; r < R; r += n_warps) {
    const int64_t v = r0 + r;
    if (v < n_rows) {
      repro_torch::csr_row_sum(indptr, indices, right + (int64_t)b * W, right_stride, v, W,
                               m_blk + (int64_t)r * W);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * S; t += blockDim.x) {
    const int r = t / S;
    const int s = t - r * S;
    const int64_t v = r0 + r;
    if (v >= n_rows) break;  // t only grows, so every later t is past the end too
    const int64_t row = v * B + b;
    const int32_t* col = pairs + (int64_t)(s / ts) * J * ts + (s % ts);
    out[row * S + s] =
        repro_torch::combine_dot(left + row * A, m_blk + (int64_t)r * W, col, J, ts);
  }
}

}  // namespace

// Largest dynamic shared memory a block may opt in to on `device`, in bytes
// (negative: the CUDA error code, negated).
extern "C" int fused_count_smem_limit(int device) {
  int bytes = 0;
  cudaError_t err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -(int)err;
}

// left [n_rows, B, A], right [*, B, W], out [n_rows, B, S] float32
// contiguous; indptr [n_rows + 1] int64; indices int32; pairs the packed
// [ceil(S / ts)][J][ts] split table.  Returns the first CUDA error of the
// shared-memory opt-in or the launch.
extern "C" int fused_count_launch(const void* indptr, const void* indices, const void* left,
                                  const void* right, const void* pairs, void* out,
                                  long long n_rows, int B, int A, int W, int S, int J, int ts,
                                  int R, void* stream) {
  if (n_rows <= 0 || B <= 0 || S <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)R * W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((n_rows + R - 1) / R), (unsigned)B);
  fused_count_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int32_t*)indices, (const float*)left, (const float*)right,
      (const int32_t*)pairs, (float*)out, (int64_t)n_rows, B, A, W, S, J, ts, R);
  return (int)cudaGetLastError();
}
