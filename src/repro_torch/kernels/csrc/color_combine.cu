// Color-set combine: out[r, s] = sum_j left[r, idx1[s, j]] * m[r, idx2[s, j]],
// r over the (vertex, coloring) rows of [n, B, *] tables.
//
// Replaces color_combine_pallas (src/repro/kernels/color_combine.py).
//
// Design: one CTA (8 warps) per tile of T consecutive rows.  It stages
// left[tile, A] and m[tile, W] in shared memory column-major with an odd
// pitch (16-byte coalesced loads), then walks the output in chunks of SC
// columns (combine_tile.cuh): the chunk's packed split entries ([S][Jp], J
// padded to 4) land in shared memory by cp.async while the previous chunk
// is computed; a warp item is 32 rows x up to four output columns, so the
// lanes of a chain read the same four splits in one broadcast and one
// column of 32 rows from 32 banks, and each lane keeps up to four
// independent chains in flight; the chunk's outputs go back through shared
// memory and out one row per warp, coalesced.  Each output is
// combine_dot's fmaf chain over ascending j, the fused kernel's second
// phase, so the two paths agree bitwise.
//
// Routes by shape (kernels/color_combine.py plan_tile, deterministic): T is
// the largest of 128, 64, ..., 1 whose tile fits three CTAs an SM, raised
// to 32 where 32 rows fit two (the fewest CTAs an SM that keeps a warp on 32
// rows of one column), else the one that fits the most CTAs; SC keeps a
// chunk's split entries within 4 KB, between 32 and 128 columns (S where
// S is smaller); an item takes 4 columns, or 2 or 1 where a chunk has
// fewer.  u12-2's nodes take T = 128 (12, 12, 66: SC = S), 64 (12, 66,
// 220), 32 (12, 220, 495 and 220, 495, 792) and 16 (12, 792, 495 and the
// root, S = 1, one chain a lane); tiles below 32 rows (the root, u14's and
// u15's widest nodes) split a warp's lanes over output columns.
//
// Bound (H100): at (220, 495, 792, 35) the FMAs' operands: with both staged
// in shared memory and no reuse in registers, an FMA reads 2.25 wavefronts of
// 128 bytes, so 4,194,816 rows x 792 x 35 FMAs take about 28 ms at 128 bytes
// a clock an SM; the bytes take 7.5 ms at the HBM rate.  The other u12-2
// nodes, and the root (S = 1), are bound by their bytes.  The earlier design
// (one thread per (row, s), operands read at scattered columns through L1)
// ran at 6.3x its bound over a u12-2 pass.
#include <mutex>

#include "combine_tile.cuh"

namespace {

using repro_torch::kTileThreads;

// held from the shared-memory opt-in to the launch (see the launch)
std::mutex launch_mutex;

template <int kCols>
__global__ void __launch_bounds__(kTileThreads, 2)
    color_combine_kernel(const float* __restrict__ left, const float* __restrict__ m,
                         const int32_t* __restrict__ pairs, float* __restrict__ out, int64_t rows,
                         int A, int W, int S, int J, int Jp, int T, int SC) {
  extern __shared__ __align__(16) unsigned char smem[];
  const repro_torch::TileSmem sm = repro_torch::tile_smem(smem, T, A, W, SC, Jp);
  const int pitch = repro_torch::tile_pitch(T);
  const int64_t first = (int64_t)blockIdx.x * T;
  const int nrows = (int)min((int64_t)T, rows - first);
  repro_torch::stage_rows(left + first * A, nrows, A, sm.left, pitch);
  repro_torch::stage_rows(m + first * W, nrows, W, sm.m, pitch);
  repro_torch::combine_tile<kCols>(sm, pairs, out, first, nrows, T, S, J, Jp, SC);
}

}  // namespace

// Shared memory of `device`, in bytes: out[0] the most a block may opt in
// to, out[1] an SM's, out[2] what the runtime reserves a block.  Returns 0
// or the first CUDA error.
extern "C" int combine_smem_limits(int device, int* out) {
  const cudaDeviceAttr attrs[3] = {cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                   cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = cudaDeviceGetAttribute(out + i, attrs[i], device);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// left [rows, A], m [rows, W], out [rows, S] float32 contiguous; pairs the
// packed [S][Jp] int32 split table (16-byte aligned); T rows a tile, SC
// output columns a chunk, cols (1, 2 or 4) a warp item (plan_tile).
// Returns the first CUDA error of the shared-memory opt-in or the launch.
extern "C" int color_combine_launch(const void* left, const void* m, const void* pairs, void* out,
                                    long long rows, int A, int W, int S, int J, int Jp, int T,
                                    int SC, int cols, void* stream) {
  if (rows <= 0 || S <= 0) return (int)cudaGetLastError();
  const size_t smem = repro_torch::tile_smem_bytes(T, A, W, SC, Jp);
  if (cols != 1 && cols != 2 && cols != 4) return (int)cudaErrorInvalidValue;
  auto kernel = cols == 4   ? color_combine_kernel<4>
                : cols == 2 ? color_combine_kernel<2>
                            : color_combine_kernel<1>;
  const long long tiles = (rows + T - 1) / T;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // the opt-in is the kernel's, not the launch's: threads of one process
  // (a LocalMesh's ranks) must not lower it between another's opt-in and
  // launch
  std::lock_guard<std::mutex> hold(launch_mutex);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)tiles, kTileThreads, smem, (cudaStream_t)stream>>>(
      (const float*)left, (const float*)m, (const int32_t*)pairs, (float*)out, (int64_t)rows, A, W,
      S, J, Jp, T, SC);
  return (int)cudaGetLastError();
}
