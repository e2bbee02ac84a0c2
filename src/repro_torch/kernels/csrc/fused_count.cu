// Fused neighbor sum and color-set combine:
//   out[v, b, s] = sum_j left[v, b, idx1[s, j]] * M[v, b, idx2[s, j]],
//   M[v, b, :]   = sum_{e in row v} right[indices[e], b, :]
// without writing M to device memory.
//
// Replaces fused_count_pallas (src/repro/kernels/fused_count.py).
//
// Design: one CTA (8 warps) per tile of V whole vertices, so its rows are the
// V x B (vertex, coloring) rows, one contiguous run of the tables.
//   Phase 1 is the edge kernel's walk: the work unit is (vertex, 128-float
//   chunk of its F = B W neighbor row), one warp sums it with
//   csr_chunk_gather (float4 gathers, eight in flight; the scalar variant
//   where B W is not a multiple of 4).  Warps take units in turn from a
//   counter in shared memory, so a hub's chunks spread over all eight warps
//   and a warp that drew short walks takes more.
//   Each lane writes its sums into the tile's M buffer in shared memory,
//   column-major, the layout phase 2 reads; left's rows are staged beside.
//   Phase 2 is the combine kernel's (combine_tile.cuh), with at most two
//   columns an item (registers: four CTAs an SM).
// The phases overlap across CTAs: tiles are sized so that four CTAs fit an
// SM wherever they can (plan_tile in kernels/color_combine.py: 2 vertices
// at W = 792 and (220, 495, 792), 41-46 KB), and then the kernel is built
// for four CTAs an SM, 64 registers a thread (else three, 80), so one CTA's
// gathers run under another's contraction.  Where one vertex's B rows do
// not fit a CTA (wide nodes at large B), a tile is one vertex and a group of
// its colorings (grid.y), gathering only those colorings' columns.
//
// Every element of M is csr_chunk_gather's CSR-order sum, term for term
// spmm_edgetile's, and every output combine_dot's chain, term for term
// color_combine's: fused and unfused agree bitwise at any size.  M exists
// only as one tile in shared memory.
//
// Bound (H100): the gathers, E_dir x B x W x 4 bytes (234.4 ms over a u12-2
// pass on the main cell at the HBM rate), with the contraction (about 30 ms
// at (220, 495, 792, 35)) under them; unlike the edge kernel, whose grid
// runs chunk-major, the concurrent tiles share no source rows to speak of,
// so no gather comes from L2.  The earlier design (one 1024-thread CTA per
// 64 rows and one coloring, each row's walk one warp's, 32 columns a pass)
// filled an SM with one CTA at W >= 495 and ran at 53.9x its bound.
#include <mutex>

#include "combine_tile.cuh"

namespace {

using repro_torch::kTileThreads;
using repro_torch::kTileWarps;

// held from the shared-memory opt-in to the launch (see the launch)
std::mutex launch_mutex;

template <bool kVec, int kCols, int kMinBlocks>
__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
    fused_count_kernel(const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                       const float* __restrict__ left, const float* __restrict__ right,
                       const int32_t* __restrict__ pairs, float* __restrict__ out,
                       int64_t n_rows, int B, int A, int W, int S, int J, int Jp, int V, int Bt,
                       int SC) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int next_unit;
  const int T = V * Bt;
  const int pitch = repro_torch::tile_pitch(T);
  const repro_torch::TileSmem sm = repro_torch::tile_smem(smem, T, A, W, SC, Jp);
  const int64_t v0 = (int64_t)blockIdx.x * V;
  const int b0 = blockIdx.y * Bt;
  const int nv = (int)min((int64_t)V, n_rows - v0);
  const int nb = min(Bt, B - b0);
  // V > 1 only with Bt == B, so the tile's rows (v0 + i) B + b0 + b, i < nv,
  // b < nb, are the run [first, first + nv nb), tile row i Bt + b
  const int64_t first = v0 * B + b0;
  const int nrows = nv * nb;
  if (threadIdx.x == 0) next_unit = kTileWarps;
  repro_torch::stage_rows(left + first * A, nrows, A, sm.left, pitch);
  __syncthreads();
  const int F = nb * W;
  const int n_chunks = (F + 127) / 128;
  const int lane = threadIdx.x & 31;
  const float* src = right + (int64_t)b0 * W;
  for (int u = threadIdx.x >> 5; u < nv * n_chunks;) {
    const int i = u / n_chunks;
    const int c0 = (u - i * n_chunks) * 128;
    const int ncols = min(128, F - c0);
    const float4 acc = repro_torch::csr_chunk_gather<kVec>(indptr, indices, src + c0,
                                                           (int64_t)B * W, v0 + i, ncols);
    const float vals[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = kVec ? 4 * lane + k : lane + 32 * k;
      if (f < ncols) {
        const int b = (c0 + f) / W;
        sm.m[(c0 + f - b * W) * pitch + i * Bt + b] = vals[k];
      }
    }
    int nu = 0;
    if (lane == 0) nu = atomicAdd(&next_unit, 1);
    u = __shfl_sync(repro_torch::kFullMask, nu, 0);
  }
  repro_torch::combine_tile<kCols>(sm, pairs, out, first, nrows, T, S, J, Jp, SC);
}

template <bool kVec, int kCols>
cudaError_t launch(int per_sm, dim3 grid, size_t smem, cudaStream_t stream,
                   const int64_t* indptr, const int32_t* indices, const float* left,
                   const float* right, const int32_t* pairs, float* out, int64_t n_rows, int B,
                   int A, int W, int S, int J, int Jp, int V, int Bt, int SC) {
  auto kernel = per_sm >= 4 ? fused_count_kernel<kVec, kCols, 4>
                            : fused_count_kernel<kVec, kCols, 3>;
  // the opt-in is the kernel's, not the launch's: threads of one process
  // (a LocalMesh's ranks) must not lower it between another's opt-in and
  // launch
  std::lock_guard<std::mutex> hold(launch_mutex);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTileThreads, smem, stream>>>(indptr, indices, left, right, pairs, out, n_rows,
                                                B, A, W, S, J, Jp, V, Bt, SC);
  return cudaGetLastError();
}

}  // namespace

// left [n_rows, B, A], right [n_rows, B, W], out [n_rows, B, S] float32
// contiguous; indptr [n_rows + 1] int64; indices int32; pairs the packed
// [S][Jp] split table.  V vertices and Bt colorings a tile (V > 1 only with
// Bt == B), SC output columns a chunk, cols (1 or 2) a warp item and per_sm
// CTAs an SM by shared memory (plan_tile; from 4 up, the kernel is built for
// 4 an SM, 64 registers a thread, else for 3).  vec != 0 promises B W and Bt W
// multiples of 4 and right 16-byte aligned.  Returns the first CUDA error of
// the shared-memory opt-in or the launch.
extern "C" int fused_count_launch(const void* indptr, const void* indices, const void* left,
                                  const void* right, const void* pairs, void* out,
                                  long long n_rows, int B, int A, int W, int S, int J, int Jp,
                                  int V, int Bt, int SC, int cols, int per_sm, int vec,
                                  void* stream) {
  if (n_rows <= 0 || B <= 0 || S <= 0) return (int)cudaGetLastError();
  if ((V > 1 && Bt != B) || Bt < 1 || Bt > B) return (int)cudaErrorInvalidValue;
  const long long tiles = (n_rows + V - 1) / V;
  const int groups = (B + Bt - 1) / Bt;
  if (tiles > 0x7fffffffLL || groups > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  const size_t smem = repro_torch::tile_smem_bytes(V * Bt, A, W, SC, Jp);
  if (cols != 1 && cols != 2) return (int)cudaErrorInvalidValue;
  auto fn = vec ? (cols == 2 ? launch<true, 2> : launch<true, 1>)
                : (cols == 2 ? launch<false, 2> : launch<false, 1>);
  return (int)fn(per_sm, grid, smem, (cudaStream_t)stream, (const int64_t*)indptr,
                 (const int32_t*)indices, (const float*)left, (const float*)right,
                 (const int32_t*)pairs, (float*)out, (int64_t)n_rows, B, A, W, S, J, Jp, V, Bt,
                 SC);
}
