// Device helpers shared by the three count-table kernels.
//
// Both helpers fix an order of floating-point operations, and every kernel
// that computes the same quantity goes through the same helper:
//
//   csr_row_sum   M[v, c] = 0 + src[u_0, c] + src[u_1, c] + ...   (CSR order)
//   combine_dot   out[s]  = fmaf(l[i1_{J-1}], m[i2_{J-1}], ... fmaf(l[i1_0], m[i2_0], 0))
//
// spmm_edgetile.cu and fused_count.cu both build M with csr_row_sum, and
// color_combine.cu and fused_count.cu both contract with combine_dot, so
// the fused and the unfused path give bitwise-equal tables at any size,
// including where float32 rounds.  Count tables hold integer-valued
// float32; nothing here passes through TF32, bf16 or tensor-core inputs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;

// One warp sums the CSR neighbors of destination row v into dst[0..width).
//
// `src` points at column 0 of the source table's row 0 (already offset to
// the coloring's block of columns), `row_stride` is the table's row pitch
// in floats.  Lane l owns columns l, l + 32, ...; the row's edge range is
// walked in tiles of 32 edges: one coalesced load of 32 indices, then a
// shuffle broadcast per edge.  Loop bounds depend only on v and width, so
// they are uniform over the warp and every lane joins every shuffle.  Four
// gathers are issued before their four adds so that loads overlap; the
// adds stay in CSR order.  `dst` may be global or shared memory.
//
// A hub row is walked by one warp from start to end: balancing such rows
// across warps (the paper's neighbor-list partitioning, §3.3) is later
// kernel work.
__device__ __forceinline__ void csr_row_sum(const int64_t* __restrict__ indptr,
                                            const int32_t* __restrict__ indices,
                                            const float* __restrict__ src,
                                            int64_t row_stride, int64_t v, int width,
                                            float* dst) {
  const int lane = threadIdx.x & 31;
  const int64_t e_begin = indptr[v];
  const int64_t e_end = indptr[v + 1];
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < width;
    float acc = 0.0f;
    for (int64_t e0 = e_begin; e0 < e_end; e0 += 32) {
      const int n_tile = (int)min((int64_t)32, e_end - e0);
      const int my_u = lane < n_tile ? __ldg(indices + e0 + lane) : 0;
      int i = 0;
      for (; i + 4 <= n_tile; i += 4) {
        const int u0 = __shfl_sync(kFullMask, my_u, i);
        const int u1 = __shfl_sync(kFullMask, my_u, i + 1);
        const int u2 = __shfl_sync(kFullMask, my_u, i + 2);
        const int u3 = __shfl_sync(kFullMask, my_u, i + 3);
        float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, x3 = 0.0f;
        if (active) {
          x0 = __ldg(src + (int64_t)u0 * row_stride + c);
          x1 = __ldg(src + (int64_t)u1 * row_stride + c);
          x2 = __ldg(src + (int64_t)u2 * row_stride + c);
          x3 = __ldg(src + (int64_t)u3 * row_stride + c);
        }
        acc += x0;
        acc += x1;
        acc += x2;
        acc += x3;
      }
      for (; i < n_tile; ++i) {
        const int u = __shfl_sync(kFullMask, my_u, i);
        if (active) acc += __ldg(src + (int64_t)u * row_stride + c);
      }
    }
    if (active) dst[c] = acc;
  }
}

// out = sum_j lrow[idx1(j)] * mrow[idx2(j)] for j = 0..J-1 in ascending
// order, one fmaf per split.  `pairs` points at this output column's first
// packed split entry (idx1 in the low 16 bits, idx2 in the high 16);
// consecutive j are `stride` entries apart (the packed table is laid out
// [s_tile][J][ts], see ops.build_combine_tables).  Pointers may be global
// or shared memory.
__device__ __forceinline__ float combine_dot(const float* lrow, const float* mrow,
                                             const int32_t* pairs, int J, int stride) {
  float acc = 0.0f;
  for (int j = 0; j < J; ++j) {
    const int32_t p = pairs[(int64_t)j * stride];
    acc = fmaf(lrow[p & 0xffff], mrow[(uint32_t)p >> 16], acc);
  }
  return acc;
}

}  // namespace repro_torch
