// Device helpers shared by the count-table kernels.
//
// Every helper fixes an order of floating-point operations, and every kernel
// that computes the same quantity adds in that order:
//
//   csr_row_sum    M[v, c] = 0 + src[u_0, c] + src[u_1, c] + ...   (CSR order)
//   csr_chunk_sum  the same sum, term for term, for one 128-float chunk of
//                  the row (a float4 of consecutive columns a lane)
//   combine_dot    out[s]  = fmaf(l[i1_{J-1}], m[i2_{J-1}], ... fmaf(l[i1_0], m[i2_0], 0))
//
// fused_count.cu builds M with csr_row_sum, spmm_edgetile.cu with
// csr_chunk_sum, and spmm_block.cu adds each destination row's edges (the
// plan's slot lists, patch by patch) in CSR order into one accumulator that
// starts at 0: all three
// give each element of M as the same sequence of float32 adds, so the edge
// and the block SpMM, and the fused and the unfused path, give bitwise-equal
// tables at any size, including where float32 rounds.  color_combine.cu and
// fused_count.cu both contract with combine_dot.  Count tables hold
// integer-valued float32; nothing here passes through TF32, bf16 or
// tensor-core inputs.
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
// fused_count.cu uses it; its loop order per element is csr_chunk_sum's.
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

// One warp sums the CSR neighbors of destination row v over one chunk of
// ncols <= 128 columns: dst[c] = 0 + src[u_0, c] + src[u_1, c] + ... for
// c < ncols, the per-element order of csr_row_sum.
//
// kVec: lane l owns columns 4 l .. 4 l + 3 and gathers them as one float4
// (src, row_stride and dst keep 16-byte alignment); otherwise lane l owns
// columns l, l + 32, l + 64, l + 96, one float each.  The row's indices come
// in coalesced loads of 32, the next 32 loaded while the current ones are
// walked, and each is broadcast by a shuffle; eight gathers (4 KB a warp)
// are issued before their eight adds, which stay in CSR order.  Loop bounds
// depend only on v, so every lane joins every shuffle.
template <bool kVec>
__device__ __forceinline__ void csr_chunk_sum(const int64_t* __restrict__ indptr,
                                              const int32_t* __restrict__ indices,
                                              const float* __restrict__ src, int64_t row_stride,
                                              int64_t v, int ncols, float* __restrict__ dst) {
  constexpr int kBatch = 8;
  const int lane = threadIdx.x & 31;
  const int64_t e_begin = __ldg(indptr + v);
  const int64_t e_end = __ldg(indptr + v + 1);
  const int c = kVec ? 4 * lane : lane;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int my_u = e_begin + lane < e_end ? __ldg(indices + e_begin + lane) : 0;
  for (int64_t e0 = e_begin; e0 < e_end; e0 += 32) {
    const int n_tile = (int)min((int64_t)32, e_end - e0);
    const int next_u = e0 + 32 + lane < e_end ? __ldg(indices + e0 + 32 + lane) : 0;
    for (int i = 0; i < n_tile; i += kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int u = __shfl_sync(kFullMask, my_u, i + j);
        x[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i + j < n_tile) {
          const float* row = src + (int64_t)u * row_stride;
          if (kVec) {
            if (c < ncols) x[j] = __ldg(reinterpret_cast<const float4*>(row + c));
          } else {
            if (c < ncols) x[j].x = __ldg(row + c);
            if (c + 32 < ncols) x[j].y = __ldg(row + c + 32);
            if (c + 64 < ncols) x[j].z = __ldg(row + c + 64);
            if (c + 96 < ncols) x[j].w = __ldg(row + c + 96);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i + j < n_tile) {
          acc.x += x[j].x;
          acc.y += x[j].y;
          acc.z += x[j].z;
          acc.w += x[j].w;
        }
      }
    }
    my_u = next_u;
  }
  if (kVec) {
    if (c < ncols) *reinterpret_cast<float4*>(dst + c) = acc;
  } else {
    if (c < ncols) dst[c] = acc.x;
    if (c + 32 < ncols) dst[c + 32] = acc.y;
    if (c + 64 < ncols) dst[c + 64] = acc.z;
    if (c + 96 < ncols) dst[c + 96] = acc.w;
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
