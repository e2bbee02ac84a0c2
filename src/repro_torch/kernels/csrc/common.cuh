// Device helpers shared by the count-table kernels.
//
// Every helper fixes an order of floating-point operations, and every kernel
// that computes the same quantity adds in that order:
//
//   csr_chunk_gather  M[v, c] = 0 + src[u_0, c] + src[u_1, c] + ...   (CSR
//                     order), for one 128-float chunk of the row, one
//                     float32 accumulator per element
//   csr_chunk_sum     the same sum, stored to memory
//   combine_dot       out[s]  = fmaf(l[i1_{J-1}], m[i2_{J-1}], ... fmaf(l[i1_0], m[i2_0], 0))
//
// spmm_edgetile.cu builds M with csr_chunk_sum, fused_count.cu with
// csr_chunk_gather (into shared memory), and spmm_block.cu adds each
// destination row's edges (the plan's slot lists, patch by patch) in CSR
// order into one accumulator that starts at 0: all three give each element
// of M as the same sequence of float32 adds, so the edge and the block
// SpMM, and the fused and the unfused path, give bitwise-equal tables at any
// size, including where float32 rounds.  color_combine.cu and
// fused_count.cu both contract with combine_dot (through combine_tile.cuh).
// Count tables hold integer-valued float32; nothing here passes through
// TF32, bf16 or tensor-core inputs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;

// One warp sums the CSR neighbors of destination row v over one chunk of
// ncols <= 128 columns, 0 + src[u_0, c] + src[u_1, c] + ... for c < ncols,
// and returns the lane's sums in registers (0 past ncols).
//
// kVec: lane l owns columns 4 l .. 4 l + 3 (x, y, z, w) and gathers them as
// one float4 (src and row_stride keep 16-byte alignment); otherwise lane l
// owns columns l, l + 32, l + 64, l + 96, one float each.  The row's indices
// come in coalesced loads of 32, the next 32 loaded while the current ones
// are walked, and each is broadcast by a shuffle; eight gathers (4 KB a
// warp) are issued before their eight adds, which stay in CSR order.  Loop
// bounds depend only on v, so every lane joins every shuffle.
template <bool kVec>
__device__ __forceinline__ float4 csr_chunk_gather(const int64_t* __restrict__ indptr,
                                                   const int32_t* __restrict__ indices,
                                                   const float* __restrict__ src,
                                                   int64_t row_stride, int64_t v, int ncols) {
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
  return acc;
}

// csr_chunk_gather's sums stored to dst[0..ncols) (dst keeps 16-byte
// alignment when kVec).
template <bool kVec>
__device__ __forceinline__ void csr_chunk_sum(const int64_t* __restrict__ indptr,
                                              const int32_t* __restrict__ indices,
                                              const float* __restrict__ src, int64_t row_stride,
                                              int64_t v, int ncols, float* __restrict__ dst) {
  const float4 acc = csr_chunk_gather<kVec>(indptr, indices, src, row_stride, v, ncols);
  const int lane = threadIdx.x & 31;
  if (kVec) {
    if (4 * lane < ncols) *reinterpret_cast<float4*>(dst + 4 * lane) = acc;
  } else {
    if (lane < ncols) dst[lane] = acc.x;
    if (lane + 32 < ncols) dst[lane + 32] = acc.y;
    if (lane + 64 < ncols) dst[lane + 64] = acc.z;
    if (lane + 96 < ncols) dst[lane + 96] = acc.w;
  }
}

// out[c] = sum_j l[idx1(j)] * m[idx2(j)] for j = 0..J-1 in ascending order,
// one fmaf per split into one accumulator that starts at 0, for kCols output
// columns at once (kCols independent chains, each the same sequence).
// `lcol` and `mcol` point at the lane's row of column-major tables in shared
// memory (column c at [c * pitch]); `pairs[c]` at column c's J packed split
// entries (idx1 in the low 16 bits, idx2 in the high 16; 16-byte aligned),
// read four at a time: one 16-byte load for four FMAs of a chain, a
// broadcast where the warp's lanes share the column.
template <int kCols>
__device__ __forceinline__ void combine_dot(const float* lcol, const float* mcol,
                                            const int32_t* const (&pairs)[kCols], int J,
                                            int pitch, float (&out)[kCols]) {
#define REPRO_COMBINE_FMA(F)                                                          \
  _Pragma("unroll") for (int c = 0; c < kCols; ++c) out[c] =                          \
      fmaf(lcol[(q[c].F & 0xffff) * pitch], mcol[((uint32_t)q[c].F >> 16) * pitch], out[c]);
#pragma unroll
  for (int c = 0; c < kCols; ++c) out[c] = 0.0f;
  int j = 0;
  for (; j + 4 <= J; j += 4) {
    int4 q[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) q[c] = reinterpret_cast<const int4*>(pairs[c])[j >> 2];
    REPRO_COMBINE_FMA(x)
    REPRO_COMBINE_FMA(y)
    REPRO_COMBINE_FMA(z)
    REPRO_COMBINE_FMA(w)
  }
  if (j < J) {
    int4 q[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) q[c] = reinterpret_cast<const int4*>(pairs[c])[j >> 2];
    REPRO_COMBINE_FMA(x)
    if (j + 1 < J) { REPRO_COMBINE_FMA(y) }
    if (j + 2 < J) { REPRO_COMBINE_FMA(z) }
  }
#undef REPRO_COMBINE_FMA
}

}  // namespace repro_torch
