// The tile machinery of the two combine kernels, color_combine.cu and
// fused_count.cu: a CTA owns a tile of T table rows (flattened (vertex,
// coloring) rows, one contiguous run of the [rows, A] / [rows, W] / [rows, S]
// tables), holds the tile's operands in shared memory column-major with an
// odd pitch P = T | 1, and contracts them with combine_dot (common.cuh).
//
// Shared memory of a tile, in 4-byte words (host: kernels/color_combine.py
// tile_bytes, the same sum):
//
//   pairs [2][SC][Jp] the packed split entries of two chunks of SC output
//                     columns (int32, J padded to Jp = 4 ceil(J / 4)): the
//                     next chunk's land by cp.async while the current one
//                     is read
//   left  [A][P]      left[first + r, c] at c * P + r
//   m     [W][P]      M (or m) likewise
//   out   [SC][P]     the chunk's outputs, before they go out in rows
//
// Lanes and rows: RL = min(T, 32) rows a warp item, G = 32 / RL column
// groups, kCols (1, 2 or 4) columns a group; lane l takes row l % RL and
// runs one chain for each of its kCols columns.  At T >= 32 (G = 1) the 32
// lanes of a chain read the same split entries (one 16-byte broadcast for
// four FMAs) and 32 consecutive rows of one column, which the odd pitch puts
// in 32 banks: an FMA costs 2.25 shared-memory wavefronts.  Tiles below 32
// rows (the widest nodes, whose rows do not fit 32 at a time) split a warp's
// lanes over G column groups instead.
//
// Per chunk: wait for its split entries, barrier, the warps take items in
// turn and run combine_dot into `out`, barrier, the CTA writes the chunk's
// rows out, one warp a row (coalesced: consecutive lanes, consecutive
// columns).
#pragma once

#include "common.cuh"
#include "mbarrier.cuh"

namespace repro_torch {

constexpr int kTileWarps = 8;
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kStageBatch = 4;  // 16-byte loads in flight a thread while staging

__host__ __device__ inline int tile_pitch(int rows) { return rows | 1; }

__host__ __device__ inline size_t tile_smem_bytes(int rows, int A, int W, int SC, int Jp) {
  return 4 * ((size_t)tile_pitch(rows) * (A + W + SC) + 2 * (size_t)SC * Jp);
}

struct TileSmem {
  int32_t* pairs;
  float* left;
  float* m;
  float* out;
};

__device__ inline TileSmem tile_smem(void* base, int rows, int A, int W, int SC, int Jp) {
  const int pitch = tile_pitch(rows);
  TileSmem t;
  t.pairs = reinterpret_cast<int32_t*>(base);
  t.left = reinterpret_cast<float*>(t.pairs + 2 * SC * Jp);
  t.m = t.left + A * pitch;
  t.out = t.m + W * pitch;
  return t;
}

// Copies the row-major block src[0 .. nrows * width) (nrows rows of
// `width` floats) into dst[c * pitch + r].  Reads are coalesced, 16 bytes a
// lane where src is 16-byte aligned, kStageBatch loads in flight a thread.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int nrows, int width,
                                           float* __restrict__ dst, int pitch) {
  const int n = nrows * width;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i0 = threadIdx.x; i0 < n4; i0 += kStageBatch * kTileThreads) {
      float4 x[kStageBatch];
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const int i = i0 + k * kTileThreads;
        if (i < n4) x[k] = __ldg(s4 + i);
      }
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const int i = i0 + k * kTileThreads;
        if (i < n4) {
          int r = 4 * i / width;
          int c = 4 * i - r * width;
          const float v[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dst[c * pitch + r] = v[q];
            if (++c == width) {
              c = 0;
              ++r;
            }
          }
        }
      }
    }
    done = 4 * n4;
  }
  for (int e = done + threadIdx.x; e < n; e += kTileThreads) {
    const int r = e / width;
    dst[(e - r * width) * pitch + r] = __ldg(src + e);
  }
}

// Phase 2 of both kernels: out[first + r, s] for r < nrows and every s,
// from the staged left and M of a T-row tile.  The first barrier here also
// publishes the caller's staging.
template <int kCols>
__device__ __forceinline__ void combine_tile(const TileSmem& sm, const int32_t* __restrict__ pairs,
                                             float* __restrict__ out, int64_t first, int nrows,
                                             int T, int S, int J, int Jp, int SC) {
  const int pitch = tile_pitch(T);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rl = min(T, 32);
  const int groups = 32 / rl;
  const int n_rg = (T + rl - 1) / rl;
  const int my_row = lane % rl;
  const int my_col = lane / rl;  // >= groups: the lane sits out
  auto fetch = [&](int s0, int32_t* buf) {  // a chunk's split entries, 16-byte copies
    const int sca = min(SC, S - s0);
    const int4* src = reinterpret_cast<const int4*>(pairs + (int64_t)s0 * Jp);
    int4* dst = reinterpret_cast<int4*>(buf);
    for (int i = threadIdx.x; i < sca * Jp / 4; i += kTileThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + i)),
                   "l"(src + i) : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  fetch(0, sm.pairs);
  for (int s0 = 0, chunk = 0; s0 < S; s0 += SC, ++chunk) {
    const int sca = min(SC, S - s0);
    int32_t* sp = sm.pairs + (chunk & 1) * SC * Jp;
    if (s0 + SC < S) {
      fetch(s0 + SC, sm.pairs + ((chunk + 1) & 1) * SC * Jp);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    // an item: rows of one row group x kCols column groups (kCols chains a lane)
    const int n_cg = (sca + groups - 1) / groups;
    const int n_items = n_rg * ((n_cg + kCols - 1) / kCols);
    for (int it = warp; it < n_items; it += kTileWarps) {
      const int r = (it % n_rg) * rl + my_row;
      const int s0c = (it / n_rg) * kCols * groups + my_col;
      const int32_t* p[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {  // a column past the chunk reads a valid one
        const int col = s0c + c * groups;
        p[c] = sp + (col < sca ? col : s0c < sca ? s0c : 0) * Jp;
      }
      float acc[kCols];
      combine_dot<kCols>(sm.left + r, sm.m + r, p, J, pitch, acc);
      if (my_col < groups && r < nrows) {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (s0c + c * groups < sca) sm.out[(s0c + c * groups) * pitch + r] = acc[c];
      }
    }
    __syncthreads();
    for (int r = warp; r < nrows; r += kTileWarps) {
      float* orow = out + (first + r) * S + s0;
      for (int c = lane; c < sca; c += 32) orow[c] = sm.out[c * pitch + r];
    }
  }
}

}  // namespace repro_torch
