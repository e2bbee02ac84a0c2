// Flash attention (online softmax) with GQA, causal and sliding-window masks,
// for float32 inputs on the CUDA cores.  bf16 inputs go to the wgmma kernel
// of flash_attention_wgmma.cu; this kernel serves the float32 routes (the
// float32 checks of the LM path), whose 1e-5 gate TF32 tensor cores would
// break.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py).
// The TPU kernel runs a grid (B, Hq, L/128, L/128) in order on one core and
// carries the running max m, denominator l and accumulator acc in VMEM
// scratch from one KV step to the next; a KV block that the causal or window
// mask excludes is skipped by `pl.when`, but its DMA is still issued.
//
// Here the function is computed, not the grid:
//   * one CTA per (query tile of 64 rows, query head, batch); the CTAs run in
//     no order, so nothing carries between them;
//   * a loop inside the CTA walks the KV tiles of 64 keys in ascending order,
//     with m, l and acc in registers for the whole loop (the TPU's sequential
//     nK grid dimension);
//   * the loop's bounds skip every tile the causal or window mask excludes,
//     so no load is issued for it;
//   * K is staged transposed and V as it is in dynamic shared memory (64 KB
//     at D = 128), beside the query tile (transposed, 32 KB) and the
//     probabilities of the current tile (16 KB); 208 KB at D = 256, under
//     the 227 KB a CTA may opt into (one CTA an SM);
//   * GQA: query head h reads KV head h / (Hq / Hkv);
//   * masked logits are the TPU kernel's finite -1e30, probabilities are zeroed
//     where masked, and a row whose denominator is 0 gives 0 (the guard at the
//     TPU kernel's finalize);
//   * ragged lengths: keys at or past L are masked and staged as zeros, query
//     rows past L are computed on zeros and not stored, so any L works (the TPU
//     kernel asserts L % 128 == 0; the reference's XLA path takes any L).
//
// 256 threads as 16 x 16: thread (ty, tx) computes the logits of query rows
// 4 ty .. 4 ty + 3 against keys 4 tx .. 4 tx + 3 of the tile, and owns the
// output columns 4 tx .. 4 tx + 3 of each 64-column group of D for the same
// rows.  The 16 threads of a row sit in one half-warp, so row max and row sum
// are xor-shuffle butterflies, which give every lane the same bits.  Both
// products are float32 FMAs on the CUDA cores, as the TPU kernel's
// float32 dot_generals are.
//
// Bound on the H100: operations.  One (query, key) pair allowed by the mask
// costs 2 D flops for q.k and 2 D for p.v, so the work is 4 B Hq pairs D
// float32 flops, at the 67e12 float32 flop/s of the CUDA cores.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kTile = 64;      // query rows per CTA, keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNeg = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// 16 bytes, four floats
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

// Rows r0 .. r0 + 63 of a [L, D] matrix into dst[d * kTile + n] (transposed),
// zeros for rows at or past L.  Consecutive threads take consecutive rows, so
// the shared-memory writes of a warp hit 32 banks.
template <int D>
__device__ __forceinline__ void stage_transposed(const float* __restrict__ src, int r0, int L,
                                                 float* dst) {
  constexpr int V = 4;
  for (int idx = threadIdx.x; idx < kTile * (D / V); idx += kThreads) {
    const int n = idx % kTile, c = idx / kTile;
    float x[V];
    if (r0 + n < L) {
      load4(src + (int64_t)(r0 + n) * D + c * V, x);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[(c * V + i) * kTile + n] = x[i];
  }
}

// Rows r0 .. r0 + 63 of a [L, D] matrix into dst[n * D + d], zeros past L.
// Consecutive threads take consecutive 16-byte pieces of a row (coalesced).
template <int D>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int r0, int L,
                                           float* dst) {
  for (int idx = threadIdx.x; idx < kTile * (D / 4); idx += kThreads) {
    const int c = idx % (D / 4), n = idx / (D / 4);
    float4* out = reinterpret_cast<float4*>(dst + n * D + c * 4);
    *out = r0 + n < L ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)(r0 + n) * D + c * 4))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// max and sum over the 16 lanes of a half-warp (every lane gets the same bits)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return (int)sizeof(float) * (3 * D * kTile + kTile * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int hq, int hkv,
                           int L, float scale, int causal, int window) {
  constexpr int G = D / 64;  // 64-column groups of the output a thread writes
  extern __shared__ float4 smem4[];
  float* q_t = reinterpret_cast<float*>(smem4);  // [D][kTile] query tile, transposed
  float* k_t = q_t + D * kTile;                  // [D][kTile] key tile, transposed
  float* v_s = k_t + D * kTile;                  // [kTile][D] value tile
  float* p_t = v_s + kTile * D;                  // [kTile keys][kTile rows] probabilities

  const int n_tiles = (L + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - (int)blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (hq / hkv);
  const int m0 = qt * kTile;
  const int64_t q_off = ((int64_t)b * hq + h) * L * D;
  const int64_t kv_off = ((int64_t)b * hkv + kh) * L * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_transposed<D>(q + q_off, m0, L, q_t);

  float m_run[4], l_run[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.0f;
  }

  // KV tiles holding a key that some row of this tile may attend
  const int q_last = min(m0 + kTile, L) - 1;
  const int kt_end = causal ? q_last / kTile + 1 : n_tiles;
  const int kt_begin = window > 0 ? max(0, m0 - window + 1) / kTile : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int n0 = kt * kTile;
    __syncthreads();  // q_t is staged; the last tile's k_t, v_s and p_t are read
    stage_transposed<D>(k + kv_off, n0, L, k_t);
    stage_rows<D>(v + kv_off, n0, L, v_s);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(q_t + d * kTile + 4 * ty);
      const float4 kb = *reinterpret_cast<const float4*>(k_t + d * kTile + 4 * tx);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = m0 + 4 * ty + i;
      bool ok[4];
      float row_max = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = n0 + 4 * tx + j;
        ok[j] = kpos < L && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(row_max));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += s[i][j];
      }
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = alpha * l_run[i] + half_warp_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_t + (4 * tx + j) * kTile + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kTile; ++n) {
      const float4 pa = *reinterpret_cast<const float4*>(p_t + n * kTile + 4 * ty);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vb = *reinterpret_cast<const float4*>(v_s + n * D + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(pv[i], vb.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pv[i], vb.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pv[i], vb.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pv[i], vb.w, acc[i][4 * g + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= L) continue;
    const float l = l_run[i] == 0.0f ? 1.0f : l_run[i];
#pragma unroll
    for (int g = 0; g < G; ++g)
      *reinterpret_cast<float4*>(o + q_off + (int64_t)row * D + 64 * g + 4 * tx) =
          make_float4(acc[i][4 * g] / l, acc[i][4 * g + 1] / l, acc[i][4 * g + 2] / l,
                      acc[i][4 * g + 3] / l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int L,
           int causal, int window, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  // D**-0.5 rounded once to float32, as the plain version's Python float is
  const float scale = (float)(1.0 / std::sqrt((double)D));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((L + kTile - 1) / kTile), (unsigned)hq, (unsigned)b);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, hq, hkv, L, scale, causal,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// q and o [b, hq, L, d], k and v [b, hkv, L, d], float32, contiguous and
// 16-byte aligned; d is 64, 128 or 256, hq a multiple of hkv; the logits are
// q.k * d**-0.5.  causal != 0 masks keys after the query; window > 0 masks
// keys at or before query - window.  Returns cudaGetLastError() after
// the launch (or the error of setting the kernel's shared-memory size).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int hq, int hkv, int L, int d, int causal,
                                      int window, void* stream) {
  if (b <= 0 || hq <= 0 || L <= 0) return (int)cudaGetLastError();
  if (hkv <= 0 || hq % hkv != 0 || b > 65535 || hq > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 256) return launch<256>(q, k, v, o, b, hq, hkv, L, causal, window, s);
  if (d == 128) return launch<128>(q, k, v, o, b, hq, hkv, L, causal, window, s);
  if (d == 64) return launch<64>(q, k, v, o, b, hq, hkv, L, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
