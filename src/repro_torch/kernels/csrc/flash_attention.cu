// Flash attention (online softmax) with GQA, causal and sliding-window masks,
// for float32 inputs on the CUDA cores.  bf16 inputs go to the wgmma kernel
// of flash_attention_wgmma.cu; this kernel serves the float32 routes (the
// float32 checks of the LM path), whose 1e-5 gate TF32 tensor cores would
// break.  Both products are plain float32 FMAs (fmaf): no mma, wgmma or TF32.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py).
// The TPU kernel runs a grid (B, Hq, L/128, L/128) in order on one core and
// carries the running max m, denominator l and accumulator acc in VMEM
// scratch from one KV step to the next; a KV block that the causal or window
// mask excludes is skipped by `pl.when`, but its DMA is still issued.
//
// Bound on the H100: operations.  One (query, key) pair allowed by the mask
// costs D FMAs for q.k and D for p.v, so the work is 2 B Hq pairs D float32
// FMAs at the CUDA cores' 33.5e12 FMAs a second (67e12 flop/s): 8.21 ms at
// granite-3-8b's prefill launch (B 4, Hq 32, L 4096 causal, D 128), 1.92 ms
// at recurrentgemma-2b's local layers (B 2, Hq 10, L 4096, window 2048,
// D 256), against 0.200 and 0.055 ms to move q, k, v and o once.  An SM
// issues four warp FMAs a clock but hands its lanes one float each (128
// bytes, broadcasts counted in full) from shared memory a clock, so the
// operands a lane reads per FMA bound the kernel as much as the FMAs do:
// the lane tiles below read (TM + 4) / 4 TM floats an FMA in S (0.375 at
// D <= 128, 0.5 at D = 256) and (TM + D / 16) / (TM D / 16) in P V (0.25,
// 0.31), where 0.25 would match the FMA rate.  The lane tiles are as large
// as the registers (255 a thread) and the shared memory (Q and the ring)
// allow at 8 warps an SM.
//
// Design (the host's mirror of every number is kernels/flash_attention.py,
// fp32_geometry and friends, which the CPU tests check):
//   * grid (Hq, B, query tiles), the tile index reversed so the longest
//     causal tiles of every head start first; 256 threads (8 warps), one
//     CTA an SM (197 KB of shared memory at D = 128, 211 KB at D = 256);
//   * a CTA takes BM query rows: 128 at D <= 128, 64 at D = 256 (a 128-row
//     Q tile would leave no room for the ring).  Warp w owns 2 TM rows;
//     lane (ty, tx) = (lane / 16, lane % 16) owns the TM rows
//     ty, ty + 2, .. of them (TM = 8, or 4 at D = 256), the keys tx,
//     tx + 16, tx + 32, tx + 48 of each 64-key KV tile for S, and the output
//     columns 4 tx .. 4 tx + 3 of each 64-column group of D for O.  The 16
//     lanes of a row sit in one half-warp, so row max and row sum are
//     xor-shuffle butterflies, which give every lane the same bits;
//   * staging is asynchronous (cp.async, zero-filled past L; a thread's
//     copies are fixed chunks at constant offsets): Q once, and the stream
//     of tiles K_0, V_0, K_1, V_1, ...
//     through a ring of NS slots of 64 rows, as many as fit up to 4 (4 at
//     D = 64, 3 at D = 128, 2 at D = 256, where each tile lands while the
//     other tensor's tile is consumed).  A ring step waits for its own tile
//     (cp.async.wait_group NS - 2), passes one CTA barrier, which also frees
//     the slot consumed one step before, and issues the copy of the tile NS
//     - 1 steps ahead into it before its FMAs start;
//   * Q, K and V are stored by rows, each row padded by 16 bytes (pitch
//     D + 4 floats), so the copies land without bank conflicts, the
//     products' 16-byte reads hit distinct banks (8 different keys or 2
//     different rows a quarter-warp), and every read's address is one
//     register and a constant offset: no index arithmetic in the loops;
//   * S = Q K^T: per 4 columns of D, a lane reads TM + 4 float4 (rows
//     broadcast across its half-warp) for 16 TM FMAs;
//   * online softmax in registers, expf as the plain version's exp; the
//     mask code runs only on tiles that straddle the diagonal, the window's
//     edge or L;
//   * P's hand-off to the P V layout stays inside the warp and needs no
//     barrier of its own: each warp writes its 2 TM rows x 64 keys of P to
//     its own shared-memory block, and the ring step's barrier between K_t
//     and V_t orders the write before the reads (the old kernel paid a
//     third CTA barrier a tile for it).  A shuffle hand-off would cost TM
//     shuffles a key where the block costs TM / 4 broadcast reads;
//   * O += P V: per key, TM / 4 float4 of P and D / 64 float4 of V for
//     TM D / 16 FMAs, O in registers for the whole KV sweep;
//   * masked logits are the TPU kernel's finite -1e30, probabilities are
//     zeroed where masked, and a row whose denominator is 0 gives 0 (the
//     guard at the TPU kernel's finalize); query rows past L are computed
//     on zeros and not stored, so any L works.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;  // keys a KV tile
constexpr float kNeg = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA may opt into

template <int D>
struct Geo {
  static constexpr int TM = D <= 128 ? 8 : 4;      // query rows a lane
  static constexpr int BM = 2 * TM * kWarps;       // query rows a CTA
  static constexpr int PITCH = D + 4;              // floats a staged row
  static constexpr int G = D / 64;                 // float4 output columns a lane
  static constexpr int P_FLOATS = kKeys * 2 * TM;  // one warp's block of P
  static constexpr int FIXED = 4 * (BM * PITCH + kWarps * P_FLOATS);  // Q and P, bytes
  static constexpr int SLOT = 4 * kKeys * PITCH;                      // one ring slot, bytes
  static constexpr int NS = (kMaxSmem - FIXED) / SLOT < 4 ? (kMaxSmem - FIXED) / SLOT : 4;
  static constexpr int SMEM = FIXED + NS * SLOT;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Rows r0 .. r0 + ROWS - 1 of a [L, D] matrix into dst (row r at
// dst + r * (D + 4)), zeros for rows at or past L.  Thread t copies 16-byte
// chunk t % (D / 4) of rows t / (D / 4), + 256 / (D / 4), ..., so a warp
// reads consecutive chunks of a row, and every copy's addresses are two
// registers and constant offsets.
template <int D, int ROWS>
__device__ __forceinline__ void stage(const float* __restrict__ src, int r0, int L, float* dst) {
  constexpr int CH = D / 4, STEP = kThreads / CH;
  static_assert(ROWS % STEP == 0, "a pass of the block covers STEP rows");
  const int c = threadIdx.x % CH, r = threadIdx.x / CH;
  const float* from = src + (int64_t)(r0 + r) * D + 4 * c;
  const uint32_t to = smem_addr(dst + r * (D + 4) + 4 * c);
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const bool in = r0 + r + i * STEP < L;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(to + 4 * i * STEP * (D + 4)),
                 "l"(in ? from + i * STEP * D : src), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int hq, int hkv,
                           int L, float scale, int causal, int window) {
  using Gm = Geo<D>;
  constexpr int TM = Gm::TM, BM = Gm::BM, NS = Gm::NS, PITCH = Gm::PITCH, G = Gm::G;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BM][PITCH]
  float* ring = q_s + BM * PITCH;                // NS x [kKeys][PITCH]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = lane / 16, tx = lane % 16;
  float* p_w = ring + NS * kKeys * PITCH + warp * Gm::P_FLOATS;  // [kKeys][2][TM]: this warp's P

  const int q_tiles = (L + BM - 1) / BM;
  const int qt = q_tiles - 1 - (int)blockIdx.z;  // the longest causal rows start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (hq / hkv);
  const int m0 = qt * BM;
  const int64_t q_off = ((int64_t)b * hq + h) * L * D;
  const int64_t kv_off = ((int64_t)b * hkv + kh) * L * D;

  // KV tiles holding a key that some row of this tile may attend
  const int q_last = min(m0 + BM, L) - 1;
  const int kt_end = causal ? q_last / kKeys + 1 : (L + kKeys - 1) / kKeys;
  const int kt_begin = window > 0 ? max(0, m0 - window + 1) / kKeys : 0;
  const int steps = 2 * (kt_end - kt_begin);  // K_t then V_t, for each tile t

  // ring step s holds K (s even) or V (s odd) of tile kt_begin + s / 2
  auto issue = [&](int s) {
    if (s < steps)
      stage<D, kKeys>((s & 1 ? v : k) + kv_off, (kt_begin + s / 2) * kKeys, L,
                      ring + (s % NS) * kKeys * PITCH);
    commit();  // an empty group past the last step keeps the count uniform
  };
  stage<D, BM>(q + q_off, m0, L, q_s);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);

  // this lane's rows in the CTA tile: warp * 2 TM + ty + 2 i
  const int row0 = warp * 2 * TM + ty;
  float m_run[TM], l_run[TM], acc[TM][4 * G];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.0f;
  }

  for (int step = 0; step < steps; ++step) {
    wait_pending<NS - 2>();  // this thread's copies of this step's tile have landed
    __syncthreads();         // everyone's have; the slot of step - 1 is free
    issue(step + NS - 1);
    const float* tile = ring + (step % NS) * kKeys * PITCH;
    const int n0 = (kt_begin + step / 2) * kKeys;

    if ((step & 1) == 0) {
      // S = Q K^T over this lane's TM rows and keys tx + 16 j
      float s[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      const float* q_row = q_s + row0 * PITCH;  // rows row0 + 2 i
      const float* k_row = tile + tx * PITCH;   // keys tx + 16 j
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        float4 qf[TM], kf[4];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          qf[i] = *reinterpret_cast<const float4*>(q_row + 2 * i * PITCH + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kf[j] = *reinterpret_cast<const float4*>(k_row + 16 * j * PITCH + d);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
          }
      }

      const bool masked = n0 + kKeys > L || (causal && n0 + kKeys - 1 > m0) ||
                          (window > 0 && n0 <= q_last - window);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int qpos = m0 + row0 + 2 * i;
        bool ok[4];
        float row_max = kNeg;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = n0 + tx + 16 * j;
          ok[j] = !masked || (kpos < L && (!causal || kpos <= qpos) &&
                              (window <= 0 || kpos > qpos - window));
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
      // P to this warp's block: key n, row group ty, rows i contiguous
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < TM; i += 4)
          *reinterpret_cast<float4*>(p_w + (tx + 16 * j) * 2 * TM + ty * TM + i) =
              make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
    } else {
      // O += P V over this lane's TM rows and columns 4 tx + 64 g
#pragma unroll 4
      for (int n = 0; n < kKeys; ++n) {
        float pv[TM];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_w + n * 2 * TM + ty * TM + i);
          pv[i] = p4.x;
          pv[i + 1] = p4.y;
          pv[i + 2] = p4.z;
          pv[i + 3] = p4.w;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 vb =
              *reinterpret_cast<const float4*>(tile + n * PITCH + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[i][4 * g + 0] = fmaf(pv[i], vb.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(pv[i], vb.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(pv[i], vb.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(pv[i], vb.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }
  wait_pending<0>();  // no copy is left in flight at exit

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + row0 + 2 * i;
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
  constexpr int smem = Geo<D>::SMEM;
  static_assert(smem <= kMaxSmem, "more shared memory than a CTA may opt into");
  // D**-0.5 rounded once to float32, as the plain version's Python float is
  const float scale = (float)(1.0 / std::sqrt((double)D));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (L + Geo<D>::BM - 1) / Geo<D>::BM;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)hq, (unsigned)b, (unsigned)q_tiles);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, hq, hkv, L, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <int D>
int geometry(int* out) {
  out[0] = Geo<D>::BM;
  out[1] = kKeys;
  out[2] = kThreads;
  out[3] = Geo<D>::NS;
  out[4] = Geo<D>::TM;
  out[5] = Geo<D>::SMEM;
  return 0;
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
  if (hkv <= 0 || hq % hkv != 0 || b > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 256) return launch<256>(q, k, v, o, b, hq, hkv, L, causal, window, s);
  if (d == 128) return launch<128>(q, k, v, o, b, hq, hkv, L, causal, window, s);
  if (d == 64) return launch<64>(q, k, v, o, b, hq, hkv, L, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

// The kernel's geometry at head dim d, for the host's mirror
// (kernels/flash_attention.py: fp32_geometry): query rows a CTA, keys a KV
// tile, threads, ring slots, query rows a lane, dynamic shared memory in
// bytes.  Returns cudaErrorInvalidValue for a d it is not built for.
extern "C" int flash_attention_geometry(int d, int* out) {
  if (d == 256) return geometry<256>(out);
  if (d == 128) return geometry<128>(out);
  if (d == 64) return geometry<64>(out);
  return (int)cudaErrorInvalidValue;
}
