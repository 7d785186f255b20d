// Shared pieces of the fused MoE forward and backward kernels
// (fused_moe_fwd.cu, fused_moe_bwd.cu) and of gather-GMM (gather_gmm.cu).
#pragma once

#include "common.cuh"

// combine.cu: y[l] = sum_i g[l, i] p[tim[l, i]] in the order i = 0 .. k-1;
// the fused kernels call it with float32 p and g null (gates of 1) to sum
// each token's rows of their per-slot buffer into the output.
REPRO_API int repro_combine(int dtype, const void* p, const int* tim,
                            const void* g, void* y, int L, int k, int d,
                            cudaStream_t stream);

namespace repro {
namespace fused {

using bf16 = __nv_bfloat16;

// General path (float32, or bf16 widths the 16-byte copies cannot take).
constexpr int SBM = 32, SBH = 32, SBK = 32;

// Row tiles of the per-expert tiling: expert e owns ceil(n_e / bm) tiles of
// its slot rows [offsets[e], offsets[e+1]) (clamped to S), in expert order.
// Their count is at most ceil(S / bm) + E, the launch's grid.x.
inline int max_row_tiles(int S, int E, int bm) { return (S + bm - 1) / bm + E; }

// The same tiling walked by persistent blocks (moe_wgmma.cuh): the number
// of row tiles of `bm` slot rows, and tile t's expert and rows (e = -1
// past the last).
__device__ __forceinline__ int count_row_tiles(const int* __restrict__ offsets,
                                               int E, int S, int bm) {
  int n = 0;
  for (int i = 0; i < E; ++i) {
    const int lo = min(offsets[i], S);
    const int hi = max(lo, min(offsets[i + 1], S));
    n += (hi - lo + bm - 1) / bm;
  }
  return n;
}

__device__ __forceinline__ void find_row_tile(const int* __restrict__ offsets,
                                              int E, int S, int bm, int t,
                                              int& e, int& r0, int& r1) {
  e = -1;
  r0 = r1 = 0;
  for (int i = 0; i < E; ++i) {
    const int lo = min(offsets[i], S);
    const int hi = max(lo, min(offsets[i + 1], S));
    const int n = (hi - lo + bm - 1) / bm;
    if (t < n) {
      e = i;
      r0 = lo + t * bm;
      r1 = min(r0 + bm, hi);
      return;
    }
    t -= n;
  }
}

// Finds blockIdx.x's row tile: info = {expert or -1, first row, end row}.
__device__ __forceinline__ void locate_tile(const int* __restrict__ offsets,
                                            int E, int S, int bm, int* info) {
  if (threadIdx.x == 0) {
    int t = blockIdx.x, e = -1, r0 = 0, r1 = 0;
    for (int i = 0; i < E; ++i) {
      const int lo = min(offsets[i], S);
      const int hi = max(lo, min(offsets[i + 1], S));
      const int n = (hi - lo + bm - 1) / bm;
      if (t < n) {
        e = i;
        r0 = lo + t * bm;
        r1 = min(r0 + bm, hi);
        break;
      }
      t -= n;
    }
    info[0] = e;
    info[1] = r0;
    info[2] = r1;
  }
  __syncthreads();
}

// Token and gate of each row of the tile; -1 and 0 for rows past the tile
// or with an out-of-range token id.
__device__ __forceinline__ void load_rows(const int* __restrict__ idx,
                                          const float* __restrict__ g_slot,
                                          int r0, int r1, int L, int bm,
                                          int* tok, float* g) {
  for (int r = threadIdx.x; r < bm; r += blockDim.x) {
    const int s = r0 + r;
    int t = s < r1 ? idx[s] : -1;
    if (t >= L) t = -1;
    tok[r] = t;
    g[r] = t >= 0 ? g_slot[s] : 0.f;
  }
}

// An atomic float32 add whose result is not read (a reduction): the plain
// kernels' sums across h-chunks, slots and row tiles land in zeroed
// float32 outputs in an order that varies from run to run.
__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ float sigmoidf(float a) {
  return 1.f / (1.f + expf(-a));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace fused
}  // namespace repro
