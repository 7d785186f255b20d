// Shared pieces of the fused MoE forward and backward kernels
// (fused_moe_fwd.cu, fused_moe_bwd.cu) and of gather-GMM (gather_gmm.cu).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace repro {
namespace fused {

using bf16 = __nv_bfloat16;

// Tensor-core path: a block owns one row tile of one expert (BM slot rows)
// and one h-chunk (BH columns of the hidden width); the first GEMMs run
// over d in BK-deep steps, the second over d in BN-wide tiles.
constexpr int BM = 128, BH = 64, BK = 32, BN = 64;
constexpr int THREADS = 256;
constexpr int LDK = BK + 8;   // bf16 tiles BK wide
constexpr int LDH = BH + 8;   // bf16 tiles BH wide
constexpr int LDN = BN + 8;   // bf16 tiles BN wide
constexpr int LDC = BH + 4;   // float32 staging of a BM x BH accumulator
constexpr int LDW = 16;       // per-warp float32 staging of one fragment

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

// An atomic float32 add whose result is not read (a reduction): the sums
// across h-chunks, slots and row tiles land in zeroed float32 outputs in
// an order that varies from run to run.
__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ float sigmoidf(float a) {
  return 1.f / (1.f + expf(-a));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

using AccFrag =
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// Adds one 16 x 16 accumulator fragment into a float32 matrix through the
// warp's staging tile: out(row, col) += scale(row) * frag, for rows and
// columns inside the bounds.  Each lane adds 4 consecutive floats per
// instruction (a 16-byte vector atomic whose result is unused, so it
// compiles to a reduction; a quarter of the scalar reductions' instruction
// count, which shortened the backward on the H100).  row_off(rr) gives
// the element offset of local row rr (or -1 to skip it); col_lim bounds
// the column.
// The vector path needs 16-byte aligned rows: row offsets and col0 that
// are multiples of 4, as the tensor-core kernels' widths (multiples of 8)
// give.
template <typename RowOff, typename RowScale>
__device__ __forceinline__ void red_fragment(const AccFrag& acc, float* stage,
                                             float* out, RowOff row_off,
                                             RowScale row_scale, int col0,
                                             int col_lim) {
  nvcuda::wmma::store_matrix_sync(stage, acc, LDW, nvcuda::wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int c = (lane & 3) * 4;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int rr = u * 8 + (lane >> 2);
    const long off = row_off(rr);
    if (off < 0) continue;
    const float s = row_scale(rr);
    const float* v = stage + rr * LDW + c;
    float* p = out + off + col0 + c;
    if (col0 + c + 3 < col_lim) {
      atomicAdd(reinterpret_cast<float4*>(p),
                make_float4(s * v[0], s * v[1], s * v[2], s * v[3]));
    } else {
      for (int q = 0; q < 4 && col0 + c + q < col_lim; ++q)
        red_add(p + q, s * v[q]);
    }
  }
  __syncwarp();
}

}  // namespace fused
}  // namespace repro
