// Fused dispatch -> GEMM -> combine SwiGLU MoE forward (paper §3.1, §5.2)
// for Hopper.
//
// Replaces repro/kernels/gather_gmm.py:fused_moe_fwd (_fused_kernel).  For
// each slot row s of expert e, s in [offsets[e], offsets[e+1]):
//     a = x[idx[s]] w1[e],  b = x[idx[s]] w2[e]          (float32 sums)
//     y_swi = round(silu(a) * b)                       (to x's dtype)
//     y[idx[s]] += g_slot[s] * (y_swi w3[e])           (float32)
// into a zeroed float32 (L, d) output.  Neither the gathered rows, nor a,
// b, nor an (S, h) y_swi, nor the slot partials are written to device
// memory.
//
// The TPU kernel zeroes the whole output at its first grid step, carries
// the second GEMM's partial across the sequential h axis in scratch and
// scatter-adds each slot's gated partial through a one-hot matmul; all of
// that relies on a grid that runs in order on one core.  A Hopper grid
// runs in no order, so a sum across blocks needs atomics, and their count
// is what the decomposition has to keep small: the first version gave
// each block one 64-wide h-chunk and reduced its 128 x d float32 partial
// into y, S d h / 64 reductions (7.5e9 at training) into a 67 MB y that
// does not fit the 50 MB L2.
//
// Here the call walks h in ranges of width hc (kernels/fused_moe.py plans
// them: the largest multiple of 128 whose bf16 (S, hc) chunk stays within
// a fixed 32 MiB workspace), two launches per range of the kernels in
// moe_wgmma.cuh (shared with gather-GMM):
//   up   tiles (128 slot rows of one expert, 128 columns of the range):
//        the x rows gathered by cp.async, w1 and w2 tiles by TMA, dual
//        m64n128k16 into the a and b accumulators; the epilogue writes
//        round(silu(a) b) into the chunk, the reference's rounding point
//        (gather_gmm.py:366-370);
//   down tiles (128 slot rows of one expert, 256 columns of d): chunk rows
//        (contiguous in slot order) and w3[e][range, d tile] arrive by
//        TMA; m64n256k16 from shared memory; the epilogue adds g_slot[s]
//        acc into row s of a float32 (S, d) per-slot buffer ys with float4
//        reductions (neighbouring lanes swap a row's halves first);
// and after the last range the combine kernel (combine.cu, float32, gates
// of 1) sums each token's slots of ys into y in a fixed order.  A slot row belongs
// to one tile of each launch, so each element of ys takes one reduction a
// launch, and the launches add in stream order: every element of ys and
// of y has one writer and a repeated call gives the same bits.  (Until the
// per-slot buffer, the down kernel reduced into y[idx[s]], where a
// token's k slots met in an order that varied from run to run: millions
// of y's elements differed in their last bit between two calls at
// Mixtral's and Qwen3-30B-A3B's training shapes.)  ys costs S d 4 bytes of
// workspace (128 MiB at S = 8192, d = 4096); every other sum stays in
// registers.  On an H100 80GB HBM3 at
// 700 W the first version's reductions took about half of its 31 ms at
// training (PERF.md §6 has the profile and this design's times).  Both
// kernels are persistent (one block per SM walks the tiles, row tiles
// fastest, so the blocks at work share their weight tiles in L2) and
// mask every ragged edge: rows past an expert's end are computed and
// never stored, columns past the range or past d are zero-filled by TMA
// or skipped, the tail of the contraction reads zeros.
//
// Bound: operations (6 S d h; 2.9 TFLOP at S = 8192, d = 4096, h = 14336)
// in training and prefill, the bytes of the touched experts' weights at
// decode.  float32 inputs, and d or h not a multiple of 8 (or unaligned
// pointers), take the general path: the same h-ranges, through a float32
// (S, hc) chunk (kernels/fused_moe.py:general_pass_width), in float32 FMA
// on 32 x 32 tiles: fwd_simt_up writes the range's rounded y_swi, and
// fwd_simt_down gives each (32 slot rows, 32 columns of d) tile to one
// block that walks the whole range and adds its gated product into ys,
// then the same combine, so that every output of both paths has one
// writer and a repeated call gives the same bits.

#include <algorithm>

#include "fused_moe.cuh"
#include "hopper.cuh"
#include "moe_wgmma.cuh"

namespace {

using namespace repro::hopper;
using repro::fused::load_rows;
using repro::fused::locate_tile;
using repro::fused::max_row_tiles;
using repro::fused::SBH;
using repro::fused::SBK;
using repro::fused::SBM;
using repro::fused::sigmoidf;
using bf16 = __nv_bfloat16;

// General path, the same h-ranges on SBM x SBH tiles in float32 FMA, each
// thread 2 x 2 outputs.  fwd_simt_up: tile (SBM slot rows of one expert,
// SBH columns of the range) -> a, b over all of d -> round(silu(a) b) into
// the float32 chunk (rows ldc apart; the value rounded to x's dtype, the
// reference's rounding point).
template <typename T>
__global__ void __launch_bounds__(256)
fwd_simt_up(const T* __restrict__ x, const float* __restrict__ g_slot,
            const int* __restrict__ idx, const int* __restrict__ offsets,
            const T* __restrict__ w1, const T* __restrict__ w2,
            float* __restrict__ chunk, int ldc, int S, int L, int d, int h,
            int E, int h0, int hw) {
  __shared__ float Xs[SBM][SBK + 1];
  __shared__ float W1s[SBK][SBH + 1];
  __shared__ float W2s[SBK][SBH + 1];
  __shared__ int info[3];
  __shared__ int tok_s[SBM];
  __shared__ float g_s[SBM];
  locate_tile(offsets, E, S, SBM, info);
  const int e = info[0];
  if (e < 0) return;
  const int r0 = info[1], r1 = info[2];
  const int j0 = blockIdx.y * SBH;  // within the range
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*2.., columns tx*2..
  load_rows(idx, g_slot, r0, r1, L, SBM, tok_s, g_s);
  __syncthreads();
  const T* w1e = w1 + (size_t)e * d * h + h0;
  const T* w2e = w2 + (size_t)e * d * h + h0;

  float a[2][2] = {}, b[2][2] = {};
  for (int k0 = 0; k0 < d; k0 += SBK) {
    for (int i = tid; i < SBM * SBK; i += 256) {
      const int r = i / SBK, kk = i % SBK;
      const int t = tok_s[r];
      Xs[r][kk] = (t >= 0 && k0 + kk < d)
                      ? repro::to_f32(x[(size_t)t * d + k0 + kk]) : 0.f;
    }
    for (int i = tid; i < SBK * SBH; i += 256) {
      const int kk = i / SBH, c = i % SBH;
      const bool ok = k0 + kk < d && j0 + c < hw;
      const size_t off = (size_t)(k0 + kk) * h + j0 + c;
      W1s[kk][c] = ok ? repro::to_f32(w1e[off]) : 0.f;
      W2s[kk][c] = ok ? repro::to_f32(w2e[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < SBK; ++kk)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float xv = Xs[ty * 2 + i][kk];
          a[i][j] = fmaf(xv, W1s[kk][tx * 2 + j], a[i][j]);
          b[i][j] = fmaf(xv, W2s[kk][tx * 2 + j], b[i][j]);
        }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = r0 + ty * 2 + i, c = j0 + tx * 2 + j;
      if (s >= r1 || c >= hw) continue;
      const float av = a[i][j];
      const float v = (av * sigmoidf(av)) * b[i][j];
      chunk[(size_t)s * ldc + c] = repro::to_f32(repro::from_f32<T>(v));
    }
}

// fwd_simt_down: tile (SBM slot rows of one expert, SBK columns of d) ->
// the range's chunk columns times w3[e][range, d tile], summed over the
// whole range in registers, then g_slot[s] times it added into row s of
// the float32 per-slot buffer ys: one block writes each element of ys in a
// launch, and the ranges' launches add in stream order.
template <typename T>
__global__ void __launch_bounds__(256)
fwd_simt_down(const float* __restrict__ chunk, int ldc,
              const float* __restrict__ g_slot, const int* __restrict__ idx,
              const int* __restrict__ offsets, const T* __restrict__ w3,
              float* __restrict__ ys, int S, int L, int d, int h, int E,
              int h0, int hw) {
  __shared__ float Ys[SBM][SBH + 1];
  __shared__ float W3s[SBH][SBK + 1];
  __shared__ int info[3];
  __shared__ int tok_s[SBM];
  __shared__ float g_s[SBM];
  locate_tile(offsets, E, S, SBM, info);
  const int e = info[0];
  if (e < 0) return;
  const int r0 = info[1], r1 = info[2];
  const int n0 = blockIdx.y * SBK;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  load_rows(idx, g_slot, r0, r1, L, SBM, tok_s, g_s);
  __syncthreads();
  const T* w3e = w3 + ((size_t)e * h + h0) * d;
  float p[2][2] = {};
  for (int j0 = 0; j0 < hw; j0 += SBH) {
    for (int i = tid; i < SBM * SBH; i += 256) {
      const int r = i / SBH, c = i % SBH;
      Ys[r][c] = (r0 + r < r1 && j0 + c < hw)
                     ? chunk[(size_t)(r0 + r) * ldc + j0 + c] : 0.f;
    }
    for (int i = tid; i < SBH * SBK; i += 256) {
      const int jr = i / SBK, c = i % SBK;
      const bool ok = j0 + jr < hw && n0 + c < d;
      W3s[jr][c] = ok ? repro::to_f32(w3e[(size_t)(j0 + jr) * d + n0 + c])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < SBH; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          p[i][j] = fmaf(Ys[ty * 2 + i][jj], W3s[jj][tx * 2 + j], p[i][j]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i;
    if (r0 + r >= r1) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + tx * 2 + j;
      if (n < d) ys[(size_t)(r0 + r) * d + n] += g_s[r] * p[i][j];
    }
  }
}

template <typename T>
int launch_simt(const void* x, const float* g_slot, const int* idx,
                const int* offsets, const void* w1, const void* w2,
                const void* w3, float* chunk, int hc, float* ys, int S, int L,
                int d, int h, int E, cudaStream_t stream) {
  const int row_tiles = max_row_tiles(S, E, SBM);
  for (int h0 = 0; h0 < h; h0 += hc) {
    const int hw = std::min(hc, h - h0);
    fwd_simt_up<T><<<dim3(row_tiles, (hw + SBH - 1) / SBH), 256, 0,
                     stream>>>((const T*)x, g_slot, idx, offsets,
                               (const T*)w1, (const T*)w2, chunk, hc, S, L,
                               d, h, E, h0, hw);
    fwd_simt_down<T><<<dim3(row_tiles, (d + SBK - 1) / SBK), 256, 0,
                       stream>>>(chunk, hc, g_slot, idx, offsets,
                                 (const T*)w3, ys, S, L, d, h, E, h0, hw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// x: (L, d); g_slot: (S,) float32; idx: (S,) int32; offsets: (E+1,) int32;
// w1, w2: (E, d, h); w3: (E, h, d), all of x's dtype; y: (L, d) float32,
// written whole; tensor_cores: the path, which the caller chooses
// (kernels/fused_moe.py:tensor_core_path) and sizes the chunk for: 1 for
// the tensor-core path, refused unless x is bf16, d and h are multiples of
// 8 and x and the weights are 16-byte aligned; 0 for the general path,
// which takes any input; chunk: (S, hc), hc a multiple of 128 (the h-range
// width, kernels/fused_moe.py:pass_width), of x's dtype on the tensor-core
// path, float32 on the general path; ys: (S, d) float32, zeroed by the
// caller; tim: the dispatch's (L, k) token_index_map, each token's slots
// in the order they are summed.  A call makes 2 ceil(h / hc) + 1 launches
// (none with no slots: y is then zeroed).
REPRO_API int repro_fused_moe_fwd(int dtype, int tensor_cores, const void* x,
                                  const float* g_slot, const int* idx,
                                  const int* offsets, const void* w1,
                                  const void* w2, const void* w3, float* y,
                                  void* chunk, int hc, int S, int L, int d,
                                  int h, int E, float* ys, const int* tim,
                                  int k, cudaStream_t stream) {
  if (E < 1 || d <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != REPRO_DTYPE_BF16 && dtype != REPRO_DTYPE_F32)
    return (int)cudaErrorInvalidValue;
  if (tensor_cores &&
      !(dtype == REPRO_DTYPE_BF16 && d % 8 == 0 && h % 8 == 0 &&
        repro::aligned16(x) && repro::aligned16(w1) &&
        repro::aligned16(w2) && repro::aligned16(w3)))
    return (int)cudaErrorInvalidValue;
  if (S <= 0 || L <= 0) {
    if (L > 0)
      return (int)cudaMemsetAsync(y, 0, (size_t)L * d * sizeof(float),
                                  stream);
    return 0;
  }
  if (chunk == nullptr || !repro::aligned16(chunk) || hc <= 0 ||
      hc % up::BN != 0 || ys == nullptr || !repro::aligned16(ys) ||
      !repro::aligned16(y) || tim == nullptr || k <= 0)
    return (int)cudaErrorInvalidValue;
  if (tensor_cores) {
    const int n_sm = sm_count();
    if (n_sm <= 0) return (int)cudaErrorInvalidDevice;
    // weights as 3-D (E, rows, cols) maps, so the boxes of one expert read
    // zeros past its rows and columns
    CUtensorMap m1, m2, m3;
    const cuuint64_t dw[3] = {(cuuint64_t)h, (cuuint64_t)d, (cuuint64_t)E};
    const cuuint64_t sw[2] = {(cuuint64_t)h * 2, (cuuint64_t)d * h * 2};
    const cuuint32_t bw[3] = {64, (cuuint32_t)up::BK, 1};
    const cuuint64_t d3[3] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)E};
    const cuuint64_t s3[2] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2};
    const cuuint32_t b3[3] = {64, (cuuint32_t)down::BK, 1};
    if (!tensor_map(&m1, w1, 3, dw, sw, bw, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tensor_map(&m2, w2, 3, dw, sw, bw, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tensor_map(&m3, w3, 3, d3, s3, b3, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    allow_smem(moe_up_wgmma<false>, up::SMEM);
    allow_smem(moe_down_wgmma<true, false>, down::SMEM);
    const int row_tiles = max_row_tiles(S, E, up::BM);
    const int grid_b = std::min(row_tiles * ((d + down::BN - 1) / down::BN), n_sm);
    for (int h0 = 0; h0 < h; h0 += hc) {
      const int hw = std::min(hc, h - h0);
      CUtensorMap mc;
      if (!tensor_map_2d(&mc, chunk, S, hw, hc, down::BM, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
      const int grid_a = std::min(row_tiles * ((hw + up::BN - 1) / up::BN), n_sm);
      moe_up_wgmma<false><<<grid_a, up::THREADS, up::SMEM, stream>>>(
          m1, m2, (const bf16*)x, idx, offsets, (bf16*)chunk, nullptr,
          nullptr, S, L, d, E, h0, hw, hc);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      moe_down_wgmma<true, false>
          <<<grid_b, down::THREADS, down::SMEM, stream>>>(
              mc, m3, mc, m3, idx, g_slot, offsets, ys, S, L, d, E, h0, hw,
              0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  } else {
    const int err =
        dtype == REPRO_DTYPE_BF16
            ? launch_simt<bf16>(x, g_slot, idx, offsets, w1, w2, w3,
                                (float*)chunk, hc, ys, S, L, d, h, E, stream)
            : launch_simt<float>(x, g_slot, idx, offsets, w1, w2, w3,
                                 (float*)chunk, hc, ys, S, L, d, h, E,
                                 stream);
    if (err != 0) return err;
  }
  const int err =
      repro_combine(REPRO_DTYPE_F32, ys, tim, nullptr, y, L, k, d, stream);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
