// Gather-GMM: grouped expert GEMM over gathered token rows (paper §3.1,
// §5.2) for Hopper.
//
// Replaces repro/kernels/gather_gmm.py:gather_gmm (_kernel, with the
// make_work_items grid).  y[r] = x[idx[r]] @ w[e(r)] for the slot rows r of
// expert e, [offsets[e], offsets[e+1]); with a second weight the dual
// branch computes a = x w1, b = x w2 and the SwiGLU epilogue silu(a) * b in
// float32, stored in x's dtype (the rounding point of the TPU kernel), and
// with save_ab also stores a and b in x's dtype (the training residuals).
// idx == nullptr means identity rows (the second GEMM, whose input is
// already in expert order).  trans_w reads a single weight stored
// (E, h_out, d_in) as its transpose: the backward's products with w1^T,
// w2^T and w3^T run without a transposed copy of the weights.  Rows at or
// past offsets[E] are exact zeros.
//
// The TPU kernel walks (row tile x expert) work items in grid order and
// accumulates an output tile across consecutive items.  A Hopper grid has
// no order and nothing may carry between blocks, but no carry is needed:
// every slot row belongs to exactly one expert.  So a tile is 128 slot
// rows of one expert by a column tile, every output element is written by
// one block (no split of the contraction, no atomics: two runs give the
// same bits, which the sharded layer's parity relies on), and the rows
// at or past offsets[E], which no tile owns, are zeroed by every block
// after its last tile, in the same launch.
//
// Bound: operations at prefill and in training (S = 8192 slots, d = 4096,
// h = 14336 is ~1.9 TFLOP for the dual branch against ~1.9 GB of weights)
// and bytes at decode (8 slots read whole expert weight slices).  Design:
// the persistent, warp-specialized wgmma kernels of moe_wgmma.cuh, shared
// with the fused MoE forward, in three instantiations for bf16 with d and
// h multiples of 8 and 16-byte aligned pointers:
//   dual (gathered rows: the forward's x w1, x w2; serving's prefill and
//        decode): `up` over the whole of h, the x rows gathered by 16-byte
//        cp.async into the TMA ring of w1 and w2 tiles, with save_ab
//        storing round(a) and round(b) beside y;
//   single (identity rows: the w3 forward, the pallas backend's gmm):
//        `down` with a plain bf16 store, A rows and the MN-major weight by
//        TMA, m64n256k16;
//   single transposed (trans_w: the backward's w1^T, w2^T, w3^T): the
//        same, the weight (E, h_out, d_in) read K-major, which is wgmma's
//        own B layout, so no transposed copy is made anywhere.
// Everything else (float32, widths not a multiple of 8, unaligned
// pointers, and a single weight over gathered rows, which no path of the
// port runs) takes a plain float32-FMA tiled kernel with scalar, masked
// loads.

#include <algorithm>

#include "common.cuh"
#include "moe_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int MAX_E = 256;

// First and one-past-last expert whose slot range overlaps [m0, m1).
__device__ __forceinline__ void expert_range(const int* offs, int E, int m0,
                                             int m1, int& e0, int& e1) {
  e0 = 0;
  while (e0 < E && offs[e0 + 1] <= m0) ++e0;
  e1 = e0;
  while (e1 < E && offs[e1] < m1) ++e1;
}

// ---------------------------------------------------------------------------
// general path (float32 or bf16, any d and h): float32 FMA on 64 x 64 tiles
// ---------------------------------------------------------------------------

constexpr int SBM = 64, SBN = 64, SBK = 16;

template <typename T, bool DUAL>
__global__ void __launch_bounds__(256)
gmm_simt_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                const int* __restrict__ offsets, const T* __restrict__ w1,
                const T* __restrict__ w2, T* __restrict__ y,
                T* __restrict__ a_out, T* __restrict__ b_out, int S, int L,
                int d, int h, int E, int epilogue, int trans_w) {
  __shared__ float As[SBK][SBM + 1];
  __shared__ float B1s[SBK][SBN + 1];
  __shared__ float B2s[DUAL ? SBK : 1][SBN + 1];
  __shared__ int offs[MAX_E + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * SBM;
  const int n0 = blockIdx.y * SBN;
  for (int i = tid; i <= E; i += 256) offs[i] = offsets[i];
  __syncthreads();
  const int total = offs[E];
  int e0, e1;
  expert_range(offs, E, m0, min(m0 + SBM, total), e0, e1);
  const int e = e0 + blockIdx.z;
  const bool has_expert = e < e1;
  if (!has_expert && blockIdx.z != 0) return;  // uniform over the block
  const int lo = has_expert ? offs[e] : 0;
  const int hi = has_expert ? offs[e + 1] : 0;

  float acc1[4][4] = {}, acc2[4][4] = {};
  if (has_expert) {
    for (int k0 = 0; k0 < d; k0 += SBK) {
      for (int i = tid; i < SBM * SBK; i += 256) {
        const int r = i / SBK, kk = i % SBK;
        const int gr = m0 + r, gk = k0 + kk;
        float v = 0.f;
        if (gr >= lo && gr < hi && gr < S && gk < d) {
          const int tok = idx ? idx[gr] : gr;
          if (tok >= 0 && tok < L) v = repro::to_f32(x[(size_t)tok * d + gk]);
        }
        As[kk][r] = v;
      }
      for (int i = tid; i < SBK * SBN; i += 256) {
        // trans_w: consecutive threads walk k, the weight's contiguous axis
        const int kk = trans_w ? i % SBK : i / SBN;
        const int c = trans_w ? i / SBK : i % SBN;
        const int gk = k0 + kk, gc = n0 + c;
        const bool ok = gk < d && gc < h;
        const size_t off = trans_w ? ((size_t)e * h + gc) * d + gk
                                   : ((size_t)e * d + gk) * h + gc;
        B1s[kk][c] = ok ? repro::to_f32(w1[off]) : 0.f;
        if (DUAL) B2s[kk][c] = ok ? repro::to_f32(w2[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < SBK; ++kk) {
        float a[4], b1[4], b2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b1[j] = B1s[kk][tx * 4 + j];
          if (DUAL) b2[j] = B2s[kk][tx * 4 + j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc1[i][j] = fmaf(a[i], b1[j], acc1[i][j]);
            if (DUAL) acc2[i][j] = fmaf(a[i], b2[j], acc2[i][j]);
          }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty * 4 + i, gc = n0 + tx * 4 + j;
      if (gr >= S || gc >= h) continue;
      if (!((gr >= lo && gr < hi) || (blockIdx.z == 0 && gr >= total)))
        continue;
      const size_t o = (size_t)gr * h + gc;
      float v = acc1[i][j];
      if (DUAL && epilogue) {
        if (a_out != nullptr) {
          a_out[o] = repro::from_f32<T>(v);
          b_out[o] = repro::from_f32<T>(acc2[i][j]);
        }
        const float sg = 1.f / (1.f + expf(-v));
        v = (v * sg) * acc2[i][j];
      }
      y[o] = repro::from_f32<T>(v);
    }
}

template <typename T>
void launch_simt(const void* x, const int* idx, const int* offsets,
                 const void* w1, const void* w2, void* y, void* a_out,
                 void* b_out, int S, int L, int d, int h, int E, int dual,
                 int epilogue, int trans_w, cudaStream_t stream) {
  dim3 grid((S + SBM - 1) / SBM, (h + SBN - 1) / SBN, E);
  if (dual)
    gmm_simt_kernel<T, true><<<grid, 256, 0, stream>>>(
        (const T*)x, idx, offsets, (const T*)w1, (const T*)w2, (T*)y,
        (T*)a_out, (T*)b_out, S, L, d, h, E, epilogue, 0);
  else
    gmm_simt_kernel<T, false><<<grid, 256, 0, stream>>>(
        (const T*)x, idx, offsets, (const T*)w1, nullptr, (T*)y, nullptr,
        nullptr, S, L, d, h, E, epilogue, trans_w);
}

}  // namespace

// x: (L, d); idx: (S,) int32 row ids, or null for identity rows (then
// S == L); offsets: (E+1,) int32; w1, w2: (E, d, h), w2 null for a single
// GEMM, or with trans_w a single w1 stored (E, h, d); y: (S, h); a_out and
// b_out: (S, h) for the dual branch's a and b, or null; all of one dtype.
// The dual branch without its epilogue is the single GEMM with w1.
REPRO_API int repro_gather_gmm(int dtype, const void* x, const int* idx,
                               const int* offsets, const void* w1,
                               const void* w2, void* y, void* a_out,
                               void* b_out, int S, int L, int d, int h, int E,
                               int dual, int epilogue, int trans_w,
                               cudaStream_t stream) {
  if (E < 1 || E > MAX_E || (dual && w2 == nullptr) || (dual && trans_w) ||
      ((a_out == nullptr) != (b_out == nullptr)) ||
      (a_out != nullptr && !(dual && epilogue)))
    return (int)cudaErrorInvalidValue;
  if (S <= 0 || h <= 0) return 0;
  const bool swiglu = dual && epilogue;
  const bool wgmma =
      dtype == REPRO_DTYPE_BF16 && d % 8 == 0 && h % 8 == 0 &&
      repro::aligned16(x) && repro::aligned16(w1) && repro::aligned16(y) &&
      (!swiglu || repro::aligned16(w2)) &&
      (a_out == nullptr ||
       (repro::aligned16(a_out) && repro::aligned16(b_out))) &&
      (swiglu || idx == nullptr);
  if (wgmma) {
    const int n_sm = sm_count();
    if (n_sm <= 0) return (int)cudaErrorInvalidDevice;
    const int row_tiles = repro::fused::max_row_tiles(S, E, up::BM);
    CUtensorMap mw1, mw2, ma;
    if (swiglu) {
      // w1, w2 as 3-D (E, d, h) maps, so the boxes of one expert read
      // zeros past its rows and columns
      const cuuint64_t dims[3] = {(cuuint64_t)h, (cuuint64_t)d,
                                  (cuuint64_t)E};
      const cuuint64_t strides[2] = {(cuuint64_t)h * 2,
                                     (cuuint64_t)d * h * 2};
      const cuuint32_t box[3] = {64, (cuuint32_t)up::BK, 1};
      if (!tensor_map(&mw1, w1, 3, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
          !tensor_map(&mw2, w2, 3, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
      const int grid = std::min(row_tiles * ((h + up::BN - 1) / up::BN), n_sm);
      auto kernel = a_out != nullptr ? moe_up_wgmma<true>
                                     : moe_up_wgmma<false>;
      allow_smem(kernel, up::SMEM);
      kernel<<<grid, up::THREADS, up::SMEM, stream>>>(
          mw1, mw2, (const bf16*)x, idx, offsets, (bf16*)y, (bf16*)a_out,
          (bf16*)b_out, S, L, d, E, 0, h, h);
    } else {
      // A: the (S, d) rows; w1 as a 3-D map: (E, d, h) read MN-major in
      // 64 x BK boxes, or with trans_w (E, h, d) read K-major in BK x 256
      const cuuint64_t dims[3] = {
          (cuuint64_t)(trans_w ? d : h), (cuuint64_t)(trans_w ? h : d),
          (cuuint64_t)E};
      const cuuint64_t strides[2] = {(cuuint64_t)dims[0] * 2,
                                     (cuuint64_t)d * h * 2};
      const cuuint32_t box[3] = {
          trans_w ? (cuuint32_t)down::BK : 64u,
          trans_w ? (cuuint32_t)down::BN : (cuuint32_t)down::BK, 1};
      if (!tensor_map_2d(&ma, x, S, d, d, down::BM, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
          !tensor_map(&mw1, w1, 3, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
      const int grid =
          std::min(row_tiles * ((h + down::BN - 1) / down::BN), n_sm);
      auto kernel = trans_w ? moe_down_wgmma<false, true>
                            : moe_down_wgmma<false, false>;
      allow_smem(kernel, down::SMEM);
      kernel<<<grid, down::THREADS, down::SMEM, stream>>>(
          ma, mw1, ma, mw1, nullptr, nullptr, offsets, y, S, L, h, E, 0, d,
          0);
    }
  } else if (dtype == REPRO_DTYPE_BF16) {
    launch_simt<bf16>(x, idx, offsets, w1, w2, y, a_out, b_out, S, L, d, h,
                      E, dual, epilogue, trans_w, stream);
  } else if (dtype == REPRO_DTYPE_F32) {
    launch_simt<float>(x, idx, offsets, w1, w2, y, a_out, b_out, S, L, d, h,
                       E, dual, epilogue, trans_w, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
