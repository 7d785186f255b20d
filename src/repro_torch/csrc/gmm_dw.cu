// Grouped weight gradient (paper Algorithm 1, the dW products) for Hopper.
//
// Replaces repro/kernels/gather_gmm.py:gmm_dw_pallas (_dw_kernel).  Rows of
// lhs (S, d) and dout (S, h) are already in expert order; expert e owns
// rows [offsets[e], offsets[e+1]) and gets
//     dw[e] = lhs[rows_e]^T @ dout[rows_e]                    (d, h)
// summed in float32 and stored once in lhs's dtype.  Experts with no rows
// get exact zeros; rows at or past offsets[E] contribute nothing.
//
// The TPU kernel walks row tiles in grid order and accumulates an expert's
// (1, d, h) block across consecutive grid steps.  A Hopper grid has no
// order, so nothing is accumulated across blocks and there are no atomics:
// each output tile has one block, which walks that expert's whole row
// range itself, and a repeated call gives the same bits.  The bf16 path is
// moe_wgmma.cuh's moe_dw_wgmma (shared with the fused MoE backward's three
// weight gradients), persistent and warp-specialized: 128 x 256 output
// tiles, a producer warpgroup filling a 3-stage ring of 64 slot rows of
// lhs and dout by TMA (the last, partial step of an expert by cp.async
// with the rows past its end zero-filled, so they are never read), two
// consumer warpgroups running m64n256k16 with both operands MN-major from
// shared memory: a lhs box is its transpose as wgmma reads it, so no copy
// is made.  The float32 accumulators cover the whole row range and are
// rounded once, as the reference does, then leave by TMA stores that
// overlap the next tile.  Tiles run along the shorter side of dw first.
// No split of the contraction: at the training shape (S = 8192 slots,
// E = 8, d = 4096, h = 14336) a call has 14,336 tiles for 132 SMs, and an
// expert's tiles take its whole row range.
//
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_ab.py, dw1 / dw3 at
// the training shape, PERF.md): A from shared memory 1.82 / 1.86 ms
// against 2.06 / 2.10 ms with A loaded into registers by ldmatrix.trans
// (waiting for each step's products before reloading them); the TMA-store
// epilogue 1.43 / 1.70 against 1.81 / 1.87 ms with stores from the
// registers (with no stores at all, 1.20 / 1.25 ms); the cp.async partial
// step cost 2% against loading it whole by TMA.
//
// Bound: operations (2 S d h: ~0.96 TFLOP for one dW1 at S = 8192 slots,
// d = 4096, h = 14336, against ~0.6 GB of operands).  float32 inputs, and
// d or h not a multiple of 8 (or unaligned pointers), take moe_wgmma.cuh's
// dw_simt, a float32-FMA tiled kernel with scalar, masked loads that the
// fused MoE backward's general path shares.

#include <algorithm>

#include "common.cuh"
#include "moe_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// General path (float32 or bf16, any d and h): moe_wgmma.cuh's dw_simt
// with neither operand gathered, stored in lhs's dtype.
template <typename T>
void launch_simt(const void* lhs, const void* dout, const int* offsets,
                 void* dw, int S, int d, int h, int E, cudaStream_t stream) {
  dim3 grid((d + dws::BM - 1) / dws::BM, (h + dws::BN - 1) / dws::BN, E);
  dw_simt<T, false, T, false, T><<<grid, 256, 0, stream>>>(
      (const T*)lhs, d, d, (const T*)dout, h, h, nullptr, offsets, S, S,
      (T*)dw, (size_t)d * h, h);
}

}  // namespace

// lhs: (S, d); dout: (S, h); offsets: (E+1,) int32; dw: (E, d, h), all
// float tensors of one dtype.
REPRO_API int repro_gmm_dw(int dtype, const void* lhs, const void* dout,
                           const int* offsets, void* dw, int S, int d, int h,
                           int E, cudaStream_t stream) {
  if (E < 1 || d <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_DTYPE_BF16) {
    const bool vec = d % 8 == 0 && h % 8 == 0 && repro::aligned16(lhs) &&
                     repro::aligned16(dout) && repro::aligned16(dw);
    if (vec && S > 0) {
      using namespace repro::hopper;
      const int n_sm = sm_count();
      if (n_sm <= 0) return (int)cudaErrorInvalidDevice;
      // lhs and dout rows in 64 x 64 boxes; dw as (E, d, h) in 64 x 64
      // boxes for the TMA store
      CUtensorMap ma, mb, mo;
      const cuuint64_t dims[3] = {(cuuint64_t)h, (cuuint64_t)d,
                                  (cuuint64_t)E};
      const cuuint64_t strides[2] = {(cuuint64_t)h * 2,
                                     (cuuint64_t)d * h * 2};
      const cuuint32_t box[3] = {64, 64, 1};
      if (!tensor_map_2d(&ma, lhs, S, d, d, wgrad::BK, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
          !tensor_map_2d(&mb, dout, S, h, h, wgrad::BK, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
          !tensor_map(&mo, dw, 3, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
      auto kernel = moe_dw_wgmma<false, false, false, bf16>;
      allow_smem(kernel, wgrad::SMEM);
      const int tiles = E * ((d + wgrad::BM - 1) / wgrad::BM) *
                        ((h + wgrad::BN - 1) / wgrad::BN);
      kernel<<<std::min(tiles, n_sm), wgrad::THREADS, wgrad::SMEM,
               stream>>>(ma, mb, mb, mo, mo, (const bf16*)lhs, d,
                         (const bf16*)dout, (const bf16*)dout, h, nullptr,
                         offsets, S, S, d, h, E);
    } else {
      launch_simt<bf16>(lhs, dout, offsets, dw, S, d, h, E, stream);
    }
  } else if (dtype == REPRO_DTYPE_F32) {
    launch_simt<float>(lhs, dout, offsets, dw, S, d, h, E, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
