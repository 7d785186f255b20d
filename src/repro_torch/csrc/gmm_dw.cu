// Grouped weight gradient (paper Algorithm 1, the dW products) for Hopper.
//
// Replaces repro/kernels/gather_gmm.py:gmm_dw_pallas (_dw_kernel).  Rows of
// lhs (S, d) and dout (S, h) are already in expert order; expert e owns
// rows [offsets[e], offsets[e+1]) and gets
//     dw[e] = lhs[rows_e]^T @ dout[rows_e]                    (d, h)
// summed in float32 and stored once in lhs's dtype.  Experts with no rows
// get exact zeros.
//
// The TPU kernel walks row tiles in grid order and accumulates an expert's
// (1, d, h) block across consecutive grid steps.  A Hopper grid has no
// order, so nothing is accumulated across blocks and there are no atomics:
// each block owns one (d tile, h tile, expert) output tile and walks that
// expert's whole row range itself, BK rows per step, rows past the range
// zero-filled.  The lhs chunk (BK rows x BM columns of d) sits in shared
// memory as it lies in memory and is read as a column-major WMMA matrix_a,
// which is its transpose without a copy; the dout chunk is a row-major
// matrix_b.  The float32 accumulators cover the whole range and are
// stored once: the same single rounding as the reference.
//
// Bound: operations (2 S d h: ~0.96 TFLOP for one dW1 at S = 8192 slots,
// d = 4096, h = 14336, against ~0.6 GB of operands).  Design: bf16 tensor
// cores through WMMA (16x16x16, float32 accumulate) on 128 x 64 output
// tiles, 8 warps of 32 x 32, fed by a four-stage cp.async ring of 16-byte
// copies, as the gather-GMM kernel.  wgmma, TMA and split-K for experts
// with many rows are later work.  float32 inputs, and d or h not a multiple
// of 8, take a plain float32-FMA tiled kernel with scalar, masked loads.

#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int STAGES = 4;
constexpr int LDA = BM + 8;  // lhs chunk: BK rows of BM d-columns
constexpr int LDB = BN + 8;  // dout chunk: BK rows of BN h-columns
constexpr int LDC = BN + 4;  // float32 epilogue staging
constexpr int THREADS = 256;
constexpr int A_STAGE = BK * LDA;
constexpr int B_STAGE = BK * LDB;
constexpr int PIPE_BYTES = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);
constexpr int EPI_BYTES = BM * LDC * (int)sizeof(float);
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

__global__ void __launch_bounds__(THREADS)
dw_wmma_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ dout,
               const int* __restrict__ offsets, bf16* __restrict__ dw, int S,
               int d, int h) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;  // d offset
  const int n0 = blockIdx.y * BN;  // h offset
  const int e = blockIdx.z;
  const int lo = min(offsets[e], S);
  const int hi = max(lo, min(offsets[e + 1], S));
  const int nsteps = (hi - lo + BK - 1) / BK;

  // Load assignment: lhs chunk = BK rows x BM/8 16-byte pieces (2 per
  // thread); dout chunk = BK rows x BN/8 pieces (1 per thread).
  int a_row[2], a_col[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int piece = tid + c * THREADS;
    a_row[c] = piece / (BM / 8);
    a_col[c] = (piece % (BM / 8)) * 8;
  }
  const int b_row = tid / (BN / 8);
  const int b_col = (tid % (BN / 8)) * 8;

  auto load_stage = [&](int step, int stage) {
    const int r0 = lo + step * BK;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = r0 + a_row[c];
      const int col = m0 + a_col[c];
      const bool ok = r < hi && col < d;
      repro::cp_async16(As + stage * A_STAGE + a_row[c] * LDA + a_col[c],
                        ok ? lhs + (size_t)r * d + col : lhs, ok);
    }
    const int r = r0 + b_row;
    const int col = n0 + b_col;
    const bool ok = r < hi && col < h;
    repro::cp_async16(Bs + stage * B_STAGE + b_row * LDB + b_col,
                      ok ? dout + (size_t)r * h + col : dout, ok);
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // 4 x 2 warps, 32 x 32 each
  const int wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // Ring of STAGES chunks, as in gather_gmm.cu: at step s the wait leaves
  // the newest STAGES - 2 groups in flight, so step s's chunk has landed,
  // and the barrier frees the stage that the next load reuses.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    repro::cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = s + STAGES - 1;
    if (nxt < nsteps) load_stage(nxt, nxt % STAGES);
    repro::cp_async_commit();
    const bf16* A = As + (s % STAGES) * A_STAGE;
    const bf16* B = Bs + (s % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A(i, k) = lhs[k][i]: the chunk read column-major is lhs^T.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], A + kk * LDA + wm + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], B + kk * LDB + wn + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // the epilogue reuses the ring's shared memory

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  bf16* out = dw + (size_t)e * d * h;
  for (int c = tid; c < BM * (BN / 8); c += THREADS) {
    const int r = c / (BN / 8);
    const int cc = (c % (BN / 8)) * 8;
    const int gr = m0 + r, gc = n0 + cc;
    if (gr >= d || gc >= h) continue;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __float2bfloat16_rn(Cs[r * LDC + cc + u]);
    *reinterpret_cast<uint4*>(out + (size_t)gr * h + gc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// General path (float32 or bf16, any d and h): float32 FMA on 64 x 64
// output tiles, SBK rows per step, each thread a 4 x 4 sub-tile.
constexpr int SBM = 64, SBN = 64, SBK = 16;

template <typename T>
__global__ void __launch_bounds__(256)
dw_simt_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
               const int* __restrict__ offsets, T* __restrict__ dw, int S,
               int d, int h) {
  __shared__ float As[SBK][SBM];
  __shared__ float Bs[SBK][SBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * SBM;
  const int n0 = blockIdx.y * SBN;
  const int e = blockIdx.z;
  const int lo = min(offsets[e], S);
  const int hi = max(lo, min(offsets[e + 1], S));
  float acc[4][4] = {};
  for (int r0 = lo; r0 < hi; r0 += SBK) {
    for (int i = tid; i < SBK * SBM; i += 256) {
      const int kr = i / SBM, c = i % SBM;
      const int r = r0 + kr, gc = m0 + c;
      As[kr][c] = (r < hi && gc < d) ? repro::to_f32(lhs[(size_t)r * d + gc])
                                     : 0.f;
    }
    for (int i = tid; i < SBK * SBN; i += 256) {
      const int kr = i / SBN, c = i % SBN;
      const int r = r0 + kr, gc = n0 + c;
      Bs[kr][c] = (r < hi && gc < h) ? repro::to_f32(dout[(size_t)r * h + gc])
                                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kr = 0; kr < SBK; ++kr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* out = dw + (size_t)e * d * h;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty * 4 + i, gc = n0 + tx * 4 + j;
      if (gr < d && gc < h)
        out[(size_t)gr * h + gc] = repro::from_f32<T>(acc[i][j]);
    }
}

template <typename T>
void launch_simt(const void* lhs, const void* dout, const int* offsets,
                 void* dw, int S, int d, int h, int E, cudaStream_t stream) {
  dim3 grid((d + SBM - 1) / SBM, (h + SBN - 1) / SBN, E);
  dw_simt_kernel<T><<<grid, 256, 0, stream>>>(
      (const T*)lhs, (const T*)dout, offsets, (T*)dw, S, d, h);
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
    if (vec) {
      cudaFuncSetAttribute(dw_wmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
      dim3 grid((d + BM - 1) / BM, (h + BN - 1) / BN, E);
      dw_wmma_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
          (const bf16*)lhs, (const bf16*)dout, offsets, (bf16*)dw, S, d, h);
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
