// Fused dispatch -> GEMM -> combine SwiGLU MoE forward (paper §3.1, §5.2)
// for Hopper.
//
// Replaces repro/kernels/gather_gmm.py:fused_moe_fwd (_fused_kernel).  For
// each slot row s of expert e, s in [offsets[e], offsets[e+1]):
//     a = x[idx[s]] w1[e],  b = x[idx[s]] w2[e]          (float32 sums)
//     y_swi = round(silu(a) * b)                       (to x's dtype)
//     y[idx[s]] += g_slot[s] * (y_swi w3[e])           (float32)
// into a zeroed float32 (L, d) output.  Neither the gathered rows, nor a,
// b, y_swi, nor the slot partials are written to device memory.
//
// The TPU kernel zeroes the whole output at its first grid step, carries
// the second GEMM's partial across the sequential h axis in scratch, and
// scatter-adds each slot's gated partial through a one-hot matmul; all of
// that relies on a grid that runs in order on one core.  Here a block owns
// one row tile of one expert (up to BM slot rows, rows gathered from x by
// 16-byte cp.async copies) and one h-chunk of BH columns.  It computes a
// and b for its chunk over the full d, applies SiLU * gate and rounds y_swi
// into shared memory, then walks the d-tiles of w3[e][chunk, :] and adds
// g * (y_swi w3) into y with float32 atomic reductions (4 floats per
// instruction; fused_moe.cuh:red_fragment).  So the sums over
// h-chunks and over a token's k slots both happen in the float32 output
// by atomics, zeroed beforehand by the wrapper; their order varies from
// run to run (the tolerance against the plain version says so).
//
// Bound: operations (6 S d h; 2.9 TFLOP at S = 8192, d = 4096, h = 14336)
// in training and prefill, the bytes of the touched experts' weights at
// decode.  Design: bf16 WMMA (16x16x16, float32 accumulate) on 128 x 64
// tiles, 8 warps of 32 x 32, a four-stage cp.async ring for the first
// GEMMs and a double-buffered w3 tile for the second.  float32 inputs, and
// d or h not a multiple of 8, take a plain float32-FMA kernel with the same
// block decomposition.  There are S d h / BH reductions into y; a wider
// h-chunk would halve them.  wgmma and TMA are later work.

#include "fused_moe.cuh"

namespace {

using namespace repro::fused;
using bf16 = __nv_bfloat16;

constexpr int STAGES = 4;
constexpr int A_ST = BM * LDK;   // gathered x rows: BM x BK
constexpr int W_ST = BK * LDH;   // w1 / w2 tile: BK x BH
constexpr int STAGE_EL = A_ST + 2 * W_ST;
constexpr int RING_BYTES = STAGES * STAGE_EL * (int)sizeof(bf16);
constexpr int CS_BYTES = BM * LDC * (int)sizeof(float);
constexpr int W3_EL = BH * LDN;  // w3 tile: BH x BN
constexpr int W3_BYTES = 2 * W3_EL * (int)sizeof(bf16);
constexpr int R_BYTES = RING_BYTES > CS_BYTES
                            ? (RING_BYTES > W3_BYTES ? RING_BYTES : W3_BYTES)
                            : (CS_BYTES > W3_BYTES ? CS_BYTES : W3_BYTES);
constexpr int YS_BYTES = BM * LDH * (int)sizeof(bf16);
constexpr int STG_BYTES = (THREADS / 32) * 16 * LDW * (int)sizeof(float);
constexpr int SMEM_BYTES = R_BYTES + YS_BYTES + STG_BYTES;

__global__ void __launch_bounds__(THREADS)
fwd_wmma_kernel(const bf16* __restrict__ x, const float* __restrict__ g_slot,
                const int* __restrict__ idx, const int* __restrict__ offsets,
                const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                const bf16* __restrict__ w3, float* __restrict__ y, int S,
                int L, int d, int h, int E) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int info[3];
  __shared__ int tok_s[BM];
  __shared__ float g_s[BM];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  bf16* W3s = reinterpret_cast<bf16*>(smem);
  bf16* Ys = reinterpret_cast<bf16*>(smem + R_BYTES);
  float* stg = reinterpret_cast<float*>(smem + R_BYTES + YS_BYTES);

  locate_tile(offsets, E, S, BM, info);
  const int e = info[0];
  if (e < 0) return;  // uniform over the block
  const int r0 = info[1], r1 = info[2];
  const int j0 = blockIdx.y * BH;
  const int tid = threadIdx.x;
  load_rows(idx, g_slot, r0, r1, L, BM, tok_s, g_s);
  __syncthreads();

  const bf16* w1e = w1 + (size_t)e * d * h;
  const bf16* w2e = w2 + (size_t)e * d * h;
  const bf16* w3e = w3 + (size_t)e * h * d;

  // Loads: x rows BM x BK (2 pieces of 16 bytes per thread), w1 and w2
  // BK x BH (1 piece each).
  const int b_row = tid / (BH / 8), b_col = (tid % (BH / 8)) * 8;
  auto load_stage = [&](int step, int stage) {
    const int k0 = step * BK;
    bf16* A = ring + stage * STAGE_EL;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int piece = tid + c * THREADS;
      const int r = piece / (BK / 8), kc = k0 + (piece % (BK / 8)) * 8;
      const int t = tok_s[r];
      const bool ok = t >= 0 && kc < d;
      repro::cp_async16(A + r * LDK + (piece % (BK / 8)) * 8,
                        ok ? x + (size_t)t * d + kc : x, ok);
    }
    const int kr = k0 + b_row, col = j0 + b_col;
    const bool ok = kr < d && col < h;
    const size_t off = (size_t)kr * h + col;
    repro::cp_async16(A + A_ST + b_row * LDH + b_col, ok ? w1e + off : w1e,
                      ok);
    repro::cp_async16(A + A_ST + W_ST + b_row * LDH + b_col,
                      ok ? w2e + off : w2e, ok);
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // 4 x 2 warps, 32 x 32 each
  const int wn = (warp % 2) * 32;
  AccFrag acc1[2][2], acc2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc1[i][j], 0.f);
      wmma::fill_fragment(acc2[i][j], 0.f);
    }

  // First GEMMs over d: the ring as in gather_gmm.cu.
  const int nsteps = (d + BK - 1) / BK;
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
    const bf16* A = ring + (s % STAGES) * STAGE_EL;
    const bf16* B1 = A + A_ST;
    const bf16* B2 = B1 + W_ST;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], A + (wm + i * 16) * LDK + kk, LDK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], B1 + kk * LDH + wn + j * 16, LDH);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc1[i][j], a[i], b[j], acc1[i][j]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], B2 + kk * LDH + wn + j * 16, LDH);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc2[i][j], a[i], b[j], acc2[i][j]);
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // the staging tile reuses the ring

  // SiLU * gate on the fragments (both accumulators share one layout), then
  // through the float32 staging tile into y_swi, rounded to bf16.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      for (int t = 0; t < acc1[i][j].num_elements; ++t) {
        const float av = acc1[i][j].x[t];
        acc1[i][j].x[t] = (av * sigmoidf(av)) * acc2[i][j].x[t];
      }
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16,
                              acc1[i][j], LDC, wmma::mem_row_major);
    }
  __syncthreads();
  for (int i = tid; i < BM * BH; i += THREADS) {
    const int r = i / BH, c = i % BH;
    Ys[r * LDH + c] = __float2bfloat16_rn(Cs[r * LDC + c]);
  }
  __syncthreads();  // the w3 tiles reuse the staging tile

  // Second GEMM over the d-tiles of w3[e][chunk, :], double-buffered; each
  // tile's gated partial is reduced straight into y.
  auto load_w3 = [&](int nt, int buf) {
    const int n0 = nt * BN;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int piece = tid + c * THREADS;
      const int jr = piece / (BN / 8), nc = (piece % (BN / 8)) * 8;
      const bool ok = j0 + jr < h && n0 + nc < d;
      const size_t off = (size_t)(j0 + jr) * d + n0 + nc;
      repro::cp_async16(W3s + buf * W3_EL + jr * LDN + nc,
                        ok ? w3e + off : w3e, ok);
    }
  };
  float* wstg = stg + warp * 16 * LDW;
  const int ntiles = (d + BN - 1) / BN;
  load_w3(0, 0);
  repro::cp_async_commit();
  for (int nt = 0; nt < ntiles; ++nt) {
    repro::cp_async_wait<0>();
    __syncthreads();
    if (nt + 1 < ntiles) load_w3(nt + 1, (nt + 1) & 1);
    repro::cp_async_commit();
    const bf16* B = W3s + (nt & 1) * W3_EL;
    AccFrag acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
    for (int kk = 0; kk < BH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], Ys + (wm + i * 16) * LDH + kk, LDH);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], B + kk * LDN + wn + j * 16, LDN);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    const int n0 = nt * BN;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rb = wm + i * 16;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        red_fragment(
            acc[i][j], wstg, y,
            [&](int rr) -> long {
              const int t = tok_s[rb + rr];
              return t >= 0 ? (long)t * d : -1;
            },
            [&](int rr) { return g_s[rb + rr]; }, n0 + wn + j * 16, d);
    }
  }
}

// General path: the same decomposition on SBM x SBH tiles in float32 FMA,
// each thread 2 x 2 outputs of each product.
template <typename T>
__global__ void __launch_bounds__(256)
fwd_simt_kernel(const T* __restrict__ x, const float* __restrict__ g_slot,
                const int* __restrict__ idx, const int* __restrict__ offsets,
                const T* __restrict__ w1, const T* __restrict__ w2,
                const T* __restrict__ w3, float* __restrict__ y, int S, int L,
                int d, int h, int E) {
  __shared__ float Xs[SBM][SBK + 1];
  __shared__ float W1s[SBK][SBH + 1];
  __shared__ float W2s[SBK][SBH + 1];
  __shared__ float Ys[SBM][SBH + 1];
  __shared__ int info[3];
  __shared__ int tok_s[SBM];
  __shared__ float g_s[SBM];
  locate_tile(offsets, E, S, SBM, info);
  const int e = info[0];
  if (e < 0) return;
  const int r0 = info[1], r1 = info[2];
  const int j0 = blockIdx.y * SBH;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*2.., columns tx*2..
  load_rows(idx, g_slot, r0, r1, L, SBM, tok_s, g_s);
  __syncthreads();
  const T* w1e = w1 + (size_t)e * d * h;
  const T* w2e = w2 + (size_t)e * d * h;
  const T* w3e = w3 + (size_t)e * h * d;

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
      const bool ok = k0 + kk < d && j0 + c < h;
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
      const float av = a[i][j];
      const float v = (av * sigmoidf(av)) * b[i][j];
      Ys[ty * 2 + i][tx * 2 + j] = repro::to_f32(repro::from_f32<T>(v));
    }
  __syncthreads();
  float* W3s = &W1s[0][0];  // SBH x SBK tile of w3, reusing W1s
  for (int n0 = 0; n0 < d; n0 += SBK) {
    for (int i = tid; i < SBH * SBK; i += 256) {
      const int jr = i / SBK, c = i % SBK;
      const bool ok = j0 + jr < h && n0 + c < d;
      W3s[jr * (SBH + 1) + c] =
          ok ? repro::to_f32(w3e[(size_t)(j0 + jr) * d + n0 + c]) : 0.f;
    }
    __syncthreads();
    float p[2][2] = {};
#pragma unroll 8
    for (int jj = 0; jj < SBH; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          p[i][j] = fmaf(Ys[ty * 2 + i][jj], W3s[jj * (SBH + 1) + tx * 2 + j],
                         p[i][j]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i, t = tok_s[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + tx * 2 + j;
        if (t >= 0 && n < d) red_add(y + (size_t)t * d + n, g_s[r] * p[i][j]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// x: (L, d); g_slot: (S,) float32; idx: (S,) int32; offsets: (E+1,) int32;
// w1, w2: (E, d, h); w3: (E, h, d), all of x's dtype; y: (L, d) float32,
// zeroed by the caller.
REPRO_API int repro_fused_moe_fwd(int dtype, const void* x,
                                  const float* g_slot, const int* idx,
                                  const int* offsets, const void* w1,
                                  const void* w2, const void* w3, float* y,
                                  int S, int L, int d, int h, int E,
                                  cudaStream_t stream) {
  if (E < 1 || d <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if (S <= 0 || L <= 0) return 0;
  if (dtype == REPRO_DTYPE_BF16 && d % 8 == 0 && h % 8 == 0 &&
      repro::aligned16(x) && repro::aligned16(w1) && repro::aligned16(w2) &&
      repro::aligned16(w3)) {
    cudaFuncSetAttribute(fwd_wmma_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    dim3 grid(max_row_tiles(S, E, BM), (h + BH - 1) / BH);
    fwd_wmma_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
        (const bf16*)x, g_slot, idx, offsets, (const bf16*)w1,
        (const bf16*)w2, (const bf16*)w3, y, S, L, d, h, E);
  } else if (dtype == REPRO_DTYPE_BF16 || dtype == REPRO_DTYPE_F32) {
    dim3 grid(max_row_tiles(S, E, SBM), (h + SBH - 1) / SBH);
    if (dtype == REPRO_DTYPE_BF16)
      fwd_simt_kernel<bf16><<<grid, 256, 0, stream>>>(
          (const bf16*)x, g_slot, idx, offsets, (const bf16*)w1,
          (const bf16*)w2, (const bf16*)w3, y, S, L, d, h, E);
    else
      fwd_simt_kernel<float><<<grid, 256, 0, stream>>>(
          (const float*)x, g_slot, idx, offsets, (const float*)w1,
          (const float*)w2, (const float*)w3, y, S, L, d, h, E);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
