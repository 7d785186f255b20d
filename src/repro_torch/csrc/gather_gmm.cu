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
// every slot row belongs to exactly one expert.  So the grid is (row tile,
// column tile, z), and block z computes the rows of the z-th expert that
// overlaps its row tile and stores only those rows; block z = 0 also
// stores the zero rows at or past offsets[E].  Blocks whose z has no
// expert exit at once.  At decode, where one row tile holds every expert,
// the experts' weight slices stream in parallel instead of one after
// another.  The routed (S, d) buffer never exists: the A tile is gathered
// from x row by row with 16-byte cp.async copies (zero-filled where a row
// belongs to another expert).
//
// Bound: operations at prefill and in training (S = 4096 slots, d = 4096,
// h = 14336 is ~1 TFLOP against ~1.9 GB of weights) and bytes at decode (8
// slots read whole expert weight slices).  Design: bf16 tensor cores
// through WMMA (16x16x16, float32 accumulate) on 128 x 64 tiles fed by a
// four-stage cp.async ring; the epilogue runs on the accumulator fragments
// and is staged through shared memory for masked, coalesced stores.  A
// transposed weight is copied into shared memory along its contiguous
// (d_in) axis and read as a column-major matrix_b.  When all slots fit one
// row tile (decode), a variant skips the tensor-core work of the row
// fragments that hold no slot row, which is what bounded the decode
// shapes.  The prefill shapes reach ~17% of the bf16 peak: wgmma, TMA and
// larger warp tiles are later work.  Shapes the 16-byte path cannot take
// (float32, or d or h not a multiple of 8) run a plain float32-FMA tiled
// kernel with scalar, masked loads.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int MAX_E = 256;

// ---------------------------------------------------------------------------
// tensor-core path (bf16, d % 8 == 0, h % 8 == 0)
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int STAGES = 4;    // cp.async ring depth: 3 tiles in flight
constexpr int LDA = BK + 8;  // padded smem rows (bf16 elements)
constexpr int LDB = BN + 8;  // weight tile, k-major: BK rows of BN
constexpr int LDBT = BK + 8;  // transposed weight tile: BN rows of BK
constexpr int LDC = BN + 4;  // float32 epilogue staging
constexpr int THREADS = 256;
constexpr int A_STAGE = BM * LDA;  // elements per stage

template <bool TRANS>
__host__ __device__ constexpr int b_stage() {
  return TRANS ? BN * LDBT : BK * LDB;
}
template <bool DUAL, bool TRANS>
__host__ __device__ constexpr int smem_bytes() {
  const int pipe = STAGES * (A_STAGE + (DUAL ? 2 : 1) * b_stage<TRANS>()) *
                   (int)sizeof(bf16);
  const int epi = BM * LDC * (int)sizeof(float);
  return pipe > epi ? pipe : epi;
}

// First and one-past-last expert whose slot range overlaps [m0, m1).
__device__ __forceinline__ void expert_range(const int* offs, int E, int m0,
                                             int m1, int& e0, int& e1) {
  e0 = 0;
  while (e0 < E && offs[e0 + 1] <= m0) ++e0;
  e1 = e0;
  while (e1 < E && offs[e1] < m1) ++e1;
}

using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16,
                                       16, float>;

// One BK-deep step of a warp's 32 x 32 tile for its row fragments
// [I0, I0 + NI): a = A rows, b = B1 (and B2) columns, acc += a b.  B is
// k-major (BK rows of LDB), or with TRANS n-major (BN rows of LDBT), which
// is the column-major layout of the same k x n operand.
template <bool DUAL, bool TRANS, int I0, int NI>
__device__ __forceinline__ void mma_rows(AccFrag (&acc1)[2][2],
                                         AccFrag (&acc2)[2][2],
                                         const bf16* A, const bf16* B1,
                                         const bf16* B2, int wm, int wn) {
  using namespace nvcuda;
  using BLayout =
      typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
  auto b_ptr = [&](const bf16* B, int kk, int j) {
    return TRANS ? B + (wn + j * 16) * LDBT + kk : B + kk * LDB + wn + j * 16;
  };
  constexpr int LDBX = TRANS ? LDBT : LDB;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
    for (int i = I0; i < I0 + NI; ++i)
      wmma::load_matrix_sync(a[i], A + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], b_ptr(B1, kk, j), LDBX);
#pragma unroll
    for (int i = I0; i < I0 + NI; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc1[i][j], a[i], b[j], acc1[i][j]);
    if (DUAL) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], b_ptr(B2, kk, j), LDBX);
#pragma unroll
      for (int i = I0; i < I0 + NI; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc2[i][j], a[i], b[j], acc2[i][j]);
    }
  }
}

template <bool DUAL, bool SPARSE, bool TRANS>
__global__ void __launch_bounds__(THREADS)
gmm_wmma_kernel(const bf16* __restrict__ x, const int* __restrict__ idx,
                const int* __restrict__ offsets, const bf16* __restrict__ w1,
                const bf16* __restrict__ w2, bf16* __restrict__ y,
                bf16* __restrict__ a_out, bf16* __restrict__ b_out, int S,
                int L, int d, int h, int E, int epilogue) {
  using namespace nvcuda;
  constexpr int B_STAGE = b_stage<TRANS>();
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int offs[MAX_E + 1];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* B1s = As + STAGES * A_STAGE;
  bf16* B2s = B1s + STAGES * B_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  for (int i = tid; i <= E; i += THREADS) offs[i] = offsets[i];
  __syncthreads();
  const int total = offs[E];
  int e0, e1;
  expert_range(offs, E, m0, min(m0 + BM, total), e0, e1);
  const int e = e0 + blockIdx.z;
  const bool has_expert = e < e1;
  if (!has_expert && blockIdx.z != 0) return;  // uniform over the block
  const int lo = has_expert ? offs[e] : 0;
  const int hi = has_expert ? offs[e + 1] : 0;
  const int nsteps = has_expert ? (d + BK - 1) / BK : 0;

  // Load assignment: A tile = BM rows x BK/8 16-byte chunks (2 per thread);
  // B tile = BK x BN in BK*BN/8 chunks (1 per thread per weight), along h,
  // or with TRANS along d (the transposed weight's contiguous axis).
  int a_row[2], a_col[2], a_tok[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int chunk = tid + c * THREADS;
    a_row[c] = chunk / (BK / 8);
    a_col[c] = (chunk % (BK / 8)) * 8;
    const int r = m0 + a_row[c];
    int tok = -1;
    if (r < S) tok = idx ? idx[r] : r;
    a_tok[c] = (tok >= 0 && tok < L) ? tok : -1;
  }
  const int b_row = TRANS ? tid / (BK / 8) : tid / (BN / 8);
  const int b_col = TRANS ? (tid % (BK / 8)) * 8 : (tid % (BN / 8)) * 8;

  auto load_stage = [&](int step, int stage) {
    const int k0 = step * BK;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = m0 + a_row[c];
      const int kc = k0 + a_col[c];
      const bool ok = r >= lo && r < hi && a_tok[c] >= 0 && kc < d;
      const bf16* src = ok ? x + (size_t)a_tok[c] * d + kc : x;
      repro::cp_async16(As + stage * A_STAGE + a_row[c] * LDA + a_col[c],
                        src, ok);
    }
    bool okb;
    size_t woff;
    int soff;
    if (TRANS) {  // w[e] is (h, d): row n, columns k
      const int n = n0 + b_row, kc = k0 + b_col;
      okb = n < h && kc < d;
      woff = ((size_t)e * h + n) * d + kc;
      soff = b_row * LDBT + b_col;
    } else {  // w[e] is (d, h): row k, columns n
      const int kr = k0 + b_row, col = n0 + b_col;
      okb = kr < d && col < h;
      woff = ((size_t)e * d + kr) * h + col;
      soff = b_row * LDB + b_col;
    }
    repro::cp_async16(B1s + stage * B_STAGE + soff, okb ? w1 + woff : w1,
                      okb);
    if (DUAL)
      repro::cp_async16(B2s + stage * B_STAGE + soff, okb ? w2 + woff : w2,
                        okb);
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // 4 x 2 warps, 32 x 32 each
  const int wn = (warp % 2) * 32;
  // SPARSE (few slot rows): a 16-row fragment with no row of this block's
  // expert holds only zero-filled rows, so its loads and products are
  // skipped (at decode, 8 slot rows leave 15 of the tile's 16 row
  // fragments idle).  The test costs the dense path ~30% (measured), so
  // dense launches compile without it.
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r0 = m0 + wm + i * 16;
    live[i] = r0 < hi && r0 + 16 > lo;
  }
  AccFrag acc1[2][2], acc2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc1[i][j], 0.f);
      if (DUAL) wmma::fill_fragment(acc2[i][j], 0.f);
    }

  // Ring of STAGES tiles: step s lives in stage s % STAGES.  At step s the
  // wait leaves the newest STAGES - 2 groups in flight, so step s's group
  // has landed; the barrier then also guarantees every warp is done with
  // step s - 1, whose stage the load for step s + STAGES - 1 reuses.
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
    const int stage = s % STAGES;
    const bf16* A = As + stage * A_STAGE;
    const bf16* B1 = B1s + stage * B_STAGE;
    const bf16* B2 = B2s + stage * B_STAGE;
    if constexpr (SPARSE) {
      // Warp-uniform choice of the live row fragments (both, one or none).
      if (live[0] && live[1])
        mma_rows<DUAL, TRANS, 0, 2>(acc1, acc2, A, B1, B2, wm, wn);
      else if (live[0])
        mma_rows<DUAL, TRANS, 0, 1>(acc1, acc2, A, B1, B2, wm, wn);
      else if (live[1])
        mma_rows<DUAL, TRANS, 1, 1>(acc1, acc2, A, B1, B2, wm, wn);
    } else {
      mma_rows<DUAL, TRANS, 0, 2>(acc1, acc2, A, B1, B2, wm, wn);
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // the epilogue reuses the ring's shared memory

  // Epilogue: each output passes through the float32 staging tile, then a
  // masked store of this block's rows, 8 bf16 (16 bytes) per thread per
  // step.  Rows of other experts are left to their blocks; block 0 also
  // zeroes the rows at or past offsets[E].
  const bool zero_tail = blockIdx.z == 0;
  auto stage_acc = [&](AccFrag (&acc)[2][2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
  };
  auto store_tile = [&](bf16* out) {
    for (int c = tid; c < BM * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8);
      const int cc = (c % (BN / 8)) * 8;
      const int gr = m0 + r, gc = n0 + cc;
      if (gr >= S || gc >= h) continue;
      if (!((gr >= lo && gr < hi) || (zero_tail && gr >= total))) continue;
      __align__(16) bf16 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = __float2bfloat16_rn(Cs[r * LDC + cc + u]);
      *reinterpret_cast<uint4*>(out + (size_t)gr * h + gc) =
          *reinterpret_cast<const uint4*>(v);
    }
    __syncthreads();  // the staging tile is reused by the next output
  };
  if (DUAL && epilogue && a_out != nullptr) {
    stage_acc(acc1);
    store_tile(a_out);
    stage_acc(acc2);
    store_tile(b_out);
  }
  // The SwiGLU product on the fragments: both accumulators share one
  // layout, so it is taken element by element in float32.
  if (DUAL && epilogue) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        for (int t = 0; t < acc1[i][j].num_elements; ++t) {
          const float av = acc1[i][j].x[t];
          const float sg = 1.f / (1.f + expf(-av));
          acc1[i][j].x[t] = (av * sg) * acc2[i][j].x[t];
        }
  }
  stage_acc(acc1);
  store_tile(y);
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

// The tensor-core kernel's ring needs more than the default 48 KB of
// dynamic shared memory.
template <bool DUAL, bool SPARSE, bool TRANS>
void launch_wmma_one(const void* x, const int* idx, const int* offsets,
                     const void* w1, const void* w2, void* y, void* a_out,
                     void* b_out, int S, int L, int d, int h, int E,
                     int epilogue, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DUAL, TRANS>();
  auto kernel = gmm_wmma_kernel<DUAL, SPARSE, TRANS>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid((S + BM - 1) / BM, (h + BN - 1) / BN, E);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, idx, offsets, (const bf16*)w1, (const bf16*)w2,
      (bf16*)y, (bf16*)a_out, (bf16*)b_out, S, L, d, h, E, epilogue);
}

template <bool SPARSE>
void launch_wmma(int dual, int trans_w, const void* x, const int* idx,
                 const int* offsets, const void* w1, const void* w2, void* y,
                 void* a_out, void* b_out, int S, int L, int d, int h, int E,
                 int epilogue, cudaStream_t stream) {
  if (dual)
    launch_wmma_one<true, SPARSE, false>(x, idx, offsets, w1, w2, y, a_out,
                                         b_out, S, L, d, h, E, epilogue,
                                         stream);
  else if (trans_w)
    launch_wmma_one<false, SPARSE, true>(x, idx, offsets, w1, nullptr, y,
                                         nullptr, nullptr, S, L, d, h, E,
                                         epilogue, stream);
  else
    launch_wmma_one<false, SPARSE, false>(x, idx, offsets, w1, nullptr, y,
                                          nullptr, nullptr, S, L, d, h, E,
                                          epilogue, stream);
}

}  // namespace

// x: (L, d); idx: (S,) int32 row ids, or null for identity rows (then
// S == L); offsets: (E+1,) int32; w1, w2: (E, d, h), w2 null for a single
// GEMM, or with trans_w a single w1 stored (E, h, d); y: (S, h); a_out and
// b_out: (S, h) for the dual branch's a and b, or null; all of one dtype.
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
  if (dtype == REPRO_DTYPE_BF16) {
    const bool vec = d % 8 == 0 && h % 8 == 0 && repro::aligned16(x) &&
                     repro::aligned16(w1) && repro::aligned16(y) &&
                     (!dual || repro::aligned16(w2)) &&
                     (a_out == nullptr || (repro::aligned16(a_out) &&
                                           repro::aligned16(b_out)));
    if (vec) {
      // One row tile or less (decode): most row fragments are idle.
      if (S <= BM) {
        launch_wmma<true>(dual, trans_w, x, idx, offsets, w1, w2, y, a_out,
                          b_out, S, L, d, h, E, epilogue, stream);
      } else {
        launch_wmma<false>(dual, trans_w, x, idx, offsets, w1, w2, y, a_out,
                           b_out, S, L, d, h, E, epilogue, stream);
      }
    } else {
      launch_simt<bf16>(x, idx, offsets, w1, w2, y, a_out, b_out, S, L, d, h,
                        E, dual, epilogue, trans_w, stream);
    }
  } else if (dtype == REPRO_DTYPE_F32) {
    launch_simt<float>(x, idx, offsets, w1, w2, y, a_out, b_out, S, L, d, h,
                       E, dual, epilogue, trans_w, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
