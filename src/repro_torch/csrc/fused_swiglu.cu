// Fused dense SwiGLU (paper §5.2 and Algorithm 1) for Hopper: the forward
// dual GEMM with its SwiGLU epilogue and the two backward kernels.
//
// Replaces repro/kernels/fused_swiglu.py:
//   fused_swiglu_fwd   (_fwd_kernel)    a = x w1, b = x w2 (float32
//       accumulators), y = silu(a) b; y, a and b rounded once to x's dtype;
//   fused_swiglu_bwd_x (_bwd_x_kernel)  da = dy b silu'(a), db = dy silu(a)
//       in float32, each rounded to dy's dtype; dx = da w1^T + db w2^T in
//       one float32 accumulator, rounded once;
//   fused_swiglu_bwd_w (_bwd_w_kernel)  the same da, db (rounded to x's
//       dtype); dw1 = x^T da, dw2 = x^T db sharing one read of x; output in
//       x's dtype.
// with silu'(a) = s (1 + a (1 - s)), s = sigmoid(a).
//
// The TPU kernels zero float32 scratch at the first step of an innermost
// contraction axis (d, h or L) and carry it across grid steps that run in
// order.  A Hopper grid runs in no order, so here every block owns one
// output tile and loops over the whole contraction itself, with the
// accumulators in registers: no sum crosses blocks, so there are no atomics.
//
//   fwd:   block = (128 rows x 64 columns of h) of a and b; each x tile is
//          staged in shared memory once and feeds both products (the single
//          read of x that is the §5.2 fusion); the epilogue runs from the
//          float32 accumulators.
//   bwd_x: block = (128 rows x 128 columns of d) of dx; per 32-wide h-chunk
//          it loads dy, a and b, forms da and db in float32 in place in
//          shared memory, rounded to bf16 as tensor-core operands, and
//          accumulates da w1^T + db w2^T.  da and db never reach HBM; they
//          are recomputed for each d-tile, as on the TPU.
//   bwd_w: block = (128 rows of d x 64 columns of h) of dw1 and dw2; per
//          32-row chunk of L it forms da and db in shared memory the same
//          way and accumulates x^T da and x^T db (the x chunk read
//          column-major is x^T without a copy).
//
// Bound: operations at training and prefill (4 L d h each: 1.46 TFLOP at
// L = 4096, d = 5120, h = 17408) and bytes at decode (L = 4 slots read
// 356.5 MB of w1 | w2).  Design: bf16 WMMA (16x16x16, float32 accumulate)
// fed by rings of 16-byte cp.async copies; wgmma and TMA are later work.
// Any L, d and h: tails are bounds-checked (rows past L and columns past d
// or h are zero-filled on load and never stored).  float32, and bf16 widths
// that are not a multiple of 8 (or unaligned pointers), take a plain
// float32-FMA tiled kernel with scalar, masked loads.

#include <mma.h>

#include <initializer_list>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16,
                                       16, float>;

constexpr int THREADS = 256;
constexpr int BK = 32;   // contraction depth of one pipeline step

// sigmoid in float32.  The tensor-core path rounds every result to bf16,
// so it takes the fast exponential and division; the float32 path keeps
// the accurate ones.
template <bool FAST>
__device__ __forceinline__ float sigmoid_(float a) {
  if (FAST) return __fdividef(1.f, 1.f + __expf(-a));
  return 1.f / (1.f + expf(-a));
}

// da = (dy b) silu'(a) and db = dy silu(a), as the TPU kernels order them.
template <bool FAST>
__device__ __forceinline__ void swiglu_grads(float dy, float a, float b,
                                             float& da, float& db) {
  const float s = sigmoid_<FAST>(a);
  da = dy * b * (s * (1.f + a * (1.f - s)));
  db = dy * (a * s);
}

// Converts 8 consecutive bf16 elements of dy, a, b in shared memory into
// da (over dy) and db (over a), rounded to bf16.
__device__ __forceinline__ void grads8_inplace(bf16* dy, bf16* a,
                                               const bf16* b) {
  __align__(16) bf16 vd[8], va[8], vb[8];
  *reinterpret_cast<uint4*>(vd) = *reinterpret_cast<const uint4*>(dy);
  *reinterpret_cast<uint4*>(va) = *reinterpret_cast<const uint4*>(a);
  *reinterpret_cast<uint4*>(vb) = *reinterpret_cast<const uint4*>(b);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float da, db;
    swiglu_grads<true>(__bfloat162float(vd[u]), __bfloat162float(va[u]),
                       __bfloat162float(vb[u]), da, db);
    vd[u] = __float2bfloat16_rn(da);
    va[u] = __float2bfloat16_rn(db);
  }
  *reinterpret_cast<uint4*>(dy) = *reinterpret_cast<const uint4*>(vd);
  *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(va);
}

// Stores a BM x BN float32 staging tile (row stride ldc) to out (row
// stride ld) as bf16, 8 elements (16 bytes) per thread per step; rows at
// or past nrows and columns at or past ncols are skipped.
template <int BM, int BN>
__device__ __forceinline__ void store_tile(const float* Cs, int ldc, bf16* out,
                                           int ld, int m0, int n0, int nrows,
                                           int ncols) {
  for (int c = threadIdx.x; c < BM * (BN / 8); c += THREADS) {
    const int r = c / (BN / 8);
    const int cc = (c % (BN / 8)) * 8;
    const int gr = m0 + r, gc = n0 + cc;
    if (gr >= nrows || gc >= ncols) continue;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __float2bfloat16_rn(Cs[r * ldc + cc + u]);
    *reinterpret_cast<uint4*>(out + (size_t)gr * ld + gc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// Writes a warp's MI x NI accumulator fragments at (wm, wn) of a float32
// staging tile.
template <int MI, int NI>
__device__ __forceinline__ void stage_acc(float* Cs, int ldc,
                                          AccFrag (&acc)[MI][NI], int wm,
                                          int wn) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      nvcuda::wmma::store_matrix_sync(Cs + (wm + i * 16) * ldc + wn + j * 16,
                                      acc[i][j], ldc,
                                      nvcuda::wmma::mem_row_major);
}

template <int MI, int NI>
__device__ __forceinline__ void zero_acc(AccFrag (&acc)[MI][NI]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
}

// ---------------------------------------------------------------------------
// forward, tensor cores: (x, w1, w2) -> (y, a, b)
// ---------------------------------------------------------------------------

namespace fwd {
constexpr int BM = 128, BN = 64, STAGES = 4;
constexpr int LDA = BK + 8;   // x tile: BM rows of BK
constexpr int LDB = BN + 8;   // weight tile: BK rows of BN
constexpr int LDC = BN + 4;
constexpr int A_STAGE = BM * LDA, B_STAGE = BK * LDB;
constexpr int PIPE = STAGES * (A_STAGE + 2 * B_STAGE) * (int)sizeof(bf16);
constexpr int EPI = BM * LDC * (int)sizeof(float);
constexpr int SMEM = PIPE > EPI ? PIPE : EPI;
}  // namespace fwd

// SPARSE (L <= BM, decode): a 16-row fragment at or past L holds only
// zero-filled rows, so its products are skipped; the test costs a dense
// tile, so dense launches compile without it.
template <bool SPARSE>
__global__ void __launch_bounds__(THREADS)
swiglu_fwd_wmma(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const bf16* __restrict__ w2, bf16* __restrict__ y,
                bf16* __restrict__ a_out, bf16* __restrict__ b_out, int L,
                int d, int h) {
  using namespace nvcuda;
  using namespace fwd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* B1s = As + STAGES * A_STAGE;
  bf16* B2s = B1s + STAGES * B_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nsteps = (d + BK - 1) / BK;

  // x tile: BM rows x BK/8 16-byte pieces (2 per thread); weight tiles:
  // BK rows x BN/8 pieces (1 per thread per weight).
  auto load_stage = [&](int step, int stage) {
    const int k0 = step * BK;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int piece = tid + c * THREADS;
      const int row = piece / (BK / 8), col = (piece % (BK / 8)) * 8;
      const int r = m0 + row, kc = k0 + col;
      const bool ok = r < L && kc < d;
      repro::cp_async16(As + stage * A_STAGE + row * LDA + col,
                        ok ? x + (size_t)r * d + kc : x, ok);
    }
    const int brow = tid / (BN / 8), bcol = (tid % (BN / 8)) * 8;
    const int kr = k0 + brow, col = n0 + bcol;
    const bool ok = kr < d && col < h;
    const size_t off = (size_t)kr * h + col;
    repro::cp_async16(B1s + stage * B_STAGE + brow * LDB + bcol,
                      ok ? w1 + off : w1, ok);
    repro::cp_async16(B2s + stage * B_STAGE + brow * LDB + bcol,
                      ok ? w2 + off : w2, ok);
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // 4 x 2 warps, 32 x 32 each
  const int wn = (warp % 2) * 32;
  int ni = 2;
  if (SPARSE) {
    // warp-uniform: the row fragments [0, ni) hold rows below L
    ni = 0;
    for (int i = 0; i < 2; ++i)
      if (m0 + wm + i * 16 < L) ni = i + 1;
  }
  AccFrag acc1[2][2], acc2[2][2];
  zero_acc(acc1);
  zero_acc(acc2);

  // Ring of STAGES tiles (as in gather_gmm.cu): at step s the wait leaves
  // the newest STAGES - 2 groups in flight, so step s's tile has landed;
  // the barrier frees the stage that the next load reuses.
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
    const bf16* B1 = B1s + (s % STAGES) * B_STAGE;
    const bf16* B2 = B2s + (s % STAGES) * B_STAGE;
    if (ni == 0) continue;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < ni)
          wmma::load_matrix_sync(a[i], A + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], B1 + kk * LDB + wn + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < ni)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc1[i][j], a[i], b[j], acc1[i][j]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], B2 + kk * LDB + wn + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < ni)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc2[i][j], a[i], b[j], acc2[i][j]);
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // the epilogue reuses the ring's shared memory

  // a and b, each rounded once; then y = silu(a) b from the float32
  // accumulators (both share one fragment layout), rounded once.
  stage_acc(Cs, LDC, acc1, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, a_out, h, m0, n0, L, h);
  __syncthreads();
  stage_acc(Cs, LDC, acc2, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, b_out, h, m0, n0, L, h);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      for (int t = 0; t < acc1[i][j].num_elements; ++t) {
        const float av = acc1[i][j].x[t];
        acc1[i][j].x[t] = (av * sigmoid_<true>(av)) * acc2[i][j].x[t];
      }
  stage_acc(Cs, LDC, acc1, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, y, h, m0, n0, L, h);
}

// ---------------------------------------------------------------------------
// backward dx, tensor cores: (dy, a, b, w1, w2) -> dx
// ---------------------------------------------------------------------------

namespace bwdx {
constexpr int BM = 128, BN = 128, STAGES = 3;
constexpr int LDA = BK + 8;    // dy / a / b tiles: BM rows of BK (h)
constexpr int LDBT = BK + 8;   // w^T tiles: BN rows (d) of BK (h)
constexpr int LDC = BN + 4;
constexpr int A_TILE = BM * LDA, B_TILE = BN * LDBT;
constexpr int STAGE = 3 * A_TILE + 2 * B_TILE;   // elements
constexpr int PIPE = STAGES * STAGE * (int)sizeof(bf16);
constexpr int EPI = BM * LDC * (int)sizeof(float);
constexpr int SMEM = PIPE > EPI ? PIPE : EPI;
}  // namespace bwdx

__global__ void __launch_bounds__(THREADS)
swiglu_bwd_x_wmma(const bf16* __restrict__ dy, const bf16* __restrict__ a,
                  const bf16* __restrict__ b, const bf16* __restrict__ w1,
                  const bf16* __restrict__ w2, bf16* __restrict__ dx, int L,
                  int d, int h) {
  using namespace nvcuda;
  using namespace bwdx;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;   // rows of L
  const int n0 = blockIdx.y * BN;   // columns of d
  const int nsteps = (h + BK - 1) / BK;

  // stage layout: dy, a, b (BM x BK each), then w1^T, w2^T (BN x BK each)
  auto tile = [&](int stage, int which) {
    return ring + stage * STAGE +
           (which < 3 ? which * A_TILE : 3 * A_TILE + (which - 3) * B_TILE);
  };
  auto load_stage = [&](int step, int stage) {
    const int k0 = step * BK;
    // dy / a / b: BM rows x BK/8 pieces, 2 per thread each
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int piece = tid + c * THREADS;
      const int row = piece / (BK / 8), col = (piece % (BK / 8)) * 8;
      const int r = m0 + row, kc = k0 + col;
      const bool ok = r < L && kc < h;
      const size_t off = (size_t)r * h + kc;
      const int so = row * LDA + col;
      repro::cp_async16(tile(stage, 0) + so, ok ? dy + off : dy, ok);
      repro::cp_async16(tile(stage, 1) + so, ok ? a + off : a, ok);
      repro::cp_async16(tile(stage, 2) + so, ok ? b + off : b, ok);
    }
    // w^T tiles: BN rows of d, each BK contiguous h values of w[n][k0:]
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int piece = tid + c * THREADS;
      const int row = piece / (BK / 8), col = (piece % (BK / 8)) * 8;
      const int n = n0 + row, kc = k0 + col;
      const bool ok = n < d && kc < h;
      const size_t off = (size_t)n * h + kc;
      const int so = row * LDBT + col;
      repro::cp_async16(tile(stage, 3) + so, ok ? w1 + off : w1, ok);
      repro::cp_async16(tile(stage, 4) + so, ok ? w2 + off : w2, ok);
    }
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // 4 x 2 warps, 32 x 64 each
  const int wn = (warp % 2) * 64;
  AccFrag acc[2][4];
  zero_acc(acc);

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
    const int st = s % STAGES;
    bf16* DA = tile(st, 0);   // dy, becomes da
    bf16* DB = tile(st, 1);   // a, becomes db
    const bf16* Bv = tile(st, 2);
    // da and db in float32, rounded to bf16 in place: BM x BK elements,
    // 8 per piece, 2 pieces per thread (zero-filled tails give zeros)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int piece = tid + c * THREADS;
      const int so = (piece / (BK / 8)) * LDA + (piece % (BK / 8)) * 8;
      grads8_inplace(DA + so, DB + so, Bv + so);
    }
    __syncthreads();
    const bf16* W1 = tile(st, 3);
    const bf16* W2 = tile(st, 4);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
      // da w1^T: w1^T(k, n) = W1[n * LDBT + k], a column-major matrix_b
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], DA + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], W1 + (wn + j * 16) * LDBT + kk, LDBT);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      // + db w2^T, into the same accumulator
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], DB + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], W2 + (wn + j * 16) * LDBT + kk, LDBT);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  stage_acc(Cs, LDC, acc, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, dx, d, m0, n0, L, d);
}

// ---------------------------------------------------------------------------
// backward dw, tensor cores: (x, dy, a, b) -> (dw1, dw2)
// ---------------------------------------------------------------------------

namespace bwdw {
constexpr int BM = 128, BN = 64, STAGES = 4;
constexpr int LDX = BM + 8;   // x chunk: BK rows of BM (d) columns
constexpr int LDY = BN + 8;   // dy / a / b chunks: BK rows of BN (h)
constexpr int LDC = BN + 4;
constexpr int X_TILE = BK * LDX, Y_TILE = BK * LDY;
constexpr int STAGE = X_TILE + 3 * Y_TILE;
constexpr int PIPE = STAGES * STAGE * (int)sizeof(bf16);
constexpr int EPI = BM * LDC * (int)sizeof(float);
constexpr int SMEM = PIPE > EPI ? PIPE : EPI;
}  // namespace bwdw

__global__ void __launch_bounds__(THREADS)
swiglu_bwd_w_wmma(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const bf16* __restrict__ a, const bf16* __restrict__ b,
                  bf16* __restrict__ dw1, bf16* __restrict__ dw2, int L,
                  int d, int h) {
  using namespace nvcuda;
  using namespace bwdw;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;   // rows of d
  const int n0 = blockIdx.y * BN;   // columns of h
  const int nsteps = (L + BK - 1) / BK;

  auto tile = [&](int stage, int which) {   // 0: x, 1-3: dy, a, b
    return ring + stage * STAGE +
           (which == 0 ? 0 : X_TILE + (which - 1) * Y_TILE);
  };
  auto load_stage = [&](int step, int stage) {
    const int r0 = step * BK;
    // x chunk: BK rows x BM/8 pieces, 2 per thread
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int piece = tid + c * THREADS;
      const int row = piece / (BM / 8), col = (piece % (BM / 8)) * 8;
      const int r = r0 + row, gc = m0 + col;
      const bool ok = r < L && gc < d;
      repro::cp_async16(tile(stage, 0) + row * LDX + col,
                        ok ? x + (size_t)r * d + gc : x, ok);
    }
    // dy / a / b chunks: BK rows x BN/8 pieces, 1 per thread each
    const int row = tid / (BN / 8), col = (tid % (BN / 8)) * 8;
    const int r = r0 + row, gc = n0 + col;
    const bool ok = r < L && gc < h;
    const size_t off = (size_t)r * h + gc;
    const int so = row * LDY + col;
    repro::cp_async16(tile(stage, 1) + so, ok ? dy + off : dy, ok);
    repro::cp_async16(tile(stage, 2) + so, ok ? a + off : a, ok);
    repro::cp_async16(tile(stage, 3) + so, ok ? b + off : b, ok);
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // 4 x 2 warps, 32 x 32 each
  const int wn = (warp % 2) * 32;
  AccFrag acc1[2][2], acc2[2][2];
  zero_acc(acc1);
  zero_acc(acc2);

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
    const int st = s % STAGES;
    bf16* DA = tile(st, 1);   // dy, becomes da
    bf16* DB = tile(st, 2);   // a, becomes db
    {  // BK x BN elements: one piece of 8 per thread
      const int so = (tid / (BN / 8)) * LDY + (tid % (BN / 8)) * 8;
      grads8_inplace(DA + so, DB + so, tile(st, 3) + so);
    }
    __syncthreads();
    const bf16* X = tile(st, 0);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // x^T(i, k) = X[k * LDX + i]: the chunk read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], X + kk * LDX + wm + i * 16, LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], DA + kk * LDY + wn + j * 16, LDY);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc1[i][j], fa[i], fb[j], acc1[i][j]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], DB + kk * LDY + wn + j * 16, LDY);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc2[i][j], fa[i], fb[j], acc2[i][j]);
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  stage_acc(Cs, LDC, acc1, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, dw1, h, m0, n0, d, h);
  __syncthreads();
  stage_acc(Cs, LDC, acc2, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, dw2, h, m0, n0, d, h);
}

// ---------------------------------------------------------------------------
// general path (float32, or bf16 at any width): float32 FMA on 64 x 64
// output tiles, SBK deep per step, each thread a 4 x 4 sub-tile
// ---------------------------------------------------------------------------

constexpr int SB = 64, SBK = 16;

// rounds a float32 value through T (the TPU kernels' cast of da, db)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return repro::to_f32(repro::from_f32<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(256)
swiglu_fwd_simt(const T* __restrict__ x, const T* __restrict__ w1,
                const T* __restrict__ w2, T* __restrict__ y,
                T* __restrict__ a_out, T* __restrict__ b_out, int L, int d,
                int h) {
  __shared__ float Xs[SBK][SB + 1];
  __shared__ float W1s[SBK][SB + 1];
  __shared__ float W2s[SBK][SB + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * SB, n0 = blockIdx.y * SB;
  float acc1[4][4] = {}, acc2[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += SBK) {
    for (int i = tid; i < SB * SBK; i += 256) {
      const int r = i / SBK, kk = i % SBK;
      const int gr = m0 + r, gk = k0 + kk;
      Xs[kk][r] = (gr < L && gk < d) ? repro::to_f32(x[(size_t)gr * d + gk])
                                     : 0.f;
    }
    for (int i = tid; i < SBK * SB; i += 256) {
      const int kk = i / SB, c = i % SB;
      const int gk = k0 + kk, gc = n0 + c;
      const bool ok = gk < d && gc < h;
      const size_t off = (size_t)gk * h + gc;
      W1s[kk][c] = ok ? repro::to_f32(w1[off]) : 0.f;
      W2s[kk][c] = ok ? repro::to_f32(w2[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float xv[4], b1[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = W1s[kk][tx * 4 + j];
        b2[j] = W2s[kk][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] = fmaf(xv[i], b1[j], acc1[i][j]);
          acc2[i][j] = fmaf(xv[i], b2[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty * 4 + i, gc = n0 + tx * 4 + j;
      if (gr >= L || gc >= h) continue;
      const size_t o = (size_t)gr * h + gc;
      const float av = acc1[i][j], bv = acc2[i][j];
      a_out[o] = repro::from_f32<T>(av);
      b_out[o] = repro::from_f32<T>(bv);
      y[o] = repro::from_f32<T>((av * sigmoid_<false>(av)) * bv);
    }
}

template <typename T>
__global__ void __launch_bounds__(256)
swiglu_bwd_x_simt(const T* __restrict__ dy, const T* __restrict__ a,
                  const T* __restrict__ b, const T* __restrict__ w1,
                  const T* __restrict__ w2, T* __restrict__ dx, int L, int d,
                  int h) {
  __shared__ float DAs[SBK][SB + 1];   // (k of h, row)
  __shared__ float DBs[SBK][SB + 1];
  __shared__ float W1s[SBK][SB + 1];   // w1^T: (k of h, column of d)
  __shared__ float W2s[SBK][SB + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * SB, n0 = blockIdx.y * SB;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < h; k0 += SBK) {
    for (int i = tid; i < SB * SBK; i += 256) {
      const int r = i / SBK, kk = i % SBK;
      const int gr = m0 + r, gk = k0 + kk;
      float da = 0.f, db = 0.f;
      if (gr < L && gk < h) {
        const size_t o = (size_t)gr * h + gk;
        swiglu_grads<false>(repro::to_f32(dy[o]), repro::to_f32(a[o]),
                            repro::to_f32(b[o]), da, db);
      }
      DAs[kk][r] = round_to<T>(da);
      DBs[kk][r] = round_to<T>(db);
    }
    for (int i = tid; i < SBK * SB; i += 256) {
      // consecutive threads walk k, the weights' contiguous (h) axis
      const int kk = i % SBK, c = i / SBK;
      const int gk = k0 + kk, gc = n0 + c;
      const bool ok = gk < h && gc < d;
      const size_t off = (size_t)gc * h + gk;
      W1s[kk][c] = ok ? repro::to_f32(w1[off]) : 0.f;
      W2s[kk][c] = ok ? repro::to_f32(w2[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float va[4], vb[4], b1[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        va[i] = DAs[kk][ty * 4 + i];
        vb[i] = DBs[kk][ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = W1s[kk][tx * 4 + j];
        b2[j] = W2s[kk][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(vb[i], b2[j], fmaf(va[i], b1[j], acc[i][j]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty * 4 + i, gc = n0 + tx * 4 + j;
      if (gr < L && gc < d)
        dx[(size_t)gr * d + gc] = repro::from_f32<T>(acc[i][j]);
    }
}

template <typename T>
__global__ void __launch_bounds__(256)
swiglu_bwd_w_simt(const T* __restrict__ x, const T* __restrict__ dy,
                  const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ dw1, T* __restrict__ dw2, int L, int d,
                  int h) {
  __shared__ float Xs[SBK][SB + 1];    // (row of L, column of d)
  __shared__ float DAs[SBK][SB + 1];   // (row of L, column of h)
  __shared__ float DBs[SBK][SB + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * SB, n0 = blockIdx.y * SB;
  float acc1[4][4] = {}, acc2[4][4] = {};
  for (int r0 = 0; r0 < L; r0 += SBK) {
    for (int i = tid; i < SBK * SB; i += 256) {
      const int kr = i / SB, c = i % SB;
      const int r = r0 + kr;
      const int gd = m0 + c, gh = n0 + c;
      Xs[kr][c] = (r < L && gd < d) ? repro::to_f32(x[(size_t)r * d + gd])
                                    : 0.f;
      float da = 0.f, db = 0.f;
      if (r < L && gh < h) {
        const size_t o = (size_t)r * h + gh;
        swiglu_grads<false>(repro::to_f32(dy[o]), repro::to_f32(a[o]),
                            repro::to_f32(b[o]), da, db);
      }
      DAs[kr][c] = round_to<T>(da);
      DBs[kr][c] = round_to<T>(db);
    }
    __syncthreads();
#pragma unroll
    for (int kr = 0; kr < SBK; ++kr) {
      float xv[4], va[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[kr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        va[j] = DAs[kr][tx * 4 + j];
        vb[j] = DBs[kr][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] = fmaf(xv[i], va[j], acc1[i][j]);
          acc2[i][j] = fmaf(xv[i], vb[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gd = m0 + ty * 4 + i, gh = n0 + tx * 4 + j;
      if (gd >= d || gh >= h) continue;
      const size_t o = (size_t)gd * h + gh;
      dw1[o] = repro::from_f32<T>(acc1[i][j]);
      dw2[o] = repro::from_f32<T>(acc2[i][j]);
    }
}

// The tensor-core kernels' rings need more than the default 48 KB of
// dynamic shared memory.
template <typename K>
void allow_smem(K kernel, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
}

bool vec_ok(int dtype, int d, int h, std::initializer_list<const void*> ps) {
  if (dtype != REPRO_DTYPE_BF16 || d % 8 != 0 || h % 8 != 0) return false;
  for (const void* p : ps)
    if (!repro::aligned16(p)) return false;
  return true;
}

dim3 grid2(int rows, int bm, int cols, int bn) {
  return dim3((rows + bm - 1) / bm, (cols + bn - 1) / bn);
}

}  // namespace

// x: (L, d); w1, w2: (d, h); y, a, b: (L, h); all of one dtype.
REPRO_API int repro_fused_swiglu_fwd(int dtype, const void* x, const void* w1,
                                     const void* w2, void* y, void* a, void* b,
                                     int L, int d, int h,
                                     cudaStream_t stream) {
  if (L <= 0 || h <= 0) return 0;
  if (d < 0) return (int)cudaErrorInvalidValue;
  if (vec_ok(dtype, d, h, {x, w1, w2, y, a, b})) {
    const dim3 grid = grid2(L, fwd::BM, h, fwd::BN);
    auto kernel = L <= fwd::BM ? swiglu_fwd_wmma<true> : swiglu_fwd_wmma<false>;
    allow_smem(kernel, fwd::SMEM);
    kernel<<<grid, THREADS, fwd::SMEM, stream>>>(
        (const bf16*)x, (const bf16*)w1, (const bf16*)w2, (bf16*)y, (bf16*)a,
        (bf16*)b, L, d, h);
  } else if (dtype == REPRO_DTYPE_BF16) {
    swiglu_fwd_simt<bf16><<<grid2(L, SB, h, SB), 256, 0, stream>>>(
        (const bf16*)x, (const bf16*)w1, (const bf16*)w2, (bf16*)y, (bf16*)a,
        (bf16*)b, L, d, h);
  } else if (dtype == REPRO_DTYPE_F32) {
    swiglu_fwd_simt<float><<<grid2(L, SB, h, SB), 256, 0, stream>>>(
        (const float*)x, (const float*)w1, (const float*)w2, (float*)y,
        (float*)a, (float*)b, L, d, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dy, a, b: (L, h); w1, w2: (d, h); dx: (L, d); all of one dtype.
REPRO_API int repro_fused_swiglu_bwd_x(int dtype, const void* dy, const void* a,
                                       const void* b, const void* w1,
                                       const void* w2, void* dx, int L, int d,
                                       int h, cudaStream_t stream) {
  if (L <= 0 || d <= 0) return 0;
  if (h < 0) return (int)cudaErrorInvalidValue;
  if (vec_ok(dtype, d, h, {dy, a, b, w1, w2, dx})) {
    allow_smem(swiglu_bwd_x_wmma, bwdx::SMEM);
    swiglu_bwd_x_wmma<<<grid2(L, bwdx::BM, d, bwdx::BN), THREADS, bwdx::SMEM,
                        stream>>>((const bf16*)dy, (const bf16*)a,
                                  (const bf16*)b, (const bf16*)w1,
                                  (const bf16*)w2, (bf16*)dx, L, d, h);
  } else if (dtype == REPRO_DTYPE_BF16) {
    swiglu_bwd_x_simt<bf16><<<grid2(L, SB, d, SB), 256, 0, stream>>>(
        (const bf16*)dy, (const bf16*)a, (const bf16*)b, (const bf16*)w1,
        (const bf16*)w2, (bf16*)dx, L, d, h);
  } else if (dtype == REPRO_DTYPE_F32) {
    swiglu_bwd_x_simt<float><<<grid2(L, SB, d, SB), 256, 0, stream>>>(
        (const float*)dy, (const float*)a, (const float*)b, (const float*)w1,
        (const float*)w2, (float*)dx, L, d, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: (L, d); dy, a, b: (L, h); dw1, dw2: (d, h); all of one dtype.  L may
// be 0 (the gradients are then zeros).
REPRO_API int repro_fused_swiglu_bwd_w(int dtype, const void* x, const void* dy,
                                       const void* a, const void* b, void* dw1,
                                       void* dw2, int L, int d, int h,
                                       cudaStream_t stream) {
  if (d <= 0 || h <= 0) return 0;
  if (L < 0) return (int)cudaErrorInvalidValue;
  if (vec_ok(dtype, d, h, {x, dy, a, b, dw1, dw2})) {
    allow_smem(swiglu_bwd_w_wmma, bwdw::SMEM);
    swiglu_bwd_w_wmma<<<grid2(d, bwdw::BM, h, bwdw::BN), THREADS, bwdw::SMEM,
                        stream>>>((const bf16*)x, (const bf16*)dy,
                                  (const bf16*)a, (const bf16*)b, (bf16*)dw1,
                                  (bf16*)dw2, L, d, h);
  } else if (dtype == REPRO_DTYPE_BF16) {
    swiglu_bwd_w_simt<bf16><<<grid2(d, SB, h, SB), 256, 0, stream>>>(
        (const bf16*)x, (const bf16*)dy, (const bf16*)a, (const bf16*)b,
        (bf16*)dw1, (bf16*)dw2, L, d, h);
  } else if (dtype == REPRO_DTYPE_F32) {
    swiglu_bwd_w_simt<float><<<grid2(d, SB, h, SB), 256, 0, stream>>>(
        (const float*)x, (const float*)dy, (const float*)a, (const float*)b,
        (float*)dw1, (float*)dw2, L, d, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
