// Backward of the fused SwiGLU MoE layer (paper Algorithm 1 with the gather
// replayed) for Hopper.
//
// Replaces repro/kernels/gather_gmm.py:fused_moe_bwd (_fused_bwd_kernel).
// For each slot row s of expert e, with xt = x[idx[s]], dyt = dy[idx[s]]
// and g = g_slot[s]:
//     a = xt w1[e], b = xt w2[e]                  (recomputed, float32)
//     y_swi = round(silu(a) b), dyu = round(dyt w3[e]^T)    (x's dtype)
//     dgates[s] = sum_h y_swi dyu
//     da = dyu g b silu'(a),  db = dyu g silu(a)
//     dx[idx[s]] += da w1[e]^T + db w2[e]^T
//     dw1[e] += xt^T da, dw2[e] += xt^T db, dw3[e] += (g y_swi)^T dyt
// All five outputs are float32 and zeroed by the wrapper.  Nothing of size
// (S, h) or (S, d) is written: not the gathered rows, a, b, y_swi, dyu,
// da or db.
//
// The TPU kernel zeroes dx at its first grid step, carries dx across the
// sequential h axis in scratch, accumulates dgates across a tile's items
// and the weight gradients across an expert's consecutive items, and
// scatters through one-hot matmuls: all of it relies on a grid that runs in
// order.  Here a block owns one row tile of one expert (up to BM slot rows)
// and one h-chunk of BH columns, in one launch:
//   1. over d in BK-deep steps: a, b and dyu for its rows and chunk (three
//      products, rows of x and dy gathered by 16-byte cp.async copies);
//   2. the elementwise terms in float32 through a staging tile; da, db and
//      g y_swi rounded to bf16 into shared memory (the tensor-core
//      operands; the plain version keeps them in float32, which the
//      tolerance covers); the chunk's share of dgates per row;
//   3. over the d-tiles (BN wide), with x, dy, w1 and w2 tiles
//      double-buffered: dx (BM x BN), dw1 and dw2 (BN x BH) and dw3
//      (BH x BN) for this tile.
// Every cross-block sum is a float32 atomic reduction (4 floats per
// instruction; fused_moe.cuh:red_fragment) into the zeroed float32
// outputs: dx over h-chunks and a token's k slots, dgates over h-chunks,
// dw1/dw2/dw3 over the row tiles of one expert.  An expert with no rows
// has no tile, so its weight gradients stay zero.  The sum order varies
// from run to run.
//
// Bound: operations (16 S d h: 2 recomputed GEMMs, dyu, 3 weight
// gradients, 2 for dx; 7.7 TFLOP at S = 8192, d = 4096, h = 14336).
// Design: bf16 WMMA (16x16x16, float32 accumulate), 8 warps; one block per
// SM (about 174 KB of shared memory).  float32 inputs, and d or h not a
// multiple of 8, take a plain float32-FMA kernel with the same
// decomposition, which keeps da and db in float32 as the reference does.

#include "fused_moe.cuh"

namespace {

using namespace repro::fused;
using bf16 = __nv_bfloat16;

constexpr int STAGES = 3;
// phase 1 stage: x rows, dy rows (BM x BK), w1, w2 (BK x BH), w3 rows of
// the chunk (BH x BK, read as a column-major w3^T)
constexpr int X1 = BM * LDK;
constexpr int W1 = BK * LDH;
constexpr int W3T = BH * LDK;
constexpr int ST1_EL = 2 * X1 + 2 * W1 + W3T;
constexpr int RING_BYTES = STAGES * ST1_EL * (int)sizeof(bf16);
constexpr int CS_BYTES = 3 * BM * LDC * (int)sizeof(float);
// phase 3 buffer: x and dy tiles (BM x BN), w1 and w2 tiles (BN x BH)
constexpr int X3 = BM * LDN;
constexpr int W13 = BN * LDH;
constexpr int BUF3_EL = 2 * X3 + 2 * W13;
constexpr int P3_BYTES = 2 * BUF3_EL * (int)sizeof(bf16);
constexpr int R_BYTES = RING_BYTES > CS_BYTES
                            ? (RING_BYTES > P3_BYTES ? RING_BYTES : P3_BYTES)
                            : (CS_BYTES > P3_BYTES ? CS_BYTES : P3_BYTES);
constexpr int OPS_BYTES = 3 * BM * LDH * (int)sizeof(bf16);  // da, db, g y_swi
constexpr int STG_BYTES = (THREADS / 32) * 16 * LDW * (int)sizeof(float);
constexpr int SMEM_BYTES = R_BYTES + OPS_BYTES + STG_BYTES;

using namespace nvcuda;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

__global__ void __launch_bounds__(THREADS)
bwd_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                const float* __restrict__ g_slot, const int* __restrict__ idx,
                const int* __restrict__ offsets, const bf16* __restrict__ w1,
                const bf16* __restrict__ w2, const bf16* __restrict__ w3,
                float* __restrict__ dx, float* __restrict__ dg,
                float* __restrict__ dw1, float* __restrict__ dw2,
                float* __restrict__ dw3, int S, int L, int d, int h, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int info[3];
  __shared__ int tok_s[BM];
  __shared__ float g_s[BM];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  bf16* Da = reinterpret_cast<bf16*>(smem + R_BYTES);
  bf16* Db = Da + BM * LDH;
  bf16* Yg = Db + BM * LDH;
  float* stg = reinterpret_cast<float*>(smem + R_BYTES + OPS_BYTES);

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

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // 4 x 2 warps, 32 x 32 of a BM x 64 tile
  const int wn = (warp % 2) * 32;

  // ---- 1. a, b, dyu over d ------------------------------------------------
  const int wr = tid / (BH / 8), wc = (tid % (BH / 8)) * 8;   // w1 / w2
  const int tr = tid / (BK / 8), tc = (tid % (BK / 8)) * 8;   // w3 rows
  auto load1 = [&](int step, int stage) {
    const int k0 = step * BK;
    bf16* X = ring + stage * ST1_EL;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int piece = tid + c * THREADS;
      const int r = piece / (BK / 8), col = (piece % (BK / 8)) * 8;
      const int t = tok_s[r];
      const bool ok = t >= 0 && k0 + col < d;
      const size_t off = (size_t)t * d + k0 + col;
      repro::cp_async16(X + r * LDK + col, ok ? x + off : x, ok);
      repro::cp_async16(X + X1 + r * LDK + col, ok ? dy + off : dy, ok);
    }
    bool ok = k0 + wr < d && j0 + wc < h;
    size_t off = (size_t)(k0 + wr) * h + j0 + wc;
    repro::cp_async16(X + 2 * X1 + wr * LDH + wc, ok ? w1e + off : w1e, ok);
    repro::cp_async16(X + 2 * X1 + W1 + wr * LDH + wc, ok ? w2e + off : w2e,
                      ok);
    ok = j0 + tr < h && k0 + tc < d;
    off = (size_t)(j0 + tr) * d + k0 + tc;
    repro::cp_async16(X + 2 * X1 + 2 * W1 + tr * LDK + tc,
                      ok ? w3e + off : w3e, ok);
  };
  {
    AccFrag acc_a[2][2], acc_b[2][2], acc_u[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(acc_a[i][j], 0.f);
        wmma::fill_fragment(acc_b[i][j], 0.f);
        wmma::fill_fragment(acc_u[i][j], 0.f);
      }
    const int nsteps = (d + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nsteps) load1(s, s);
      repro::cp_async_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
      repro::cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nxt = s + STAGES - 1;
      if (nxt < nsteps) load1(nxt, nxt % STAGES);
      repro::cp_async_commit();
      const bf16* X = ring + (s % STAGES) * ST1_EL;
      const bf16* DY = X + X1;
      const bf16* B1 = X + 2 * X1;
      const bf16* B2 = B1 + W1;
      const bf16* B3 = B2 + W1;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA a[2];
        FragB b[2];
        FragBc bt[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], X + (wm + i * 16) * LDK + kk, LDK);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], B1 + kk * LDH + wn + j * 16, LDH);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc_a[i][j], a[i], b[j], acc_a[i][j]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], B2 + kk * LDH + wn + j * 16, LDH);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc_b[i][j], a[i], b[j], acc_b[i][j]);
        // dyu = dyt w3^T: element (k, j) of the operand is w3[e][j][k],
        // the chunk's w3 rows read column-major.
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], DY + (wm + i * 16) * LDK + kk, LDK);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bt[j], B3 + (wn + j * 16) * LDK + kk, LDK);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc_u[i][j], a[i], bt[j], acc_u[i][j]);
      }
    }
    repro::cp_async_wait<0>();
    __syncthreads();  // the staging tiles reuse the ring
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = (wm + i * 16) * LDC + wn + j * 16;
        wmma::store_matrix_sync(Cs + o, acc_a[i][j], LDC, wmma::mem_row_major);
        wmma::store_matrix_sync(Cs + BM * LDC + o, acc_b[i][j], LDC,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(Cs + 2 * BM * LDC + o, acc_u[i][j], LDC,
                                wmma::mem_row_major);
      }
  }
  __syncthreads();

  // ---- 2. elementwise terms and dgates -------------------------------------
  // Thread t takes row t / 2, columns (t % 2) * 32 .. + 32.
  {
    const int r = tid / 2, c0 = (tid % 2) * (BH / 2);
    const float g = g_s[r];
    float dgp = 0.f;
    for (int c = c0; c < c0 + BH / 2; ++c) {
      const float av = Cs[r * LDC + c];
      const float bv = Cs[BM * LDC + r * LDC + c];
      const float u = round_bf16(Cs[2 * BM * LDC + r * LDC + c]);
      const float sg = sigmoidf(av);
      const float sa = av * sg;
      const float ys = round_bf16(sa * bv);
      dgp += ys * u;
      const float dys = u * g;
      Da[r * LDH + c] = __float2bfloat16_rn(dys * bv * (sg * (1.f + av * (1.f - sg))));
      Db[r * LDH + c] = __float2bfloat16_rn(dys * sa);
      Yg[r * LDH + c] = __float2bfloat16_rn(ys * g);
    }
    dgp += __shfl_xor_sync(0xffffffffu, dgp, 1);
    if ((tid & 1) == 0 && tok_s[r] >= 0) red_add(dg + r0 + r, dgp);
  }
  __syncthreads();  // the phase-3 buffers reuse the staging tiles

  // ---- 3. dx, dw1, dw2, dw3 over the d-tiles --------------------------------
  auto load3 = [&](int nt, int buf) {
    const int n0 = nt * BN;
    bf16* X = ring + buf * BUF3_EL;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // BM x BN / 8 = 1024 pieces each
      const int piece = tid + c * THREADS;
      const int r = piece / (BN / 8), col = (piece % (BN / 8)) * 8;
      const int t = tok_s[r];
      const bool ok = t >= 0 && n0 + col < d;
      const size_t off = (size_t)t * d + n0 + col;
      repro::cp_async16(X + r * LDN + col, ok ? x + off : x, ok);
      repro::cp_async16(X + X3 + r * LDN + col, ok ? dy + off : dy, ok);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // BN x BH / 8 = 512 pieces each
      const int piece = tid + c * THREADS;
      const int n = piece / (BH / 8), col = (piece % (BH / 8)) * 8;
      const bool ok = n0 + n < d && j0 + col < h;
      const size_t off = (size_t)(n0 + n) * h + j0 + col;
      repro::cp_async16(X + 2 * X3 + n * LDH + col, ok ? w1e + off : w1e, ok);
      repro::cp_async16(X + 2 * X3 + W13 + n * LDH + col,
                        ok ? w2e + off : w2e, ok);
    }
  };
  float* wstg = stg + warp * 16 * LDW;
  // weight-gradient tiles are 64 x 64: warp w takes rows (w / 2) * 16 and
  // columns (w % 2) * 32 of each
  const int gm = (warp / 2) * 16, gn = (warp % 2) * 32;
  float* dw1e = dw1 + (size_t)e * d * h;
  float* dw2e = dw2 + (size_t)e * d * h;
  float* dw3e = dw3 + (size_t)e * h * d;
  const int ntiles = (d + BN - 1) / BN;
  load3(0, 0);
  repro::cp_async_commit();
  for (int nt = 0; nt < ntiles; ++nt) {
    repro::cp_async_wait<0>();
    __syncthreads();
    if (nt + 1 < ntiles) load3(nt + 1, (nt + 1) & 1);
    repro::cp_async_commit();
    const int n0 = nt * BN;
    const bf16* X = ring + (nt & 1) * BUF3_EL;
    const bf16* DY = X + X3;
    const bf16* W1t = X + 2 * X3;  // (n, j): w1[e][n0 + n][j0 + j]
    const bf16* W2t = W1t + W13;

    // dx (BM x BN) = da w1^T + db w2^T: operand (j, n) = W1t[n][j], read
    // column-major.
    {
      AccFrag acc[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
      for (int kk = 0; kk < BH; kk += 16) {
        FragA a[2];
        FragBc b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], Da + (wm + i * 16) * LDH + kk, LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], W1t + (wn + j * 16) * LDH + kk, LDH);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], Db + (wm + i * 16) * LDH + kk, LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], W2t + (wn + j * 16) * LDH + kk, LDH);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rb = wm + i * 16;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          red_fragment(
              acc[i][j], wstg, dx,
              [&](int rr) -> long {
                const int t = tok_s[rb + rr];
                return t >= 0 ? (long)t * d : -1;
              },
              [](int) { return 1.f; }, n0 + wn + j * 16, d);
      }
    }
    // dw1, dw2 (BN x BH) = xt^T da, xt^T db: operand (n, r) = X[r][n], read
    // column-major; dw3 (BH x BN) = (g y_swi)^T dyt likewise.
    {
      AccFrag a1[2], a2[2], a3[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(a1[j], 0.f);
        wmma::fill_fragment(a2[j], 0.f);
        wmma::fill_fragment(a3[j], 0.f);
      }
#pragma unroll 2
      for (int kk = 0; kk < BM; kk += 16) {
        FragAc at;
        FragB b[2];
        wmma::load_matrix_sync(at, X + kk * LDN + gm, LDN);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Da + kk * LDH + gn + j * 16, LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(a1[j], at, b[j], a1[j]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Db + kk * LDH + gn + j * 16, LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(a2[j], at, b[j], a2[j]);
        wmma::load_matrix_sync(at, Yg + kk * LDH + gm, LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], DY + kk * LDN + gn + j * 16, LDN);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(a3[j], at, b[j], a3[j]);
      }
      auto n_row = [&](int rr) -> long {
        const int n = n0 + gm + rr;
        return n < d ? (long)n * h : -1;
      };
      auto j_row = [&](int rr) -> long {
        const int j = j0 + gm + rr;
        return j < h ? (long)j * d : -1;
      };
      auto one = [](int) { return 1.f; };
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red_fragment(a1[j], wstg, dw1e, n_row, one, j0 + gn + j * 16, h);
        red_fragment(a2[j], wstg, dw2e, n_row, one, j0 + gn + j * 16, h);
        red_fragment(a3[j], wstg, dw3e, j_row, one, n0 + gn + j * 16, d);
      }
    }
  }
}

// General path: the same three phases on SBM x SBH tiles in float32 FMA;
// da and db stay float32.  Each thread computes 2 x 2 outputs of each
// product (rows ty * 2.., columns tx * 2..).
template <typename T>
__global__ void __launch_bounds__(256)
bwd_simt_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ g_slot, const int* __restrict__ idx,
                const int* __restrict__ offsets, const T* __restrict__ w1,
                const T* __restrict__ w2, const T* __restrict__ w3,
                float* __restrict__ dx, float* __restrict__ dg,
                float* __restrict__ dw1, float* __restrict__ dw2,
                float* __restrict__ dw3, int S, int L, int d, int h, int E) {
  constexpr int P = SBH + 1;  // padded row of every 32 x 32 tile
  __shared__ float Xs[SBM][P], DYs[SBM][P];
  __shared__ float W1s[SBK][P], W2s[SBK][P], W3s[SBK][P];
  __shared__ float Da[SBM][P], Db[SBM][P], Yg[SBM][P];
  __shared__ int info[3];
  __shared__ int tok_s[SBM];
  __shared__ float g_s[SBM];
  locate_tile(offsets, E, S, SBM, info);
  const int e = info[0];
  if (e < 0) return;
  const int r0 = info[1], r1 = info[2];
  const int j0 = blockIdx.y * SBH;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  load_rows(idx, g_slot, r0, r1, L, SBM, tok_s, g_s);
  __syncthreads();
  const T* w1e = w1 + (size_t)e * d * h;
  const T* w2e = w2 + (size_t)e * d * h;
  const T* w3e = w3 + (size_t)e * h * d;
  auto gather = [&](float (*dst)[P], const T* src, int k0) {
    for (int i = tid; i < SBM * SBK; i += 256) {
      const int r = i / SBK, kk = i % SBK;
      const int t = tok_s[r];
      dst[r][kk] = (t >= 0 && k0 + kk < d)
                       ? repro::to_f32(src[(size_t)t * d + k0 + kk]) : 0.f;
    }
  };

  // 1. a, b, dyu
  float a[2][2] = {}, b[2][2] = {}, u[2][2] = {};
  for (int k0 = 0; k0 < d; k0 += SBK) {
    gather(Xs, x, k0);
    gather(DYs, dy, k0);
    for (int i = tid; i < SBK * SBH; i += 256) {
      const int kk = i / SBH, c = i % SBH;
      bool ok = k0 + kk < d && j0 + c < h;
      const size_t off = (size_t)(k0 + kk) * h + j0 + c;
      W1s[kk][c] = ok ? repro::to_f32(w1e[off]) : 0.f;
      W2s[kk][c] = ok ? repro::to_f32(w2e[off]) : 0.f;
      // W3s[k][j] = w3[e][j0 + j][k0 + k]; consecutive threads walk k
      const int jr = i / SBK, kc = i % SBK;
      ok = j0 + jr < h && k0 + kc < d;
      W3s[kc][jr] = ok ? repro::to_f32(w3e[(size_t)(j0 + jr) * d + k0 + kc])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < SBK; ++kk)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float xv = Xs[ty * 2 + i][kk], dv = DYs[ty * 2 + i][kk];
          const int c = tx * 2 + j;
          a[i][j] = fmaf(xv, W1s[kk][c], a[i][j]);
          b[i][j] = fmaf(xv, W2s[kk][c], b[i][j]);
          u[i][j] = fmaf(dv, W3s[kk][c], u[i][j]);
        }
    __syncthreads();
  }
  // 2. elementwise terms; y_swi * dyu per element into Xs for the row sums
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ty * 2 + i, c = tx * 2 + j;
      const float av = a[i][j], bv = b[i][j], g = g_s[r];
      const float uv = repro::to_f32(repro::from_f32<T>(u[i][j]));
      const float sg = sigmoidf(av);
      const float sa = av * sg;
      const float ys = repro::to_f32(repro::from_f32<T>(sa * bv));
      const float dys = uv * g;
      Da[r][c] = dys * bv * (sg * (1.f + av * (1.f - sg)));
      Db[r][c] = dys * sa;
      Yg[r][c] = ys * g;
      Xs[r][c] = ys * uv;
    }
  __syncthreads();
  if (tid < SBM && tok_s[tid] >= 0) {
    float s = 0.f;
    for (int c = 0; c < SBH; ++c) s += Xs[tid][c];
    red_add(dg + r0 + tid, s);
  }
  __syncthreads();
  // 3. dx, dw1, dw2, dw3 over the d-tiles
  for (int n0 = 0; n0 < d; n0 += SBK) {
    gather(Xs, x, n0);
    gather(DYs, dy, n0);
    for (int i = tid; i < SBK * SBH; i += 256) {
      const int n = i / SBH, c = i % SBH;  // W1s[n][j] = w1[e][n0 + n][j0 + j]
      const bool ok = n0 + n < d && j0 + c < h;
      const size_t off = (size_t)(n0 + n) * h + j0 + c;
      W1s[n][c] = ok ? repro::to_f32(w1e[off]) : 0.f;
      W2s[n][c] = ok ? repro::to_f32(w2e[off]) : 0.f;
    }
    __syncthreads();
    float ox[2][2] = {}, o1[2][2] = {}, o2[2][2] = {}, o3[2][2] = {};
#pragma unroll 4
    for (int q = 0; q < 32; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ri = ty * 2 + i, cj = tx * 2 + j;
          // dx[r][n]: q runs over the chunk's columns
          ox[i][j] = fmaf(Da[ri][q], W1s[cj][q],
                          fmaf(Db[ri][q], W2s[cj][q], ox[i][j]));
          // dw1[n][j], dw2[n][j]: q runs over rows (ri is n, cj is j)
          o1[i][j] = fmaf(Xs[q][ri], Da[q][cj], o1[i][j]);
          o2[i][j] = fmaf(Xs[q][ri], Db[q][cj], o2[i][j]);
          // dw3[j][n]: ri is j, cj is n
          o3[i][j] = fmaf(Yg[q][ri], DYs[q][cj], o3[i][j]);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ri = ty * 2 + i, cj = tx * 2 + j;
        const int t = tok_s[ri];
        if (t >= 0 && n0 + cj < d) red_add(dx + (size_t)t * d + n0 + cj, ox[i][j]);
        if (n0 + ri < d && j0 + cj < h) {
          const size_t o = (size_t)(n0 + ri) * h + j0 + cj;
          red_add(dw1 + (size_t)e * d * h + o, o1[i][j]);
          red_add(dw2 + (size_t)e * d * h + o, o2[i][j]);
        }
        if (j0 + ri < h && n0 + cj < d)
          red_add(dw3 + ((size_t)e * h + j0 + ri) * d + n0 + cj, o3[i][j]);
      }
    __syncthreads();
  }
}

}  // namespace

// x, dy: (L, d); g_slot: (S,) float32; idx: (S,) int32; offsets: (E+1,)
// int32; w1, w2: (E, d, h); w3: (E, h, d), all of x's dtype.  Outputs, all
// float32 and zeroed by the caller: dx (L, d), dg (S,), dw1, dw2 (E, d, h),
// dw3 (E, h, d).
REPRO_API int repro_fused_moe_bwd(int dtype, const void* x, const void* dy,
                                  const float* g_slot, const int* idx,
                                  const int* offsets, const void* w1,
                                  const void* w2, const void* w3, float* dx,
                                  float* dg, float* dw1, float* dw2,
                                  float* dw3, int S, int L, int d, int h,
                                  int E, cudaStream_t stream) {
  if (E < 1 || d <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if (S <= 0 || L <= 0) return 0;
  if (dtype == REPRO_DTYPE_BF16 && d % 8 == 0 && h % 8 == 0 &&
      repro::aligned16(x) && repro::aligned16(dy) && repro::aligned16(w1) &&
      repro::aligned16(w2) && repro::aligned16(w3)) {
    cudaFuncSetAttribute(bwd_wmma_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    dim3 grid(max_row_tiles(S, E, BM), (h + BH - 1) / BH);
    bwd_wmma_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
        (const bf16*)x, (const bf16*)dy, g_slot, idx, offsets,
        (const bf16*)w1, (const bf16*)w2, (const bf16*)w3, dx, dg, dw1, dw2,
        dw3, S, L, d, h, E);
  } else if (dtype == REPRO_DTYPE_BF16 || dtype == REPRO_DTYPE_F32) {
    dim3 grid(max_row_tiles(S, E, SBM), (h + SBH - 1) / SBH);
    if (dtype == REPRO_DTYPE_BF16)
      bwd_simt_kernel<bf16><<<grid, 256, 0, stream>>>(
          (const bf16*)x, (const bf16*)dy, g_slot, idx, offsets,
          (const bf16*)w1, (const bf16*)w2, (const bf16*)w3, dx, dg, dw1, dw2,
          dw3, S, L, d, h, E);
    else
      bwd_simt_kernel<float><<<grid, 256, 0, stream>>>(
          (const float*)x, (const float*)dy, g_slot, idx, offsets,
          (const float*)w1, (const float*)w2, (const float*)w3, dx, dg, dw1,
          dw2, dw3, S, L, d, h, E);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
