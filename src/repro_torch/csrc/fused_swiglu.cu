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
//   bwd_x: block = (128 rows x 256 columns of d) of dx, warp-specialized
//          for Hopper: a producer warp streams dy, a, b and w1, w2 tiles by
//          TMA into a 4-stage ring; two consumer warpgroups form da and db
//          in registers, in the wgmma A-fragment layout, and issue wgmma
//          against w1 and w2 into one float32 accumulator.  da and db never
//          reach HBM; they are recomputed for each 256-wide d-tile.
//   bwd_w: block = (64 columns of h x 256 columns of d) of dw1^T and
//          dw2^T, warp-specialized the same way: TMA brings dy, a, b and x
//          tiles of 64 rows of L; the two consumer warpgroups turn dy and
//          a into da and db in shared memory, once per block, then one
//          runs wgmma with da^T, the other with db^T, as A (MN-major from
//          shared memory) against the x tile; the epilogue stores the
//          transposes through shared memory.
//
// Bound: operations at training and prefill (4 L d h each: 1.46 TFLOP at
// L = 4096, d = 5120, h = 17408) and bytes at decode (L = 4 slots read
// 356.5 MB of w1 | w2).  Design: fwd is bf16 WMMA (16x16x16, float32
// accumulate) fed by a ring of 16-byte cp.async copies; bwd_x (m64n256k16,
// A from registers) and bwd_w (m64n128k16, A from shared memory) are wgmma
// fed by TMA.
// Any L, d and h: tails are bounds-checked (rows past L and columns past d
// or h are zero-filled on load and never stored).  float32, and bf16 widths
// that are not a multiple of 8 (or unaligned pointers), take a plain
// float32-FMA tiled kernel with scalar, masked loads.

#include <mma.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

using namespace repro::hopper;

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
// backward dx, Hopper tensor cores: (dy, a, b, w1, w2) -> dx
//
// dx (L x d) = da w1^T + db w2^T with K = h.  w1 and w2 are (d, h) row-major,
// so as the B operand (N = d, K = h) they are already K-major: TMA copies
// their (BN x BK) tiles, 64-byte swizzled, which is the layout wgmma reads
// from shared memory.  dy, a and b arrive the same way as (BM x BK) tiles.
// One producer warp issues the TMA copies into a ring of STAGES stages
// (mbarriers full / empty); two consumer warpgroups, 64 rows each, read
// their dy, a, b fragments with ldmatrix straight into the wgmma A-register
// layout, form da = dy b silu'(a) and db = dy silu(a) in float32, round each
// to bf16 (the reference's rounding points), and issue register-A wgmma
// m64n256k16 against w1 and then w2 into one float32 accumulator.  One
// wgmma group stays in flight, so the next k-step's elementwise work
// overlaps the tensor cores.  da and db never leave registers; they are
// recomputed once per 256-wide d-tile (d / 256 times).  One persistent
// block per SM walks the tiles, rows of L fastest, so the blocks at work
// share their w1 / w2 tiles in L2, and the producer fills the ring for the
// next tile while the consumers store the last one.  Tails
// (rows past L, columns past d, h past the last BK) are zero-filled by TMA
// and never stored.
// ---------------------------------------------------------------------------

namespace bwdx {
constexpr int BM = 128, BN = 256, STAGES = 4;
static_assert(BK == 32, "the 64-byte swizzle holds rows of 32 bf16");
constexpr int CONSUMERS = 2;                       // warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 2;               // a dy, a or b tile
constexpr int B_BYTES = BN * BK * 2;               // a w1 or w2 tile
constexpr int STAGE_BYTES = 3 * A_BYTES + 2 * B_BYTES;
// the ring, 1024 bytes to align it, the full and empty barriers
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
}  // namespace bwdx

// da, db of two bf16 pairs (dy, a, b) as bf16 pairs, each element rounded
// once from float32.
__device__ __forceinline__ void grads_pair(uint32_t dy, uint32_t a,
                                           uint32_t b, uint32_t& da,
                                           uint32_t& db) {
  float da0, db0, da1, db1;
  swiglu_grads<true>(__uint_as_float(dy << 16), __uint_as_float(a << 16),
                     __uint_as_float(b << 16), da0, db0);
  swiglu_grads<true>(__uint_as_float(dy & 0xffff0000u),
                     __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b & 0xffff0000u), da1, db1);
  const __nv_bfloat162 pa = __floats2bfloat162_rn(da0, da1);
  const __nv_bfloat162 pb = __floats2bfloat162_rn(db0, db1);
  da = *reinterpret_cast<const uint32_t*>(&pa);
  db = *reinterpret_cast<const uint32_t*>(&pb);
}

__global__ void __launch_bounds__(bwdx::THREADS, 1)
swiglu_bwd_x_wgmma(const __grid_constant__ CUtensorMap tm_dy,
                   const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_w1,
                   const __grid_constant__ CUtensorMap tm_w2,
                   bf16* __restrict__ dx, int L, int d, int h) {
  using namespace bwdx;
  extern __shared__ unsigned char smem[];
  // the swizzle is a function of address bits: align the ring to 1024
  const uint32_t raw = smem_u32(smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;   // STAGES barriers
  const uint32_t empty = full + STAGES * 8;            // STAGES barriers

  // Persistent: each block walks tiles blockIdx.x, + gridDim.x, ...; the
  // tile index runs over rows of L fastest.  Ring positions count k-steps
  // across tiles, so the producer runs ahead into the next tile while the
  // consumers store the last one.
  const int n_m = (L + BM - 1) / BM;
  const int n_tiles = n_m * ((d + BN - 1) / BN);
  const int nk = (h + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::);
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile % n_m) * BM, n0 = (tile / n_m) * BN;
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES)
            mbar_wait_spin(empty + 8 * st, (it / STAGES - 1) & 1);
          const uint32_t bar = full + 8 * st;
          const uint32_t s0 = ring + st * STAGE_BYTES;
          const int k0 = ks * BK;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(s0, &tm_dy, k0, m0, bar);
          tma_load(s0 + A_BYTES, &tm_a, k0, m0, bar);
          tma_load(s0 + 2 * A_BYTES, &tm_b, k0, m0, bar);
          tma_load(s0 + 3 * A_BYTES, &tm_w1, k0, n0, bar);
          tma_load(s0 + 3 * A_BYTES + B_BYTES, &tm_w2, k0, n0, bar);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::);
  const int cw = wg - 1;                       // consumer warpgroup
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // ldmatrix: lanes 0-7 / 8-15 / 16-23 / 24-31 address rows 0-7 / 8-15 /
  // 0-7 / 8-15 of the warp's 16 rows, at k 0-7 / 0-7 / 8-15 / 8-15.
  const int lrow = cw * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t lrow_off = (uint32_t)lrow * 64;
  const int lswz = (lrow >> 1) & 3;            // the 64-byte swizzle
  uint32_t fa[2][4] = {}, fb[2][4] = {};       // da, db of two k-steps
  float acc[128];
  int it = 0;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile % n_m) * BM, n0 = (tile / n_m) * BN;
    if (m0 + cw * 64 >= L) {
      // rows wholly past L (uniform in the warpgroup): no products, but
      // the ring's stages are released
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int st = it % STAGES;
        mbar_wait_spin(full + 8 * st, (it / STAGES) & 1);
        if (lane == 0) mbar_arrive(empty + 8 * st);
        __syncwarp();
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait_spin(full + 8 * st, (it / STAGES) & 1);
      const uint32_t s0 = ring + st * STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t off =
            lrow_off + ((uint32_t)((kk * 2 + (lane >> 4)) ^ lswz) << 4);
        uint32_t vdy[4], va[4], vb[4];
        ldmatrix_x4(vdy, s0 + off);
        ldmatrix_x4(va, s0 + A_BYTES + off);
        ldmatrix_x4(vb, s0 + 2 * A_BYTES + off);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          grads_pair(vdy[i], va[i], vb[i], fa[kk][i], fb[kk][i]);
        wgmma_fence();
        wgmma_m64n256k16_rs<0>(acc, fa[kk],
                               desc_sw64(s0 + 3 * A_BYTES + kk * 32), 1);
        wgmma_m64n256k16_rs<0>(
            acc, fb[kk], desc_sw64(s0 + 3 * A_BYTES + B_BYTES + kk * 32), 1);
        wgmma_commit();
        // the previous k-step's products are done: its fragments may be
        // overwritten, and at a stage boundary its stage is free
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          reg_fence(fa[kk ^ 1][i]);
          reg_fence(fb[kk ^ 1][i]);
        }
        if (kk == 0 && ks > 0) {
          if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
          __syncwarp();
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    __syncwarp();

    // accumulator layout: value 4j + 2i + e is row 16 warp + lane / 4 + 8 i,
    // column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 256 tile
    const int row = m0 + cw * 64 + warp * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      if (col >= d) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row + 8 * i;
        if (r < L)
          *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)r * d + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i],
                                    acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward dw, Hopper tensor cores: (x, dy, a, b) -> (dw1, dw2)
//
// Computed transposed: dw1^T (h x d) = da^T x and dw2^T = db^T x, with
// M = h, N = d and the contraction over L.  A block owns 64 columns of h
// by 256 of d and walks the whole of L itself (no split of the
// contraction, no atomics).  A producer warp brings dy, a and b as
// (64 rows of L x 64 of h) tiles and x as four (64 x 64 of d) boxes by
// TMA, 128-byte swizzled, into a 3-stage ring (mbarriers full / empty).
// The 256 threads of the two consumer warpgroups first turn the stage's
// dy and a into da and db in place (float32, each rounded once to bf16:
// the reference's rounding points), so each element's gradient is formed
// once per block and not once per warpgroup; after a proxy fence and a
// barrier of the two warpgroups, warpgroup 0 runs m64n256k16 with da^T
// (read MN-major from shared memory) as A against the x tile (MN-major)
// into dw1^T's accumulator, warpgroup 1 the same with db^T into dw2^T's.
// One wgmma group stays in flight, so the next stage's gradients overlap
// the tensor cores.  The epilogue rounds the accumulator once and writes
// it transposed through shared memory, so the stores to (d, h) are 16-byte
// and coalesced.  Persistent: one block per SM walks the tiles, columns of
// d fastest, so the blocks at work share their dy, a, b tiles in L2.
// Tails (rows past L, columns past d or h) are zero-filled by TMA (da = db
// = 0 there) and never stored.
//
// What the design was chosen from (tools/kernel_ab.py on an H100 80GB
// HBM3 at 700 W, Qwen3-14B at L = 4096, medians of 4): the gradients cost
// ~1 ms of the kernel (a copy that skips them read 2.40 ms against 3.47);
// stages of 64 rows of L read 3.02 ms against 3.47 for 6 stages of 32,
// 3.12 for 4 of 48 and 4.51 for 2 of 96; one m64n256 product per
// warpgroup read as two m64n128 products per warpgroup (3.458 against
// 3.458); mbar_wait_spin read 3.04 ms against 3.13 with mbar_wait.  The
// register-A alternative (each warpgroup loads dy, a, b with
// ldmatrix.trans into wgmma's A registers and forms its own gradient, so
// there is no write-back, proxy fence or 256-thread barrier, but every
// sigmoid is computed by both warpgroups) read 3.68 ms against 3.02 when
// each k-step waits for its product; letting one product stay in flight
// (3.62-3.84 ms) gave wrong columns past the first 64 in ~0.4% of the
// outputs, from run to run, and also with four fragment buffers.
// ---------------------------------------------------------------------------

namespace bwdw {
constexpr int BM = 64;                       // columns of h (rows of dw^T)
constexpr int BN = 256;                      // columns of d
constexpr int BKL = 64, STAGES = 3;          // rows of L per stage
constexpr int CONSUMERS = 2, THREADS = 128 * (CONSUMERS + 1);
constexpr int Y_BYTES = BKL * BM * 2;        // a dy, a or b tile
constexpr int X_BOX = BKL * 64 * 2;          // one 64-wide box of x
constexpr int STAGE_BYTES = 3 * Y_BYTES + (BN / 64) * X_BOX;
static_assert(STAGE_BYTES % 1024 == 0, "stages keep the swizzle alignment");
constexpr int LDO = BM + 8;                  // output staging rows (bf16)
constexpr int OUT_BYTES = BN * LDO * 2;
// the ring, the output staging, 1024 bytes to align the ring, the barriers
constexpr int SMEM = STAGES * STAGE_BYTES + OUT_BYTES + 1024 + 2 * STAGES * 8;
}  // namespace bwdw

// Rounds a warpgroup's 64 x 256 accumulator (rows m of h, columns n of
// d) once and stores it transposed at dw[n0 + n][m0 + m]: 128 columns at
// a time through the warpgroup's 128 rows of the staging tile, then 16
// bytes a thread.
__device__ __forceinline__ void store_dw_t(const float (&acc)[128],
                                           bf16* out_s, bf16* __restrict__ dw,
                                           int m0, int n0, int d, int h,
                                           int cw) {
  using namespace bwdw;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  bf16* rows = out_s + cw * 128 * LDO;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // accumulator value 4 j + 2 i + e: row 16 warp + lane / 4 + 8 i,
    // column 8 j + 2 (lane % 4) + e
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          rows[(8 * j + 2 * (lane % 4) + e) * LDO + warp * 16 + lane / 4 +
               8 * i] =
              __float2bfloat16_rn(acc[4 * (16 * half + j) + 2 * i + e]);
    named_barrier(2 + cw, 128);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int p = t + 128 * q;
      const int row = p / 8, col = (p % 8) * 8;
      const int gn = n0 + 128 * half + row, gm = m0 + col;
      if (gn < d && gm < h)
        *reinterpret_cast<uint4*>(dw + (size_t)gn * h + gm) =
            *reinterpret_cast<const uint4*>(rows + row * LDO + col);
    }
    named_barrier(2 + cw, 128);
  }
}

__global__ void __launch_bounds__(bwdw::THREADS, 1)
swiglu_bwd_w_wgmma(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_dy,
                   const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   bf16* __restrict__ dw1, bf16* __restrict__ dw2, int L,
                   int d, int h) {
  using namespace bwdw;
  extern __shared__ unsigned char smem[];
  // the swizzle is a function of address bits: align the ring to 1024
  const uint32_t raw = smem_u32(smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_p = smem + (ring - raw);
  bf16* out_s = reinterpret_cast<bf16*>(ring_p + STAGES * STAGE_BYTES);
  const uint32_t full = ring + STAGES * STAGE_BYTES + OUT_BYTES;
  const uint32_t empty = full + STAGES * 8;

  // Ring positions count stages across tiles, so the producer runs ahead
  // into the next tile while the consumers store the last one.
  const int n_d = (d + BN - 1) / BN;
  const int n_tiles = ((h + BM - 1) / BM) * n_d;
  const int nk = (L + BKL - 1) / BKL;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::);
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_d) * BM, n0 = (tile % n_d) * BN;
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES)
            mbar_wait_spin(empty + 8 * st, (it / STAGES - 1) & 1);
          const uint32_t bar = full + 8 * st;
          const uint32_t s0 = ring + st * STAGE_BYTES;
          const int k0 = ks * BKL;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(s0, &tm_dy, m0, k0, bar);
          tma_load(s0 + Y_BYTES, &tm_a, m0, k0, bar);
          tma_load(s0 + 2 * Y_BYTES, &tm_b, m0, k0, bar);
#pragma unroll
          for (int q = 0; q < BN / 64; ++q)
            tma_load(s0 + 3 * Y_BYTES + q * X_BOX, &tm_x, n0 + q * 64, k0,
                     bar);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::);
  const int cw = wg - 1;                       // consumer warpgroup
  const int lane = threadIdx.x % 32;
  // warpgroup 0 accumulates dw1^T = da^T x, warpgroup 1 dw2^T = db^T x
  bf16* const dw = cw == 0 ? dw1 : dw2;
  float acc[128];
  int it = 0;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / n_d) * BM, n0 = (tile % n_d) * BN;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait_spin(full + 8 * st, (it / STAGES) & 1);
      unsigned char* sp = ring_p + st * STAGE_BYTES;
      // dy -> da, a -> db in place (the three tiles share one layout),
      // 16 bytes of each a thread per step
      for (int p = (threadIdx.x - 128) * 16; p < Y_BYTES;
           p += 128 * CONSUMERS * 16)
        grads8_inplace(reinterpret_cast<bf16*>(sp + p),
                       reinterpret_cast<bf16*>(sp + Y_BYTES + p),
                       reinterpret_cast<const bf16*>(sp + 2 * Y_BYTES + p));
      fence_proxy_async();
      named_barrier(1, 128 * CONSUMERS);
      const uint32_t s0 = ring + st * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKL / 16; ++kk)
        wgmma_m64n256k16_ss<1, 1>(
            acc, desc_mn_sw128(s0 + cw * Y_BYTES + kk * 2048, Y_BYTES),
            desc_mn_sw128(s0 + 3 * Y_BYTES + kk * 2048, X_BOX), 1);
      wgmma_commit();
      // the previous stage's products are done: its stage is free
      wgmma_wait<1>();
      if (ks > 0) {
        if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
        __syncwarp();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    __syncwarp();
    store_dw_t(acc, out_s, dw, m0, n0, d, h, cw);
  }
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
    if (h == 0) return (int)cudaMemsetAsync(dx, 0, (size_t)L * d * 2, stream);
    CUtensorMap maps[5];
    const void* src[5] = {dy, a, b, w1, w2};
    for (int i = 0; i < 5; ++i) {
      const bool act = i < 3;   // (L, h) activations, else (d, h) weights
      if (!tensor_map_2d(&maps[i], src[i], act ? L : d, h, h,
                         act ? bwdx::BM : bwdx::BN, BK,
                         CU_TENSOR_MAP_SWIZZLE_64B))
        return (int)cudaErrorInvalidValue;
    }
    allow_smem(swiglu_bwd_x_wgmma, bwdx::SMEM);
    const int n_tiles = ((L + bwdx::BM - 1) / bwdx::BM) *
                        ((d + bwdx::BN - 1) / bwdx::BN);
    const int n_sm = sm_count();
    if (n_sm <= 0) return (int)cudaErrorInvalidDevice;
    swiglu_bwd_x_wgmma<<<n_tiles < n_sm ? n_tiles : n_sm, bwdx::THREADS,
                         bwdx::SMEM, stream>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], (bf16*)dx, L, d, h);
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
    if (L == 0) {
      const size_t n = (size_t)d * h * 2;
      cudaError_t err = cudaMemsetAsync(dw1, 0, n, stream);
      return (int)(err != cudaSuccess ? err
                                      : cudaMemsetAsync(dw2, 0, n, stream));
    }
    CUtensorMap maps[4];
    const void* src[4] = {x, dy, a, b};
    for (int i = 0; i < 4; ++i) {
      // (L, d) x, else (L, h) activations, in (BKL x 64) boxes
      const int cols = i == 0 ? d : h;
      if (!tensor_map_2d(&maps[i], src[i], L, cols, cols, bwdw::BKL, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
    }
    allow_smem(swiglu_bwd_w_wgmma, bwdw::SMEM);
    const int n_tiles = ((h + bwdw::BM - 1) / bwdw::BM) *
                        ((d + bwdw::BN - 1) / bwdw::BN);
    const int n_sm = sm_count();
    if (n_sm <= 0) return (int)cudaErrorInvalidDevice;
    swiglu_bwd_w_wgmma<<<n_tiles < n_sm ? n_tiles : n_sm, bwdw::THREADS,
                         bwdw::SMEM, stream>>>(
        maps[0], maps[1], maps[2], maps[3], (bf16*)dw1, (bf16*)dw2, L, d, h);
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
