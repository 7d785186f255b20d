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
// a fixed 32 MiB workspace), two launches per range:
//   up   (moe_up_wgmma)   tiles (128 slot rows of one expert, 128 columns
//        of the range): a producer warpgroup gathers the x rows by 16-byte
//        cp.async (eight lanes to a row's 128 bytes, so a warp's copy
//        touches 4 rows, not 32) and one thread brings w1 and w2 tiles by
//        TMA into a 4-stage ring (mbarriers full / empty); two consumer
//        warpgroups of 64 rows ldmatrix their x fragments into wgmma's
//        register-A layout and run m64n128k16 against w1 and w2 (MN-major
//        in shared memory) into the a and b accumulators; the epilogue
//        writes round(silu(a) b) into the chunk, the reference's rounding
//        point (gather_gmm.py:366-370);
//   down (moe_down_wgmma) tiles (128 slot rows of one expert, 256 columns
//        of d): chunk rows (contiguous in slot order) and w3[e][range, d
//        tile] arrive by TMA; m64n256k16 from shared memory; the epilogue
//        adds g_slot[s] acc into y[idx[s]] with float4 reductions
//        (neighbouring lanes swap a row's halves first).
// So y takes S d ceil(h / hc) reductions (2.3e8 at training, 32x fewer)
// and every other sum stays in registers.  On an H100 80GB HBM3 at
// 700 W the first version's reductions took about half of its 31 ms at
// training (PERF.md §6 has the profile and this design's times).  Both
// kernels are persistent (one block per SM walks the tiles, row tiles
// fastest, so the blocks at work share their weight tiles in L2) and
// mask every ragged edge: rows past an expert's end are computed and
// never stored, columns past the range or past d are zero-filled by TMA
// or skipped, the tail of the contraction reads zeros.  The order of the
// reductions varies from run to run (the tolerance against the plain
// version says so).
//
// Bound: operations (6 S d h; 2.9 TFLOP at S = 8192, d = 4096, h = 14336)
// in training and prefill, the bytes of the touched experts' weights at
// decode.  float32 inputs, and d or h not a multiple of 8 (or unaligned
// pointers), take a plain float32-FMA kernel: a block per (32-row tile,
// 32-wide h-chunk) reducing its partial into y (fwd_simt_kernel).

#include <algorithm>

#include "fused_moe.cuh"
#include "hopper.cuh"

namespace {

using namespace repro::hopper;
using repro::fused::load_rows;
using repro::fused::locate_tile;
using repro::fused::max_row_tiles;
using repro::fused::red_add;
using repro::fused::SBH;
using repro::fused::SBK;
using repro::fused::SBM;
using repro::fused::sigmoidf;
using bf16 = __nv_bfloat16;

// Row tiles of `bm` slot rows per expert, in expert order (as
// fused_moe.cuh:locate_tile): their count, and tile t's expert and rows
// (e = -1 past the last).
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

// ---------------------------------------------------------------------------
// up: (x rows, w1, w2) of one h-range -> chunk = round(silu(a) b)
// ---------------------------------------------------------------------------

namespace up {
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2, THREADS = 128 * (CONSUMERS + 1);
constexpr int LDX = BK + 8;                  // padded x rows (bf16)
constexpr int W_BOX = BK * 64 * 2;           // one 64-wide box of w1 or w2
constexpr int W_BYTES = BK * BN * 2;
constexpr int X_BYTES = BM * LDX * 2;
constexpr int STAGE_BYTES = 2 * W_BYTES + X_BYTES;   // w1, w2, x
static_assert(STAGE_BYTES % 1024 == 0, "stages keep the swizzle alignment");
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
}  // namespace up

__global__ void __launch_bounds__(up::THREADS, 1)
moe_up_wgmma(const __grid_constant__ CUtensorMap tm_w1,
             const __grid_constant__ CUtensorMap tm_w2,
             const bf16* __restrict__ x, const int* __restrict__ idx,
             const int* __restrict__ offsets, bf16* __restrict__ chunk,
             int S, int L, int d, int E, int h0, int hw, int ldc) {
  using namespace up;
  extern __shared__ unsigned char smem[];
  // the swizzle is a function of address bits: align the ring to 1024
  const uint32_t raw = smem_u32(smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_p = smem + (ring - raw);
  const uint32_t full = ring + STAGES * STAGE_BYTES;   // STAGES barriers
  const uint32_t empty = full + STAGES * 8;            // STAGES barriers

  const int n_rt = count_row_tiles(offsets, E, S, BM);
  const int n_tiles = n_rt * ((hw + BN - 1) / BN);
  const int nk = (d + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // 128 gathering threads (cp.async) and the TMA's expect_tx
      mbar_init(full + 8 * s, 128 + 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer warpgroup: lane l of warp w copies 16-byte piece l % 8 of
    // rows 4 w + l / 8 + 16 c, c = 0..7 (eight lanes read one row's 128
    // bytes, so a warp's copy touches 4 rows, not 32); thread 0 also
    // brings the weight tiles.  No register reallocation: the compiler
    // holds every thread to the launch's 168 registers, and the eight
    // tokens would spill under a producer's 40.
    const int r = threadIdx.x;
    const int prow = (r / 32) * 4 + (r % 32) / 8, piece = r % 8;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int e, r0, r1;
      find_row_tile(offsets, E, S, BM, tile % n_rt, e, r0, r1);
      const int n0 = h0 + (tile / n_rt) * BN;
      int tok[BM / 16];
#pragma unroll
      for (int c = 0; c < BM / 16; ++c) {
        const int row = r0 + prow + 16 * c;
        const int t = row < r1 ? idx[row] : -1;
        tok[c] = t >= L ? -1 : t;
      }
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
        const uint32_t s0 = ring + st * STAGE_BYTES;
        const uint32_t bar = full + 8 * st;
        const int k0 = ks * BK;
        if (r == 0) {
          mbar_expect_tx(bar, 2 * W_BYTES);
#pragma unroll
          for (int q = 0; q < BN / 64; ++q) {
            tma_load(s0 + q * W_BOX, &tm_w1, n0 + q * 64, k0, e, bar);
            tma_load(s0 + W_BYTES + q * W_BOX, &tm_w2, n0 + q * 64, k0, e,
                     bar);
          }
        }
        unsigned char* xs = ring_p + st * STAGE_BYTES + 2 * W_BYTES;
        const int kc = k0 + piece * 8;
#pragma unroll
        for (int c = 0; c < BM / 16; ++c) {
          const int t = tok[c];
          const bool ok = t >= 0 && kc < d;
          repro::cp_async16(xs + (prow + 16 * c) * LDX * 2 + piece * 16,
                            ok ? x + (size_t)t * d + kc : x, ok);
        }
        mbar_arrive_cp_async(bar);
      }
    }
    return;
  }

  const int cw = wg - 1;                       // consumer warpgroup
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // ldmatrix: lanes 0-7 / 8-15 / 16-23 / 24-31 address rows 0-7 / 8-15 /
  // 0-7 / 8-15 of the warp's 16 rows, at k 0-7 / 0-7 / 8-15 / 8-15.
  const int lrow = cw * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t x_off = 2 * W_BYTES + lrow * LDX * 2 + (lane >> 4) * 16;
  uint32_t fx[2][4] = {};                      // x fragments of two k-steps
  float acc_a[64], acc_b[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_a[i] = acc_b[i] = 0.f;
  int it = 0;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int e, r0, r1;
    find_row_tile(offsets, E, S, BM, tile % n_rt, e, r0, r1);
    const int c0 = (tile / n_rt) * BN;         // first column in the range
    if (r0 + cw * 64 >= r1) {
      // rows wholly past the tile (uniform in the warpgroup): no
      // products, but the ring's stages are released
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int st = it % STAGES;
        mbar_wait(full + 8 * st, (it / STAGES) & 1);
        if (lane == 0) mbar_arrive(empty + 8 * st);
        __syncwarp();
      }
      continue;
    }
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      const uint32_t s0 = ring + st * STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int f = kk & 1;
        ldmatrix_x4(fx[f], s0 + x_off + kk * 32);
        wgmma_fence();
        const int acc = ks > 0 || kk > 0;      // 0: overwrite
        wgmma_m64n128k16_rs<1>(acc_a, fx[f],
                               desc_mn_sw128(s0 + kk * 2048, W_BOX), acc);
        wgmma_m64n128k16_rs<1>(
            acc_b, fx[f], desc_mn_sw128(s0 + W_BYTES + kk * 2048, W_BOX),
            acc);
        wgmma_commit();
        // the previous k-step's products are done: its fragments may be
        // overwritten, and at a stage boundary its stage is free
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < 4; ++i) reg_fence(fx[f ^ 1][i]);
        if (kk == 0 && ks > 0) {
          if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
          __syncwarp();
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      reg_fence(acc_a[i]);
      reg_fence(acc_b[i]);
    }
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    __syncwarp();

    const int row = r0 + cw * 64 + warp * 16 + lane / 4;
    const int col0 = c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      if (col >= hw) continue;                 // hw is a multiple of 8
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = row + 8 * i;
        if (rr >= r1) continue;
        const float a0 = acc_a[4 * j + 2 * i], a1 = acc_a[4 * j + 2 * i + 1];
        const float b0 = acc_b[4 * j + 2 * i], b1 = acc_b[4 * j + 2 * i + 1];
        *reinterpret_cast<uint32_t*>(chunk + (size_t)rr * ldc + col) =
            pack_bf16((a0 * sigmoidf(a0)) * b0, (a1 * sigmoidf(a1)) * b1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// down: (chunk, w3[:, range, :]) -> y[idx] += g (chunk w3)
// ---------------------------------------------------------------------------

namespace down {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2, THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 2;         // chunk rows: one TMA box
constexpr int B_BOX = BK * 64 * 2;           // one 64-wide box of w3
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
}  // namespace down

__global__ void __launch_bounds__(down::THREADS, 1)
moe_down_wgmma(const __grid_constant__ CUtensorMap tm_chunk,
               const __grid_constant__ CUtensorMap tm_w3,
               const int* __restrict__ idx, const float* __restrict__ g_slot,
               const int* __restrict__ offsets, float* __restrict__ y, int S,
               int L, int d, int E, int h0, int hw) {
  using namespace down;
  extern __shared__ unsigned char smem[];
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;
  const uint32_t empty = full + STAGES * 8;

  const int n_rt = count_row_tiles(offsets, E, S, BM);
  const int n_tiles = n_rt * ((d + BN - 1) / BN);
  const int nk = (hw + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::);
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int e, r0, r1;
        find_row_tile(offsets, E, S, BM, tile % n_rt, e, r0, r1);
        const int n0 = (tile / n_rt) * BN;
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
          const uint32_t s0 = ring + st * STAGE_BYTES;
          const uint32_t bar = full + 8 * st;
          const int k0 = ks * BK;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(s0, &tm_chunk, k0, r0, bar);
#pragma unroll
          for (int q = 0; q < BN / 64; ++q)
            tma_load(s0 + A_BYTES + q * B_BOX, &tm_w3, n0 + q * 64, h0 + k0,
                     e, bar);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::);
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // The epilogue's float4 reductions: lane pairs (2m, 2m+1) swap halves so
  // that the even lane holds 4 neighbouring columns of accumulator row
  // i = 0 and the odd lane 4 of row i = 1.
  const int half = lane & 1;
  const int my_row = warp * 16 + lane / 4 + 8 * half;
  const int my_col = 4 * ((lane >> 1) & 1);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int e, r0, r1;
    find_row_tile(offsets, E, S, BM, tile % n_rt, e, r0, r1);
    const int n0 = (tile / n_rt) * BN;
    // A warpgroup whose rows all lie past the tile computes them anyway
    // and stores nothing: a branch around the products here makes the
    // compiler serialize every wgmma of the kernel.
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      const uint32_t s0 = ring + st * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16_ss<1>(
            acc, desc_k_sw128(s0 + cw * 64 * 128 + kk * 32),
            desc_mn_sw128(s0 + A_BYTES + kk * 2048, B_BOX),
            ks > 0 || kk > 0);
      wgmma_commit();
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

    const int s = r0 + cw * 64 + my_row;
    int t = s < r1 ? idx[s] : -1;
    if (t >= L) t = -1;
    const float g = t >= 0 ? g_slot[s] : 0.f;
    float* yrow = y + (size_t)(t < 0 ? 0 : t) * d + n0 + my_col;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      // even lanes send row 1's pair, odd lanes row 0's
      const float s0v = half ? acc[4 * j] : acc[4 * j + 2];
      const float s1v = half ? acc[4 * j + 1] : acc[4 * j + 3];
      const float q0 = __shfl_xor_sync(0xffffffffu, s0v, 1);
      const float q1 = __shfl_xor_sync(0xffffffffu, s1v, 1);
      const float4 v = half ? make_float4(q0, q1, acc[4 * j + 2],
                                          acc[4 * j + 3])
                            : make_float4(acc[4 * j], acc[4 * j + 1], q0, q1);
      if (t >= 0 && n0 + my_col + 8 * j < d)
        atomicAdd(reinterpret_cast<float4*>(yrow + 8 * j),
                  make_float4(g * v.x, g * v.y, g * v.z, g * v.w));
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
// zeroed by the caller; chunk: (S, hc) of x's dtype, hc a multiple of 128
// (the h-range width, kernels/fused_moe.py:pass_width), used by the bf16
// path only.  The bf16 path makes 2 ceil(h / hc) launches.
REPRO_API int repro_fused_moe_fwd(int dtype, const void* x,
                                  const float* g_slot, const int* idx,
                                  const int* offsets, const void* w1,
                                  const void* w2, const void* w3, float* y,
                                  void* chunk, int hc, int S, int L, int d,
                                  int h, int E, cudaStream_t stream) {
  if (E < 1 || d <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if (S <= 0 || L <= 0) return 0;
  if (dtype == REPRO_DTYPE_BF16 && d % 8 == 0 && h % 8 == 0 &&
      repro::aligned16(x) && repro::aligned16(w1) && repro::aligned16(w2) &&
      repro::aligned16(w3) && chunk != nullptr && repro::aligned16(chunk)) {
    if (hc <= 0 || hc % up::BN != 0) return (int)cudaErrorInvalidValue;
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
    allow_smem(moe_up_wgmma, up::SMEM);
    allow_smem(moe_down_wgmma, down::SMEM);
    const int row_tiles = max_row_tiles(S, E, up::BM);
    const int grid_b = std::min(row_tiles * ((d + down::BN - 1) / down::BN), n_sm);
    for (int h0 = 0; h0 < h; h0 += hc) {
      const int hw = std::min(hc, h - h0);
      CUtensorMap mc;
      if (!tensor_map_2d(&mc, chunk, S, hw, hc, down::BM, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
      const int grid_a = std::min(row_tiles * ((hw + up::BN - 1) / up::BN), n_sm);
      moe_up_wgmma<<<grid_a, up::THREADS, up::SMEM, stream>>>(
          m1, m2, (const bf16*)x, idx, offsets, (bf16*)chunk, S, L, d, E, h0,
          hw, hc);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      moe_down_wgmma<<<grid_b, down::THREADS, down::SMEM, stream>>>(
          mc, m3, idx, g_slot, offsets, y, S, L, d, E, h0, hw);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
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
