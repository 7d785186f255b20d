// The Hopper GEMM kernels over per-expert slot rows that the fused MoE
// forward and backward (fused_moe_fwd.cu, fused_moe_bwd.cu), gather-GMM
// (gather_gmm.cu) and the grouped weight gradient (gmm_dw.cu) share.  All
// are persistent (one block per SM walks the tiles) and warp-specialized:
// a producer keeps a ring of shared memory full (mbarriers full / empty),
// two consumer warpgroups of 64 rows each run wgmma into float32
// accumulators.  In up and down a tile is 128 slot rows of one expert
// (fused_moe.cuh: find_row_tile), row tiles fastest, so the blocks at work
// share their weight tiles in L2; rows past the expert's end are computed
// and never stored, columns past the output's width are zero-filled by TMA
// and skipped, the tail of the contraction reads zeros.
//
//   up   (moe_up_wgmma)   y = round(silu(x w1) (x w2)) on 128 x 128 tiles
//        of (slot rows, columns h0 + [0, hw)): a producer warpgroup gathers
//        the x rows by 16-byte cp.async (eight lanes to a row's 128 bytes,
//        so a warp's copy touches 4 rows, not 32) and one thread brings w1
//        and w2 tiles by TMA; the consumers ldmatrix their x fragments into
//        wgmma's register-A layout and run m64n128k16 against w1 and w2
//        (MN-major in shared memory) into the a and b accumulators; the
//        epilogue stores y and, with SAVE_AB, round(a) and round(b).
//   down (moe_down_wgmma) acc = A w (+ A2 w2) on 128 x 256 tiles of
//        (slot rows, columns of n): rows of A (contiguous in slot order)
//        and weight tiles arrive by TMA; m64n256k16 from shared memory, the
//        weight MN-major (stored (E, K, n)) or with TRANS_B K-major (stored
//        (E, n, K), wgmma's own B layout); a second product (A2, w2), when
//        asked for, runs on in the same accumulator (the fused backward's
//        dx = da w1^T + db w2^T); the epilogue either adds g_slot[s] acc
//        (acc alone without gates) into row s of a float32 (S, n) per-slot
//        buffer (SCATTER: the fused forward and backward, whose callers sum
//        each token's slots in a fixed order afterwards with combine.cu)
//        or stores round(acc) into row s of a bf16 output
//        (gather-GMM).  A slot row belongs to one tile, and each of its
//        elements to one thread, so each element takes one float4
//        reduction a launch (fire and forget, done in L2) and the launches
//        add in stream order: one writer per element, the same bits every
//        call.  (A plain read and write in the epilogue instead made the
//        fused forward 47% slower at Mixtral's training shape: the
//        dependent loads stall the consumers.)
//   The rows of a bf16 output of up or down at or past offsets[E] belong
//   to no tile: the consumers of every block zero a share of them after
//   their last tile.
//   dw   (moe_dw_wgmma)   dw[e] = A[rows_e]^T B[rows_e], the grouped weight
//        gradient, on 128 x 256 tiles of one expert's output (with DUAL,
//        128 columns of each of two outputs that share A; with TRANS_OUT
//        stored transposed); the block walks the expert's whole row range,
//        so nothing is summed across blocks.  Both operands are
//        row-contiguous in slot order, so the contraction runs over rows
//        and both are wgmma's MN-major operands straight from the
//        128-byte-swizzled TMA boxes, 3 stages of 64 rows; a gathered A
//        (rows idx[s] of x or dy, the fused backward) and the last, partial
//        step of an expert are copied by cp.async into the same swizzled
//        layout, rows past the expert's end zero-filled in both operands.
//        The epilogue stages each warpgroup's tile in shared memory in the
//        output's box layout and one thread writes it with TMA stores that
//        run on under the next tile's products.
//
// Included by one source each, inside an anonymous namespace: every
// including source keeps its own copy of the kernels.

#pragma once

#include "fused_moe.cuh"
#include "hopper.cuh"

namespace {

using namespace repro::hopper;
using repro::fused::count_row_tiles;
using repro::fused::find_row_tile;
using repro::fused::sigmoidf;

// Zeroes rows [min(offsets[E], S), S) of up to three bf16 outputs (o1 and
// o2 both null or both set), columns [0, n) of rows ld apart (n and ld
// multiples of 8), 16 bytes a thread per step.  No tile owns these rows;
// thread t of `threads` in each block of the grid runs this after its
// last tile, so a call stays one launch.
__device__ __forceinline__ void zero_tail_rows(
    const int* __restrict__ offsets, int E, int S, int n, int ld,
    __nv_bfloat16* o0, __nv_bfloat16* o1, __nv_bfloat16* o2, int t,
    int threads) {
  const int total = min(max(offsets[E], 0), S);
  const int per_row = n / 8;
  const size_t count = (size_t)(S - total) * per_row;
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (size_t i = (size_t)blockIdx.x * threads + t; i < count;
       i += (size_t)gridDim.x * threads) {
    const size_t o = (total + i / per_row) * ld + (i % per_row) * 8;
    *reinterpret_cast<uint4*>(o0 + o) = z;
    if (o1 != nullptr) {
      *reinterpret_cast<uint4*>(o1 + o) = z;
      *reinterpret_cast<uint4*>(o2 + o) = z;
    }
  }
}

// ---------------------------------------------------------------------------
// up: (x rows, w1, w2) -> y = round(silu(a) b) [, round(a), round(b)]
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

// w1, w2: (E, d, h) maps of 64 x BK boxes.  Row s of the tile reads x row
// idx[s] (s itself when idx is null); ids outside [0, L) read zeros.  y
// (and a_out, b_out with SAVE_AB) have rows ldc apart; column c of the
// range [h0, h0 + hw) lands in column c - h0.  Rows at or past offsets[E]
// are zeroed in columns [0, hw).
template <bool SAVE_AB>
__global__ void __launch_bounds__(up::THREADS, 1)
moe_up_wgmma(const __grid_constant__ CUtensorMap tm_w1,
             const __grid_constant__ CUtensorMap tm_w2,
             const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
             const int* __restrict__ offsets, __nv_bfloat16* __restrict__ y,
             __nv_bfloat16* __restrict__ a_out,
             __nv_bfloat16* __restrict__ b_out, int S, int L, int d, int E,
             int h0, int hw, int ldc) {
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
        const int t = row < r1 ? (idx != nullptr ? idx[row] : row) : -1;
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
        const size_t o = (size_t)rr * ldc + col;
        *reinterpret_cast<uint32_t*>(y + o) =
            pack_bf16((a0 * sigmoidf(a0)) * b0, (a1 * sigmoidf(a1)) * b1);
        if (SAVE_AB) {
          *reinterpret_cast<uint32_t*>(a_out + o) = pack_bf16(a0, a1);
          *reinterpret_cast<uint32_t*>(b_out + o) = pack_bf16(b0, b1);
        }
      }
    }
  }
  zero_tail_rows(offsets, E, S, hw, ldc, y, SAVE_AB ? a_out : nullptr,
                 SAVE_AB ? b_out : nullptr, threadIdx.x - 128,
                 128 * CONSUMERS);
}

// ---------------------------------------------------------------------------
// down: (A rows, w) -> y[idx] += g (A w)  or  out = round(A w)
// ---------------------------------------------------------------------------

namespace down {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2, THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 2;         // A rows: one TMA box
constexpr int B_BOX = BK * 64 * 2;           // one 64-wide box of w
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
}  // namespace down

// tm_a: the (S, K') rows of A, (BM x 64) boxes; the contraction runs over
// its columns [0, K).  tm_w: (E, K', n) in 64 x BK boxes, or with TRANS_B
// (E, n, K') in BK x 256 boxes; the contraction runs over its rows (with
// TRANS_B its columns) [k_off, k_off + K).  With two != 0 the product of
// tm_a2 and tm_w2 (laid out as tm_a and tm_w) is added over the same
// ranges; otherwise they are not read.  SCATTER: out is the float32 (L, n)
// y, zeroed by the caller, and row s adds into y[idx[s]] with gate
// g_slot[s] (1 when g_slot is null); otherwise out is the bf16 (S, n)
// output, row s lands in row s and rows at or past offsets[E] are zeroed.
template <bool SCATTER, bool TRANS_B>
__global__ void __launch_bounds__(down::THREADS, 1)
moe_down_wgmma(const __grid_constant__ CUtensorMap tm_a,
               const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_a2,
               const __grid_constant__ CUtensorMap tm_w2,
               const int* __restrict__ idx, const float* __restrict__ g_slot,
               const int* __restrict__ offsets, void* __restrict__ out,
               int S, int L, int n, int E, int k_off, int K, int two) {
  using namespace down;
  extern __shared__ unsigned char smem[];
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;
  const uint32_t empty = full + STAGES * 8;

  const int n_rt = count_row_tiles(offsets, E, S, BM);
  const int n_tiles = n_rt * ((n + BN - 1) / BN);
  const int nk1 = (K + BK - 1) / BK;           // steps of one product
  const int nk = two ? 2 * nk1 : nk1;
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
          const bool second = ks >= nk1;
          const int k0 = (second ? ks - nk1 : ks) * BK;
          const CUtensorMap* ma = second ? &tm_a2 : &tm_a;
          const CUtensorMap* mw = second ? &tm_w2 : &tm_w;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(s0, ma, k0, r0, bar);
          if (TRANS_B) {
            tma_load(s0 + A_BYTES, mw, k_off + k0, n0, e, bar);
          } else {
#pragma unroll
            for (int q = 0; q < BN / 64; ++q)
              tma_load(s0 + A_BYTES + q * B_BOX, mw, n0 + q * 64,
                       k_off + k0, e, bar);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::);
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // The scatter's float4 reductions: lane pairs (2m, 2m+1) swap halves so
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
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t desc_w =
            TRANS_B ? desc_k_sw128(s0 + A_BYTES + kk * 32)
                    : desc_mn_sw128(s0 + A_BYTES + kk * 2048, B_BOX);
        wgmma_m64n256k16_ss<TRANS_B ? 0 : 1>(
            acc, desc_k_sw128(s0 + cw * 64 * 128 + kk * 32), desc_w,
            ks > 0 || kk > 0);
      }
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

    if (SCATTER) {
      float* ys = static_cast<float*>(out);
      const int s = r0 + cw * 64 + my_row;
      int t = s < r1 ? idx[s] : -1;
      if (t >= L) t = -1;
      const float g = t < 0 ? 0.f : g_slot != nullptr ? g_slot[s] : 1.f;
      float* yrow = ys + (size_t)(t < 0 ? 0 : s) * n + n0 + my_col;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        // even lanes send row 1's pair, odd lanes row 0's
        const float s0v = half ? acc[4 * j] : acc[4 * j + 2];
        const float s1v = half ? acc[4 * j + 1] : acc[4 * j + 3];
        const float q0 = __shfl_xor_sync(0xffffffffu, s0v, 1);
        const float q1 = __shfl_xor_sync(0xffffffffu, s1v, 1);
        const float4 v = half ? make_float4(q0, q1, acc[4 * j + 2],
                                            acc[4 * j + 3])
                              : make_float4(acc[4 * j], acc[4 * j + 1], q0,
                                            q1);
        if (t >= 0 && n0 + my_col + 8 * j < n)
          atomicAdd(reinterpret_cast<float4*>(yrow + 8 * j),
                    make_float4(g * v.x, g * v.y, g * v.z, g * v.w));
      }
    } else {
      // accumulator value 4 j + 2 i + e: row 16 warp + lane / 4 + 8 i,
      // column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 256 tile
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
      const int row = r0 + cw * 64 + warp * 16 + lane / 4;
      const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = col0 + 8 * j;
        if (col >= n) continue;                // n is a multiple of 8
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = row + 8 * i;
          if (rr < r1)
            *reinterpret_cast<uint32_t*>(o + (size_t)rr * n + col) =
                pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
    }
  }
  if (!SCATTER)
    zero_tail_rows(offsets, E, S, n, n, static_cast<__nv_bfloat16*>(out),
                   nullptr, nullptr, threadIdx.x - 128, 128 * CONSUMERS);
}

// ---------------------------------------------------------------------------
// dw: (A rows, B rows) -> dw[e] = A[rows_e]^T B[rows_e], the grouped weight
// gradient
// ---------------------------------------------------------------------------

namespace wgrad {
constexpr int BM = 128;                      // rows of dw: 64 a warpgroup
constexpr int BN = 256;                      // columns of dw (DUAL: 2 x 128)
constexpr int BK = 64, STAGES = 3;           // slot rows per stage
constexpr int CONSUMERS = 2, THREADS = 128 * (CONSUMERS + 1);
constexpr int BOX = BK * 64 * 2;             // one 64-wide box of BK rows
constexpr int A_BYTES = (BM / 64) * BOX;
constexpr int B_BYTES = (BN / 64) * BOX;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
static_assert(STAGE_BYTES % 1024 == 0, "stages keep the swizzle alignment");
static_assert(BM == 128 && BN == 256, "operands are copied as pairs of boxes");
// each consumer warpgroup's output staging for the TMA store: its 64 x 256
// tile in bf16, or one half of it in float32
constexpr int STG_BYTES = 32 * 1024;
constexpr int SMEM =
    STAGES * STAGE_BYTES + CONSUMERS * STG_BYTES + 1024 + 2 * STAGES * 8;
}  // namespace wgrad

// Copies BK rows of a bf16 operand into two 64-column boxes at dst in the
// layout a TMA box with the 128-byte swizzle gives: rows of 128 bytes,
// 16-byte piece p of row r at position p ^ (r % 8).  Row r is slot
// k0 + r; it reads source row idx[k0 + r] (k0 + r itself when idx is
// null) at columns col0 + 64 q + [0, 64) into box q.  Slots at or past hi,
// token ids outside [0, L) and columns at or past ncols read zeros.
// Thread t of the producer warpgroup copies piece t % 8 of rows
// t / 8 + 16 c (eight lanes read a row's 128 bytes).
__device__ __forceinline__ void load_rows_sw128(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, int ld, int col0,
    int ncols, const int* __restrict__ idx, int k0, int hi, int L, int t) {
  const int piece = t % 8;
#pragma unroll
  for (int c = 0; c < wgrad::BK / 16; ++c) {
    const int r = t / 8 + 16 * c;
    const int s = k0 + r;
    int row = s < hi ? (idx != nullptr ? idx[s] : s) : -1;
    if (idx != nullptr && row >= L) row = -1;
    const uint32_t at = dst + r * 128 + ((piece ^ (r & 7)) * 16);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = col0 + 64 * q + 8 * piece;
      const bool ok = row >= 0 && col < ncols;
      cp_async16_s(at + q * wgrad::BOX,
                   ok ? src + (size_t)row * ld + col : src, ok);
    }
  }
}

__device__ __forceinline__ void st_shared_pair(uint32_t at, float a,
                                               float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(a),
               "f"(b)
               : "memory");
}
__device__ __forceinline__ void st_shared_f32(uint32_t at, float a) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(at), "f"(a) : "memory");
}
__device__ __forceinline__ void st_shared_u32(uint32_t at, uint32_t a) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(a) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t at) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(at) : "memory");
  return v;
}

// Expert e owns slot rows [min(offsets[e], S), min(offsets[e+1], S)); its
// output is the M x N matrix e of the 3-D (E, M, N) tensor map tm_o0 (DUAL:
// and of tm_o1, N columns each; TRANS_OUT: the N x M matrix e of an
// (E, N, M) map).  The output maps have boxes of 128 bytes by 64 rows
// (TRANS_OUT: by 128 rows) with the 128-byte swizzle, of OutT.  A is (S, M)
// rows lda apart (a_src), B is (S, N) rows ldb apart (b0_src; DUAL: b1_src
// for out1).  tm_a, tm_b0, tm_b1 are the same matrices as 64 x BK TMA
// boxes with the 128-byte swizzle (tm_a is not read with GATHER; tm_b1 =
// tm_b0 and b1_src = b0_src without DUAL).  With GATHER, row s of A is row
// idx[s] of a_src (ids outside [0, L) read zeros).  Every output element
// is written once: tiles of an expert with no rows store zeros.  M and N
// are multiples of 8; the row strides give 16-byte aligned rows.
template <bool GATHER, bool DUAL, bool TRANS_OUT, typename OutT>
__global__ void __launch_bounds__(wgrad::THREADS, 1)
moe_dw_wgmma(const __grid_constant__ CUtensorMap tm_a,
             const __grid_constant__ CUtensorMap tm_b0,
             const __grid_constant__ CUtensorMap tm_b1,
             const __grid_constant__ CUtensorMap tm_o0,
             const __grid_constant__ CUtensorMap tm_o1,
             const __nv_bfloat16* __restrict__ a_src, int lda,
             const __nv_bfloat16* __restrict__ b0_src,
             const __nv_bfloat16* __restrict__ b1_src, int ldb,
             const int* __restrict__ idx, const int* __restrict__ offsets,
             int S, int L, int M, int N, int E) {
  using namespace wgrad;
  constexpr int BNO = DUAL ? BN / 2 : BN;      // columns of each output
  constexpr int EB = sizeof(OutT);
  constexpr int BOX_COLS = 128 / EB;           // output box: 128-byte rows
  constexpr int CH_COLS = STG_BYTES / (64 * EB);  // columns staged at once
  static_assert(!TRANS_OUT || (EB == 4 && !DUAL), "float32 transposes");
  extern __shared__ unsigned char smem[];
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t stage_out = ring + STAGES * STAGE_BYTES;
  const uint32_t full = stage_out + CONSUMERS * STG_BYTES;
  const uint32_t empty = full + STAGES * 8;

  const int n_mt = (M + BM - 1) / BM, n_nt = (N + BNO - 1) / BNO;
  const int per_e = n_mt * n_nt;
  const int n_tiles = per_e * E;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // 128 producer threads (cp.async) and thread 0's TMA or arrival
      mbar_init(full + 8 * s, 128 + 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // tile t: expert t / per_e; within an expert the tiles of the shorter
  // side of dw first, so the blocks at work read all of the smaller operand
  // (which stays in L2) and a few column blocks of the larger one, and
  // each column block of the larger is read once
  const bool m_fast = n_mt <= n_nt;
  auto locate = [&](int tile, int& e, int& m0, int& n0, int& lo, int& hi) {
    e = tile / per_e;
    const int r = tile % per_e;
    m0 = (m_fast ? r % n_mt : r / n_nt) * BM;
    n0 = (m_fast ? r / n_mt : r % n_nt) * BNO;
    lo = min(offsets[e], S);
    hi = max(lo, min(offsets[e + 1], S));
  };

  if (wg == 0) {
    // producer warpgroup: thread 0 brings the TMA boxes of whole steps;
    // every thread copies its share of a gathered A, and of both operands
    // in the last step of an expert whose rows end inside it
    const int t = threadIdx.x;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int e, m0, n0, lo, hi;
      locate(tile, e, m0, n0, lo, hi);
      const int nk = (hi - lo + BK - 1) / BK;
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
        const uint32_t s0 = ring + st * STAGE_BYTES;
        const uint32_t bar = full + 8 * st;
        const int k0 = lo + ks * BK;
        const bool part = k0 + BK > hi;
        const bool tma_a = !GATHER && !part;
        const bool tma_b = !part;
        if (t == 0) {
          const int tx = (tma_a ? A_BYTES : 0) + (tma_b ? B_BYTES : 0);
          if (tx > 0) {
            mbar_expect_tx(bar, tx);
            if (tma_a) {
#pragma unroll
              for (int q = 0; q < BM / 64; ++q)
                tma_load(s0 + q * BOX, &tm_a, m0 + 64 * q, k0, bar);
            }
            if (tma_b) {
#pragma unroll
              for (int q = 0; q < BN / 64; ++q) {
                const int half = q / 2;
                tma_load(s0 + A_BYTES + q * BOX, half ? &tm_b1 : &tm_b0,
                         n0 + (DUAL ? 0 : 128 * half) + 64 * (q % 2), k0,
                         bar);
              }
            }
          } else {
            mbar_arrive(bar);
          }
        }
        if (!tma_a)
          load_rows_sw128(s0, a_src, lda, m0, M, GATHER ? idx : nullptr,
                          k0, hi, L, t);
        if (!tma_b) {
          load_rows_sw128(s0 + A_BYTES, b0_src, ldb, n0, N, nullptr, k0, hi,
                          L, t);
          load_rows_sw128(s0 + A_BYTES + 2 * BOX, b1_src, ldb,
                          n0 + (DUAL ? 0 : 128), N, nullptr, k0, hi, L, t);
        }
        mbar_arrive_cp_async(bar);
      }
    }
    return;
  }

  const int cw = wg - 1;                       // consumer warpgroup
  const int wt = threadIdx.x % 128;            // thread in the warpgroup
  const int warp = wt / 32, lane = wt % 32;
  const uint32_t stg = stage_out + cw * STG_BYTES;
  float acc[128];
  int it = 0;
  bool stored = false;                         // a TMA store may read stg

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int e, m0, n0, lo, hi;
    locate(tile, e, m0, n0, lo, hi);
    const int nk = (hi - lo + BK - 1) / BK;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      // a stage filled by cp.async (generic proxy) is read by wgmma
      // (async proxy)
      fence_proxy_async();
      const uint32_t s0 = ring + st * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16_ss<1, 1>(
            acc, desc_mn_sw128(s0 + cw * BOX + kk * 2048, BOX),
            desc_mn_sw128(s0 + A_BYTES + kk * 2048, BOX), 1);
      wgmma_commit();
      // the previous step's products are done: its stage is free
      wgmma_wait<1>();
      if (ks > 0) {
        if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
        __syncwarp();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
    if (nk > 0) {
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      __syncwarp();
    }

    // Epilogue: the warpgroup's 64 x 256 accumulator goes, CH_COLS columns
    // at a time, into its staging tile in the output box layout, and one
    // thread writes it out with TMA stores that run on while the next
    // tile's products start.  Accumulator value 4 j + 2 i + e: row
    // 16 warp + lane / 4 + 8 i, column 8 j + 2 (lane % 4) + e.
    const int r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int ch = 0; ch < BN / CH_COLS; ++ch) {
      if (stored) {
        // the previous store has read the staging tile
        if (wt == 0) bulk_wait_read<0>();
        named_barrier(1 + cw, 128);
      }
#pragma unroll
      for (int jj = 0; jj < CH_COLS / 8; ++jj) {
        const int j = ch * (CH_COLS / 8) + jj;
        const int cc = 8 * jj + 2 * (lane % 4);  // column in the chunk
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 8 * i;
          const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
          if (TRANS_OUT) {
            // staging row cc (n), column r (m): boxes of BOX_COLS m
            const uint32_t box = stg + (r / BOX_COLS) * (CH_COLS * 128);
            const int byte = (r % BOX_COLS) * EB;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int n = cc + q;
              st_shared_f32(box + n * 128 + (((byte / 16) ^ (n & 7)) * 16) +
                                byte % 16,
                            q ? v1 : v0);
            }
          } else {
            const uint32_t box = stg + (cc / BOX_COLS) * (64 * 128);
            const int byte = (cc % BOX_COLS) * EB;
            const uint32_t at =
                box + r * 128 + (((byte / 16) ^ (r & 7)) * 16) + byte % 16;
            if (EB == 4)
              st_shared_pair(at, v0, v1);
            else
              st_shared_u32(at, pack_bf16(v0, v1));
          }
        }
      }
      fence_proxy_async();
      named_barrier(1 + cw, 128);
      if (wt == 0) {
        if (TRANS_OUT) {
#pragma unroll
          for (int b = 0; b < 64 / BOX_COLS; ++b)
            tma_store(&tm_o0, stg + b * (CH_COLS * 128),
                      m0 + 64 * cw + b * BOX_COLS, n0 + ch * CH_COLS, e);
        } else {
#pragma unroll
          for (int b = 0; b < CH_COLS / BOX_COLS; ++b) {
            const int a = ch * CH_COLS + b * BOX_COLS;  // accumulator column
            tma_store(DUAL && a >= BNO ? &tm_o1 : &tm_o0,
                      stg + b * (64 * 128), n0 + (DUAL ? a % BNO : a),
                      m0 + 64 * cw, e);
          }
        }
        bulk_commit();
      }
      stored = true;
    }
  }
  if (wt == 0) bulk_wait<0>();
}

}  // namespace
