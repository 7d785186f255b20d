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
// All five outputs are float32.  Slots at or past offsets[E] get dgates 0
// and contribute nothing; experts with no rows get zero weight gradients.
//
// The TPU kernel zeroes dx at its first grid step, carries dx across the
// sequential h axis in scratch, accumulates dgates across a tile's items
// and the weight gradients across an expert's consecutive items, and
// scatters through one-hot matmuls: all of it relies on a grid that runs in
// order.  A Hopper grid has no order.  Here the bf16 call walks h in ranges
// of width hc (kernels/fused_moe.py:bwd_pass_width: the widest multiple of
// 128 whose three bf16 (S, hc) workspace chunks fit a fixed 64 MiB), as the
// forward does, and runs four kernels per range:
//   1. moe_bwd_up_wgmma (this file), tiles of 128 slot rows of one expert
//      by 128 columns of the range, on `up`'s tiling (moe_wgmma.cuh):
//      first dyu = dyt w3[e]^T over d, then the dual a, b product, both
//      with the gathered rows (16-byte cp.async copies into the layout of
//      a swizzled TMA box) and the weight tiles (TMA; the range's w3 rows
//      are wgmma's K-major B, so no copy) read by wgmma from shared
//      memory; dyu, rounded to bf16, waits in shared memory.  The float32
//      epilogue forms y_swi, da, db and g y_swi and writes them, each
//      rounded to bf16, into the three chunks (the tensor-core operands of
//      the next kernels; the plain version keeps da and db in float32,
//      which the tolerance covers), and the tile's share of dgates per row
//      into a float32 partial of its 128 columns;
//   2. moe_dw_wgmma<GATHER, DUAL> (moe_wgmma.cuh): dw1 and dw2 for the
//      range's columns from the gathered x rows against the da and db
//      chunks, one block per output tile walking the expert's rows;
//   3. moe_dw_wgmma<GATHER, TRANS_OUT>: dw3's rows of the range, as
//      dw3^T = dyt^T (g y_swi) from the gathered dy rows against the g y_swi
//      chunk, stored transposed, so that the gathered operand is the
//      128-wide A;
//   4. moe_down_wgmma<SCATTER, TRANS_B> (moe_wgmma.cuh) with two products:
//      dxs[s] += da w1[e][:, range]^T + db w2[e][:, range]^T into a float32
//      (S, d) per-slot buffer, w1 and w2 read K-major where they lie.
// and two last kernels: one sums each slot's dgates partials over the
// column tiles in a fixed order, one (combine.cu, float32, gates of 1)
// each token's rows of dxs into dx in a fixed order.  The ranges write disjoint
// column (dw1, dw2) or row (dw3) blocks, and a slot row of dxs belongs to
// one tile of each launch (one float4 reduction an element a launch, the
// launches in stream order), so every output element has one writer: a
// repeated call gives the same bits.  (Until the per-slot buffer, dx took
// float4 reductions from a token's k slots, whose order varied from run to
// run.)  A call is 4 ceil(h / hc) + 2 kernel launches (50 at Mixtral's
// training shape, 6 at decode).
//
// Measured on an H100 80GB HBM3 at 700 W at Mixtral's training shape
// (tools/fused_moe_ranges.py, tools/kernel_ab.py; PERF.md): dw3 from a
// gathered 256-wide B read 3.31 ms a call against 2.09 with the gathered
// operand as A and the output transposed; kernel 1 with its rows read
// from registers (ldmatrix, as `up`) read 7.06 ms against 5.97 from shared
// memory; a range width of 2048 (a 96 MiB workspace) read 17.06 ms against
// 17.40 for 1280 (60 MiB), 2% apart, so the workspace stays at 64 MiB.
//
// Bound: operations (16 S d h: 2 recomputed GEMMs, dyu, 3 weight
// gradients, 2 for dx; 7.7 TFLOP at S = 8192, d = 4096, h = 14336) in
// training, bytes at decode (the touched experts' weights read and the
// three float32 weight gradients written).  float32 inputs, and d or h
// not a multiple of 8 (or unaligned pointers), take the general path: the
// same h-ranges through three float32 (S, hc) chunks, in float32 FMA, with
// da and db kept in float32 as the reference keeps them.  Per range:
// bwd_simt_up writes da, db and g y_swi and each 32-column tile's dgates
// partial per slot; dw_simt (moe_wgmma.cuh, shared with gmm_dw.cu) gives
// each 64 x 64 tile of dw1, dw2 (the range's columns) and dw3 (its rows)
// to one block that walks the expert's slot rows in order and stores the
// tile once; bwd_simt_dx gives each (32 slot rows, 32 columns of d) tile
// of dx's per-slot buffer to one block that walks the whole range.  Then
// the same sum_dgates and combine: every output has one writer on both
// paths, so a repeated call gives the same bits.

#include <algorithm>

#include "fused_moe.cuh"
#include "hopper.cuh"
#include "moe_wgmma.cuh"

namespace {

using namespace repro::hopper;
using repro::fused::load_rows;
using repro::fused::locate_tile;
using repro::fused::max_row_tiles;
using repro::fused::round_bf16;
using repro::fused::SBH;
using repro::fused::SBK;
using repro::fused::SBM;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// 1. (x, dy rows, w1, w2, w3) -> da, db, g y_swi chunks and dgates partials
// ---------------------------------------------------------------------------

// 128 slot rows of one expert by 128 columns of the range per tile, up's
// (moe_wgmma.cuh) tiling and barrier scheme with both operands read by
// wgmma from shared memory: a stage holds two 64 x BK weight tiles and the
// tile's 128 gathered rows, 16-byte cp.async copies written in the layout
// of a 128-byte-swizzled TMA box (wgmma's K-major A, as `down` reads its
// rows); in the first phase the stage holds the range's w3 rows (BK x 128,
// K-major, in w1's place) and the dy rows.  w1, w2: (E, d, h) maps of
// 64 x BK boxes; w3: an (E, h, d) map of BK x 128 boxes.  Chunks da, db,
// yg have rows ldc apart; column c of the range [h0, h0 + hw) lands in
// column c - h0.  part: (ceil(h / 128), S) float32; row s of the
// 128-column tile of h starting at h0 + c0 gets sum over its columns of
// y_swi dyu.
namespace bup {
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2, THREADS = 128 * (CONSUMERS + 1);
constexpr int W_BOX = BK * 64 * 2;           // one 64-wide box of w1 or w2
constexpr int W_BYTES = BK * BN * 2;
constexpr int X_BYTES = BM * BK * 2;         // the gathered rows
constexpr int STAGE_BYTES = 2 * W_BYTES + X_BYTES;
static_assert(STAGE_BYTES % 1024 == 0, "stages keep the swizzle alignment");
// each consumer warpgroup's rounded dyu (64 rows x BN, bf16) until its
// epilogue
constexpr int U_BYTES = 64 * BN * 2;
constexpr int SMEM =
    STAGES * STAGE_BYTES + CONSUMERS * U_BYTES + 1024 + 2 * STAGES * 8;
}  // namespace bup

__global__ void __launch_bounds__(bup::THREADS, 1)
moe_bwd_up_wgmma(const __grid_constant__ CUtensorMap tm_w1,
                 const __grid_constant__ CUtensorMap tm_w2,
                 const __grid_constant__ CUtensorMap tm_w3,
                 const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 const float* __restrict__ g_slot,
                 const int* __restrict__ idx, const int* __restrict__ offsets,
                 bf16* __restrict__ da, bf16* __restrict__ db,
                 bf16* __restrict__ yg, float* __restrict__ part, int S,
                 int L, int d, int E, int h0, int hw, int ldc) {
  using namespace bup;
  extern __shared__ unsigned char smem[];
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t ubuf = ring + STAGES * STAGE_BYTES;
  const uint32_t full = ubuf + CONSUMERS * U_BYTES;
  const uint32_t empty = full + STAGES * 8;

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
    // producer warpgroup: thread t copies 16-byte piece t % 8 of rows
    // t / 8 + 16 c (eight lanes read a row's 128 bytes); thread 0 also
    // brings the weight tiles.  2 nk steps a tile: the dy rows and w3
    // first, then the x rows and w1, w2.
    const int t = threadIdx.x, piece = t % 8;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int e, r0, r1;
      find_row_tile(offsets, E, S, BM, tile % n_rt, e, r0, r1);
      const int n0 = h0 + (tile / n_rt) * BN;
      int tok[BM / 16];
#pragma unroll
      for (int c = 0; c < BM / 16; ++c) {
        const int row = r0 + t / 8 + 16 * c;
        const int id = row < r1 ? idx[row] : -1;
        tok[c] = id >= L ? -1 : id;
      }
      for (int step = 0; step < 2 * nk; ++step, ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
        const uint32_t s0 = ring + st * STAGE_BYTES;
        const uint32_t bar = full + 8 * st;
        const bool first = step < nk;
        const int k0 = (first ? step : step - nk) * BK;
        if (t == 0) {
          if (first) {
            mbar_expect_tx(bar, W_BYTES);
            tma_load(s0, &tm_w3, k0, n0, e, bar);
          } else {
            mbar_expect_tx(bar, 2 * W_BYTES);
#pragma unroll
            for (int q = 0; q < BN / 64; ++q) {
              tma_load(s0 + q * W_BOX, &tm_w1, n0 + q * 64, k0, e, bar);
              tma_load(s0 + W_BYTES + q * W_BOX, &tm_w2, n0 + q * 64, k0, e,
                       bar);
            }
          }
        }
        const bf16* src = first ? dy : x;
        const int kc = k0 + piece * 8;
#pragma unroll
        for (int c = 0; c < BM / 16; ++c) {
          const int r = t / 8 + 16 * c, id = tok[c];
          const bool ok = id >= 0 && kc < d;
          cp_async16_s(s0 + 2 * W_BYTES + r * 128 + ((piece ^ (r & 7)) * 16),
                       ok ? src + (size_t)id * d + kc : src, ok);
        }
        mbar_arrive_cp_async(bar);
      }
    }
    return;
  }

  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint32_t a_off = 2 * W_BYTES + cw * 64 * 128;  // this warpgroup's rows
  // this thread's pair of dyu columns 8 j + 2 (lane % 4) of its row
  // warp * 16 + lane / 4 + 8 i in the warpgroup's dyu buffer: rows of 256
  // bytes, 16-byte piece j at j ^ (row % 8), so a warp's stores and loads
  // fall in distinct banks
  auto u_at = [&](int i, int j) -> uint32_t {
    const int r = warp * 16 + lane / 4 + 8 * i;
    return ubuf + cw * U_BYTES + r * 256 + ((j ^ (r & 7)) * 16) +
           4 * (lane % 4);
  };
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
      for (int step = 0; step < 2 * nk; ++step, ++it) {
        const int st = it % STAGES;
        mbar_wait(full + 8 * st, (it / STAGES) & 1);
        if (lane == 0) mbar_arrive(empty + 8 * st);
        __syncwarp();
      }
      continue;
    }
    const int row = r0 + cw * 64 + warp * 16 + lane / 4;
    const int col0 = c0 + 2 * (lane % 4);

    // dyu = dyt w3^T into acc_a: w3's range rows are the K-major B
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      // the rows were copied by cp.async (generic proxy) and are read by
      // wgmma (async proxy)
      fence_proxy_async();
      const uint32_t s0 = ring + st * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n128k16_ss<0>(acc_a, desc_k_sw128(s0 + a_off + kk * 32),
                               desc_k_sw128(s0 + kk * 32), ks > 0 || kk > 0);
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
    for (int i = 0; i < 64; ++i) reg_fence(acc_a[i]);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    __syncwarp();
    // round(dyu) into shared memory until this thread's epilogue reads it
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        st_shared_u32(u_at(i, j), pack_bf16(acc_a[4 * j + 2 * i],
                                            acc_a[4 * j + 2 * i + 1]));

    // a = xt w1, b = xt w2
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      fence_proxy_async();
      const uint32_t s0 = ring + st * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t desc_x = desc_k_sw128(s0 + a_off + kk * 32);
        const int acc = ks > 0 || kk > 0;
        wgmma_m64n128k16_ss<1>(acc_a, desc_x,
                               desc_mn_sw128(s0 + kk * 2048, W_BOX), acc);
        wgmma_m64n128k16_ss<1>(
            acc_b, desc_x, desc_mn_sw128(s0 + W_BYTES + kk * 2048, W_BOX),
            acc);
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
    for (int i = 0; i < 64; ++i) {
      reg_fence(acc_a[i]);
      reg_fence(acc_b[i]);
    }
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    __syncwarp();

    // epilogue in float32: da = dyu g b silu'(a), db = dyu g silu(a),
    // g y_swi, each rounded once; y_swi dyu summed per row
    float g[2], dgp[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      g[i] = row + 8 * i < r1 ? g_slot[row + 8 * i] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      if (col >= hw) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = row + 8 * i;
        if (rr >= r1) continue;
        const size_t o = (size_t)rr * ldc + col;
        const uint32_t u2 = ld_shared_u32(u_at(i, j));
        const float u[2] = {__uint_as_float(u2 << 16),
                            __uint_as_float(u2 & 0xffff0000u)};
        float vda[2], vdb[2], vyg[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float av = acc_a[4 * j + 2 * i + q];
          const float bv = acc_b[4 * j + 2 * i + q];
          const float sg = repro::fused::sigmoidf(av);
          const float sa = av * sg;
          const float ys = round_bf16(sa * bv);
          dgp[i] += ys * u[q];
          const float dys = u[q] * g[i];
          vda[q] = dys * bv * (sg * (1.f + av * (1.f - sg)));
          vdb[q] = dys * sa;
          vyg[q] = ys * g[i];
        }
        *reinterpret_cast<uint32_t*>(da + o) = pack_bf16(vda[0], vda[1]);
        *reinterpret_cast<uint32_t*>(db + o) = pack_bf16(vdb[0], vdb[1]);
        *reinterpret_cast<uint32_t*>(yg + o) = pack_bf16(vyg[0], vyg[1]);
      }
    }
    // the four lanes of a row hold its 128 columns: a fixed tree
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dgp[i] += __shfl_xor_sync(0xffffffffu, dgp[i], 1);
      dgp[i] += __shfl_xor_sync(0xffffffffu, dgp[i], 2);
    }
    if (lane % 4 == 0) {
      float* p = part + (size_t)((h0 + c0) / BN) * S;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row + 8 * i < r1) p[row + 8 * i] = dgp[i];
    }
  }
}

// dg[s] = sum over the column tiles of part[ct][s], in order, for the slots
// of an expert ([min(offsets[0], S), min(offsets[E], S))); 0 elsewhere.
__global__ void sum_dgates(const float* __restrict__ part,
                           const int* __restrict__ offsets, int S, int E,
                           int n_ct, float* __restrict__ dg) {
  const int lo = min(max(offsets[0], 0), S);
  const int hi = min(max(offsets[E], lo), S);
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += gridDim.x * blockDim.x) {
    float v = 0.f;
    if (s >= lo && s < hi)
      for (int ct = 0; ct < n_ct; ++ct) v += part[(size_t)ct * S + s];
    dg[s] = v;
  }
}

// General path (float32, or widths the tensor-core path does not take):
// the same h-ranges through three float32 (S, hc) chunks
// (kernels/fused_moe.py:general_bwd_pass_width), in float32 FMA; da and db
// stay float32, as in the reference.  Each thread computes 2 x 2 outputs
// of a 32 x 32 tile (rows ty * 2.., columns tx * 2..).
//
// bwd_simt_up: tile (SBM slot rows of one expert, SBH columns of the
// range) -> a, b and dyu over all of d -> da, db and g y_swi into the
// chunks (rows ldc apart) and the row sums of y_swi dyu into part[ct][s],
// ct the tile's column tile of h (SBH wide).
template <typename T>
__global__ void __launch_bounds__(256)
bwd_simt_up(const T* __restrict__ x, const T* __restrict__ dy,
            const float* __restrict__ g_slot, const int* __restrict__ idx,
            const int* __restrict__ offsets, const T* __restrict__ w1,
            const T* __restrict__ w2, const T* __restrict__ w3,
            float* __restrict__ da, float* __restrict__ db,
            float* __restrict__ yg, int ldc, float* __restrict__ part,
            int S, int L, int d, int h, int E, int h0, int hw) {
  constexpr int P = SBH + 1;  // padded row of every 32 x 32 tile
  __shared__ float Xs[SBM][P], DYs[SBM][P];
  __shared__ float W1s[SBK][P], W2s[SBK][P], W3s[SBK][P];
  __shared__ int info[3];
  __shared__ int tok_s[SBM];
  __shared__ float g_s[SBM];
  locate_tile(offsets, E, S, SBM, info);
  const int e = info[0];
  if (e < 0) return;
  const int r0 = info[1], r1 = info[2];
  const int j0 = blockIdx.y * SBH;  // within the range
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  load_rows(idx, g_slot, r0, r1, L, SBM, tok_s, g_s);
  __syncthreads();
  const T* w1e = w1 + (size_t)e * d * h + h0;
  const T* w2e = w2 + (size_t)e * d * h + h0;
  const T* w3e = w3 + ((size_t)e * h + h0) * d;
  auto gather = [&](float (*dst)[P], const T* src, int k0) {
    for (int i = tid; i < SBM * SBK; i += 256) {
      const int r = i / SBK, kk = i % SBK;
      const int t = tok_s[r];
      dst[r][kk] = (t >= 0 && k0 + kk < d)
                       ? repro::to_f32(src[(size_t)t * d + k0 + kk]) : 0.f;
    }
  };

  float a[2][2] = {}, b[2][2] = {}, u[2][2] = {};
  for (int k0 = 0; k0 < d; k0 += SBK) {
    gather(Xs, x, k0);
    gather(DYs, dy, k0);
    for (int i = tid; i < SBK * SBH; i += 256) {
      const int kk = i / SBH, c = i % SBH;
      bool ok = k0 + kk < d && j0 + c < hw;
      const size_t off = (size_t)(k0 + kk) * h + j0 + c;
      W1s[kk][c] = ok ? repro::to_f32(w1e[off]) : 0.f;
      W2s[kk][c] = ok ? repro::to_f32(w2e[off]) : 0.f;
      // W3s[k][j] = w3[e][h0 + j0 + j][k0 + k]; consecutive threads walk k
      const int jr = i / SBK, kc = i % SBK;
      ok = j0 + jr < hw && k0 + kc < d;
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
  // elementwise terms into the chunks; y_swi * dyu per element into Xs
  // for the row sums (columns past the range are zero: their weights read
  // as zeros)
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
      Xs[r][c] = ys * uv;
      const int s = r0 + r;
      if (s < r1 && j0 + c < hw) {
        const size_t o = (size_t)s * ldc + j0 + c;
        da[o] = dys * bv * (sg * (1.f + av * (1.f - sg)));
        db[o] = dys * sa;
        yg[o] = ys * g;
      }
    }
  __syncthreads();
  if (tid < SBM && r0 + tid < r1) {
    float sum = 0.f;
    for (int c = 0; c < SBH; ++c) sum += Xs[tid][c];
    part[(size_t)((h0 + j0) / SBH) * S + r0 + tid] = sum;
  }
}

// bwd_simt_dx: tile (SBM slot rows of one expert, SBK columns of d) ->
// da w1[e][:, range]^T + db w2[e][:, range]^T summed over the whole range
// in registers, then added into the slot's row of the float32 per-slot
// buffer dxs: one block writes each element in a launch, and the ranges'
// launches add in stream order.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_simt_dx(const float* __restrict__ da, const float* __restrict__ db,
            int ldc, const int* __restrict__ offsets,
            const T* __restrict__ w1, const T* __restrict__ w2,
            float* __restrict__ dxs, int S, int d, int h, int E, int h0,
            int hw) {
  constexpr int P = SBH + 1;
  __shared__ float Das[SBM][P], Dbs[SBM][P];
  __shared__ float W1s[SBK][P], W2s[SBK][P];
  __shared__ int info[3];
  locate_tile(offsets, E, S, SBM, info);
  const int e = info[0];
  if (e < 0) return;
  const int r0 = info[1], r1 = info[2];
  const int n0 = blockIdx.y * SBK;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const T* w1e = w1 + (size_t)e * d * h + h0;
  const T* w2e = w2 + (size_t)e * d * h + h0;
  float acc[2][2] = {};
  for (int j0 = 0; j0 < hw; j0 += SBH) {
    for (int i = tid; i < SBM * SBH; i += 256) {
      const int r = i / SBH, c = i % SBH;
      const bool ok = r0 + r < r1 && j0 + c < hw;
      const size_t o = (size_t)(r0 + r) * ldc + j0 + c;
      Das[r][c] = ok ? da[o] : 0.f;
      Dbs[r][c] = ok ? db[o] : 0.f;
    }
    for (int i = tid; i < SBK * SBH; i += 256) {
      const int n = i / SBH, c = i % SBH;  // W1s[n][j] = w1[e][n0 + n][j]
      const bool ok = n0 + n < d && j0 + c < hw;
      const size_t o = (size_t)(n0 + n) * h + j0 + c;
      W1s[n][c] = ok ? repro::to_f32(w1e[o]) : 0.f;
      W2s[n][c] = ok ? repro::to_f32(w2e[o]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < SBH; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ri = ty * 2 + i, cj = tx * 2 + j;
          acc[i][j] = fmaf(Das[ri][q], W1s[cj][q],
                           fmaf(Dbs[ri][q], W2s[cj][q], acc[i][j]));
        }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = r0 + ty * 2 + i;
    if (s >= r1) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + tx * 2 + j;
      if (n < d) dxs[(size_t)s * d + n] += acc[i][j];
    }
  }
}

template <typename T>
int launch_simt(const void* x, const void* dy, const float* g_slot,
                const int* idx, const int* offsets, const void* w1,
                const void* w2, const void* w3, float* dw1, float* dw2,
                float* dw3, float* ws, float* part, int hc, int S, int L,
                int d, int h, int E, float* dxs, cudaStream_t stream) {
  float* da = ws;
  float* db = da + (size_t)S * hc;
  float* yg = db + (size_t)S * hc;
  const int row_tiles = max_row_tiles(S, E, SBM);
  const int d_tiles = (d + dws::BM - 1) / dws::BM;
  for (int h0 = 0; h0 < h; h0 += hc) {
    const int hw = std::min(hc, h - h0);
    bwd_simt_up<T><<<dim3(row_tiles, (hw + SBH - 1) / SBH), 256, 0,
                     stream>>>((const T*)x, (const T*)dy, g_slot, idx,
                               offsets, (const T*)w1, (const T*)w2,
                               (const T*)w3, da, db, yg, hc, part, S, L, d,
                               h, E, h0, hw);
    // dw1, dw2 (moe_wgmma.cuh's dw_simt): the range's columns, (d, hw)
    // blocks of rows h apart
    const dim3 g12(d_tiles, (hw + dws::BN - 1) / dws::BN, E);
    dw_simt<T, true, float, false, float><<<g12, 256, 0, stream>>>(
        (const T*)x, d, d, da, hc, hw, idx, offsets, S, L, dw1 + h0,
        (size_t)d * h, h);
    dw_simt<T, true, float, false, float><<<g12, 256, 0, stream>>>(
        (const T*)x, d, d, db, hc, hw, idx, offsets, S, L, dw2 + h0,
        (size_t)d * h, h);
    // dw3: the range's rows, an (hw, d) block
    dw_simt<float, false, T, true, float>
        <<<dim3((hw + dws::BM - 1) / dws::BM, d_tiles, E), 256, 0, stream>>>(
            yg, hc, hw, (const T*)dy, d, d, idx, offsets, S, L,
            dw3 + (size_t)h0 * d, (size_t)h * d, d);
    bwd_simt_dx<T><<<dim3(row_tiles, (d + SBK - 1) / SBK), 256, 0,
                     stream>>>(da, db, hc, offsets, (const T*)w1,
                               (const T*)w2, dxs, S, d, h, E, h0, hw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// x, dy: (L, d); g_slot: (S,) float32; idx: (S,) int32; offsets: (E+1,)
// int32; w1, w2: (E, d, h); w3: (E, h, d), all of x's dtype.  Outputs, all
// float32 and each written whole (zeros with no slots): dx (L, d), dg
// (S,), dw1, dw2 (E, d, h), dw3 (E, h, d).  tensor_cores: the path, which
// the caller chooses (kernels/fused_moe.py:tensor_core_path) and sizes the
// workspace for: 1 for the tensor-core path, refused unless x is bf16, d
// and h are multiples of 8 and x, dy and the weights are 16-byte aligned;
// 0 for the general path, which takes any input.  ws holds three (S, hc)
// chunks, hc a multiple of 128: bf16 on the tensor-core path
// (kernels/fused_moe.py:bwd_pass_width), float32 on the general path
// (general_bwd_pass_width); part is a float32 (ceil(h / 128), S) on the
// tensor-core path, (ceil(h / 32), S) on the general one; dxs a float32
// (S, d), zeroed by the caller; tim is the dispatch's (L, k)
// token_index_map, each token's slots in the order they are summed.
REPRO_API int repro_fused_moe_bwd(int dtype, int tensor_cores, const void* x,
                                  const void* dy,
                                  const float* g_slot, const int* idx,
                                  const int* offsets, const void* w1,
                                  const void* w2, const void* w3, float* dx,
                                  float* dg, float* dw1, float* dw2,
                                  float* dw3, void* ws, float* part, int hc,
                                  int S, int L, int d, int h, int E,
                                  float* dxs, const int* tim, int k,
                                  cudaStream_t stream) {
  if (E < 1 || d <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != REPRO_DTYPE_BF16 && dtype != REPRO_DTYPE_F32)
    return (int)cudaErrorInvalidValue;
  if (tensor_cores &&
      !(dtype == REPRO_DTYPE_BF16 && d % 8 == 0 && h % 8 == 0 &&
        repro::aligned16(x) && repro::aligned16(dy) &&
        repro::aligned16(w1) && repro::aligned16(w2) &&
        repro::aligned16(w3)))
    return (int)cudaErrorInvalidValue;
  if (S <= 0 || L <= 0) {
    // nothing to walk: every output is zero
    const size_t wbytes = (size_t)E * d * h * sizeof(float);
    const size_t sizes[5] = {(size_t)std::max(L, 0) * d * sizeof(float),
                             (size_t)std::max(S, 0) * sizeof(float), wbytes,
                             wbytes, wbytes};
    void* outs[5] = {dx, dg, dw1, dw2, dw3};
    for (int i = 0; i < 5; ++i) {
      if (sizes[i] == 0) continue;
      const cudaError_t err = cudaMemsetAsync(outs[i], 0, sizes[i], stream);
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  if (ws == nullptr || part == nullptr || !repro::aligned16(ws) ||
      hc <= 0 || hc % bup::BN != 0 || dxs == nullptr ||
      !repro::aligned16(dxs) || !repro::aligned16(dx) || tim == nullptr ||
      k <= 0)
    return (int)cudaErrorInvalidValue;
  int n_ct = (h + SBH - 1) / SBH;
  if (tensor_cores) {
    const int n_sm = sm_count();
    if (n_sm <= 0) return (int)cudaErrorInvalidDevice;
    // weights: w1, w2 (E, d, h) read MN-major by the first kernel and
    // K-major (TRANS_B) by dx; w3 (E, h, d) read K-major by the first
    CUtensorMap m1, m2, m3, m1t, m2t;
    const cuuint64_t dw_[3] = {(cuuint64_t)h, (cuuint64_t)d, (cuuint64_t)E};
    const cuuint64_t sw[2] = {(cuuint64_t)h * 2, (cuuint64_t)d * h * 2};
    const cuuint32_t bw[3] = {64, (cuuint32_t)bup::BK, 1};
    const cuuint32_t bt[3] = {(cuuint32_t)down::BK, (cuuint32_t)down::BN, 1};
    const cuuint64_t d3[3] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)E};
    const cuuint64_t s3[2] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2};
    const cuuint32_t b3[3] = {(cuuint32_t)bup::BK, (cuuint32_t)bup::BN, 1};
    const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
    if (!tensor_map(&m1, w1, 3, dw_, sw, bw, sw128) ||
        !tensor_map(&m2, w2, 3, dw_, sw, bw, sw128) ||
        !tensor_map(&m1t, w1, 3, dw_, sw, bt, sw128) ||
        !tensor_map(&m2t, w2, 3, dw_, sw, bt, sw128) ||
        !tensor_map(&m3, w3, 3, d3, s3, b3, sw128))
      return (int)cudaErrorInvalidValue;
    auto k_dw12 = moe_dw_wgmma<true, true, false, float>;
    auto k_dw3 = moe_dw_wgmma<true, false, true, float>;
    auto k_dx = moe_down_wgmma<true, true>;
    allow_smem(moe_bwd_up_wgmma, bup::SMEM);
    allow_smem(k_dw12, wgrad::SMEM);
    allow_smem(k_dw3, wgrad::SMEM);
    allow_smem(k_dx, down::SMEM);
    bf16* da = static_cast<bf16*>(ws);
    bf16* db = da + (size_t)S * hc;
    bf16* yg = db + (size_t)S * hc;
    const int row_tiles = max_row_tiles(S, E, bup::BM);
    const int grid_dx =
        std::min(row_tiles * ((d + down::BN - 1) / down::BN), n_sm);
    const int d_tiles = (d + wgrad::BM - 1) / wgrad::BM;
    for (int h0 = 0; h0 < h; h0 += hc) {
      const int hw = std::min(hc, h - h0);
      // the chunks as (S, hw) matrices, rows hc apart: 64 x 64 boxes for
      // the weight gradients, 64 x 128 for dx's A
      CUtensorMap mda, mdb, myg, mda_x, mdb_x;
      if (!tensor_map_2d(&mda, da, S, hw, hc, wgrad::BK, 64, sw128) ||
          !tensor_map_2d(&mdb, db, S, hw, hc, wgrad::BK, 64, sw128) ||
          !tensor_map_2d(&myg, yg, S, hw, hc, wgrad::BK, 64, sw128) ||
          !tensor_map_2d(&mda_x, da, S, hw, hc, down::BM, 64, sw128) ||
          !tensor_map_2d(&mdb_x, db, S, hw, hc, down::BM, 64, sw128))
        return (int)cudaErrorInvalidValue;
      const int grid_up =
          std::min(row_tiles * ((hw + bup::BN - 1) / bup::BN), n_sm);
      moe_bwd_up_wgmma<<<grid_up, bup::THREADS, bup::SMEM, stream>>>(
          m1, m2, m3, (const bf16*)x, (const bf16*)dy, g_slot, idx, offsets,
          da, db, yg, part, S, L, d, E, h0, hw, hc);
      // the range's outputs for the TMA stores, float32: dw1, dw2 as
      // (E, d, hw) matrices of rows h apart from column h0, in 32 x 64
      // boxes; dw3 as (E, hw, d) from row h0, in 32 x 128 boxes
      CUtensorMap mo1, mo2, mo3;
      const cuuint64_t d12[3] = {(cuuint64_t)hw, (cuuint64_t)d,
                                 (cuuint64_t)E};
      const cuuint64_t s12[2] = {(cuuint64_t)h * 4, (cuuint64_t)d * h * 4};
      const cuuint32_t b12[3] = {32, 64, 1};
      const cuuint64_t do3[3] = {(cuuint64_t)d, (cuuint64_t)hw,
                                 (cuuint64_t)E};
      const cuuint64_t so3[2] = {(cuuint64_t)d * 4, (cuuint64_t)h * d * 4};
      const cuuint32_t bo3[3] = {32, 128, 1};
      const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
      if (!tensor_map(&mo1, dw1 + h0, 3, d12, s12, b12, sw128, f32) ||
          !tensor_map(&mo2, dw2 + h0, 3, d12, s12, b12, sw128, f32) ||
          !tensor_map(&mo3, dw3 + (size_t)h0 * d, 3, do3, so3, bo3, sw128,
                      f32))
        return (int)cudaErrorInvalidValue;
      const int t12 = E * d_tiles * ((hw + 127) / 128);
      k_dw12<<<std::min(t12, n_sm), wgrad::THREADS, wgrad::SMEM, stream>>>(
          mda, mda, mdb, mo1, mo2, (const bf16*)x, d, da, db, hc, idx,
          offsets, S, L, d, hw, E);
      // dw3 as the transpose of (dy rows)^T (g y_swi)
      const int t3 = E * d_tiles * ((hw + wgrad::BN - 1) / wgrad::BN);
      k_dw3<<<std::min(t3, n_sm), wgrad::THREADS, wgrad::SMEM, stream>>>(
          myg, myg, myg, mo3, mo3, (const bf16*)dy, d, yg, yg, hc, idx,
          offsets, S, L, d, hw, E);
      k_dx<<<grid_dx, down::THREADS, down::SMEM, stream>>>(
          mda_x, m1t, mdb_x, m2t, idx, nullptr, offsets, dxs, S, L, d, E,
          h0, hw, 1);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    n_ct = (h + bup::BN - 1) / bup::BN;
  } else {
    const int err =
        dtype == REPRO_DTYPE_BF16
            ? launch_simt<bf16>(x, dy, g_slot, idx, offsets, w1, w2, w3, dw1,
                                dw2, dw3, (float*)ws, part, hc, S, L, d, h,
                                E, dxs, stream)
            : launch_simt<float>(x, dy, g_slot, idx, offsets, w1, w2, w3,
                                 dw1, dw2, dw3, (float*)ws, part, hc, S, L,
                                 d, h, E, dxs, stream);
    if (err != 0) return err;
  }
  const int n_sm = sm_count();
  if (n_sm <= 0) return (int)cudaErrorInvalidDevice;
  sum_dgates<<<std::min((S + 255) / 256, 4 * n_sm), 256, 0, stream>>>(
      part, offsets, S, E, n_ct, dg);
  const int err =
      repro_combine(REPRO_DTYPE_F32, dxs, tim, nullptr, dx, L, k, d, stream);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
