// Flash-attention forward (causal / sliding-window / softcap, GQA) for
// Hopper.
//
// Replaces repro/kernels/flash_attention.py:flash_attention_pallas
// (_kernel).  q: (B, S, H, Dh); k, v: (B, S, Hkv, Dh), H a multiple of Hkv;
// o: (B, S, H, Dh).  Query head h reads kv head h / (H / Hkv).  Scores are
// float32 and scaled by Dh^-0.5, soft-capped (cap * tanh(s / cap)) when
// cap > 0, and masked by key <= query (causal) and key > query - window
// (window > 0); the online softmax runs in float32, P is rounded to v's
// dtype for P V with float32 accumulation, and o = acc / max(l, 1e-30) in
// q's dtype.
//
// The TPU kernel runs a (batch * heads, q block, kv block) grid whose kv
// axis is sequential, carrying m, l and the accumulator in VMEM scratch,
// and repeats the kv heads across their query group in memory.  Here one
// block per (batch * head, 128-query tile) walks its kv tiles in a loop
// with m, l and the accumulator in registers, and reads the group's kv
// head in place: every tile arrives by TMA, cut from the (B, S, H, Dh)
// layout through its strides (4-D tensor maps; no copy, no transpose).
// kv tiles that the causal mask or the window rules out for the whole
// query tile are never loaded, and q tiles are issued longest first so the
// causal work balances across the SMs.
//
// Bound: operations (4 B S^2 H Dh / 2 for causal: 69 GFLOP, 0.07 ms, at
// B = 2, S = 2048, 32 heads of 128).  Two kernels; the wrapper
// (kernels/flash_attention.py:tensor_core_path) chooses, and the entry
// point refuses the tensor cores for inputs they cannot take.
//
// Tensor cores (flash_wgmma_kernel), for bf16 at any head width up to 128
// that is a multiple of 8, with 16-byte aligned tensors: a producer warp
// brings Q once and K, V tiles of 128 keys into a 3-stage ring, 128-byte
// swizzled, K and V on barriers of their own so Q K^T starts before V
// lands; two consumer warpgroups own 64 queries each (a producer warp, not
// a warpgroup: at 384 threads the compiler holds each thread to 168
// registers, too few for S, O and P, and serialized the wgmmas).  The
// kernel is built for a padded width DH, 64 (Dh <= 64) or 128 (Dh <= 128):
// the tensor maps carry the real Dh as their innermost extent, so the
// 64-column boxes read zeros past Dh (the transaction count stays the full
// box), which add nothing to Q K^T and give zero columns of P V that the
// epilogue does not store.  Q K^T issues only the k16 steps that hold real
// columns where an instantiation exists for it (5 at Dh 72-80; at HuBERT's
// shape all 8 read 9% slower on an H100 at 700 W, tools/kernel_ab.py);
// P V keeps the padded width (narrowing it to 64 of the 128 columns read
// no faster there).  S = Q K^T is one wgmma m64n128k16 chain from shared memory
// (both K-major); the softmax runs on the accumulator registers (a row's
// values sit in the quad of lanes that own it, so its max is two shuffles
// away, and its sum stays a per-lane partial until the end; exponentials
// are exp2 of scores scaled by log2(e)); the masks are applied only on
// tiles that straddle the diagonal, the window's edge or the end of the
// sequence, the softcap on every tile when cap > 0.  P is rounded to bf16
// in registers, where the score accumulator's layout is already wgmma's
// register-A layout, and O += P V is a register-A wgmma against V read
// MN-major from shared memory; O stays in registers until the end.
//
// General (flash_tiled_kernel), for float32 at any width (no TF32: float32
// is the port's exact mode) and bf16 that the tensor cores cannot take
// (Dh not a multiple of 8, Dh above 128, a pointer off 16 bytes): float32
// FMAs, bound by the card's float32 rate.  One block of four warps per
// (batch * head, 64-query tile) stages K and V tiles of 64 keys (32 past
// Dh 96) in shared memory as float32, shared by the tile's 64 queries, by
// 16-byte loads where the layout allows, up to 8 of a thread's in flight
// before their stores.  Each warp owns 16 queries and each lane 4 of them,
// with 8 (or 4) keys of a tile for Q K^T and one float4 of the output's
// columns in every 32 for P V, so every 16-byte shared read feeds 8 to 14
// FMAs.  P goes through a warp-private slice of shared memory between the
// two products.  The width is padded with zero columns to 32, 64, 96, 128,
// 192 or 256.

#include "hopper.cuh"

namespace {

using namespace repro::hopper;
using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ bool key_ok(int key, int qpos, int S, int causal,
                                       int window) {
  return key < S && (!causal || key <= qpos) &&
         (window <= 0 || key > qpos - window);
}

// A score in log2 units (exp(s - m) = 2^(s log2(e) - m log2(e))): the dot
// product times scale, soft-capped when cap > 0, times log2(e); sl2 is
// scale * log2(e).
__device__ __forceinline__ float score_log2(float dot, float scale, float sl2,
                                           float cap) {
  return cap > 0.f ? cap * tanhf(dot * scale / cap) * LOG2E : dot * sl2;
}

namespace fa {
constexpr int BQ = 128, BKV = 128, STAGES = 3;
// two consumer warpgroups and one producer warp: 288 threads leave each
// thread 224 registers (384 would leave 168, too few for the S and O
// accumulators and P, and the compiler would serialize the wgmmas)
constexpr int CONSUMERS = 2, THREADS = 128 * CONSUMERS + 32;
constexpr int BOX = 128 * 128;   // bytes of one (128 rows x 64 of Dh) box
template <int DH>
struct Smem {
  static constexpr int NC = DH / 64;          // boxes per row
  static constexpr int KV = NC * BOX;         // after Q
  static constexpr int STAGE = 2 * NC * BOX;  // K then V
  static constexpr int BARS = KV + STAGES * STAGE;
  // Q, the ring, barriers (Q's; per stage K full, V full, empty), and the
  // alignment
  static constexpr int BYTES = BARS + 8 * (1 + 3 * STAGES) + 1024;
};
}  // namespace fa

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// DH: the padded width (64 or 128); QK: the k16 steps of Q K^T, those that
// hold columns below the real width Dh.
template <int DH, int QK>
__global__ void __launch_bounds__(fa::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   bf16* __restrict__ o, int S, int H, int Hkv, int Dh,
                   int causal, int window, float cap, float scale) {
  static_assert(QK * 16 <= DH && QK * 16 > DH - 64, "QK steps within DH");
  using namespace fa;
  using L = Smem<DH>;
  constexpr int NC = L::NC;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t qbar = base + L::BARS;
  const uint32_t kfull = qbar + 8;               // STAGES barriers each
  const uint32_t vfull = kfull + 8 * STAGES;
  const uint32_t empty = vfull + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, hq = bh % H, hk = hq / (H / Hkv);
  const int n_q = (S + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * BQ;   // longest tiles first
  // kv tiles that hold a key some query of this tile may see
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? q_last + 1 : S;
  const int j_lo = kv_lo / BKV, j_hi = (kv_hi + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;   // CONSUMERS: the producer warp

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(vfull + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(qbar, NC * BOX);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load(base + c * BOX, &tm_q, c * 64, hq, q0, b, qbar);
      int it = 0;
      for (int j = j_lo; j < j_hi; ++j, ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
        const uint32_t s0 = base + L::KV + st * L::STAGE;
        mbar_expect_tx(kfull + 8 * st, NC * BOX);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(s0 + c * BOX, &tm_k, c * 64, hk, j * BKV, b,
                   kfull + 8 * st);
        mbar_expect_tx(vfull + 8 * st, NC * BOX);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(s0 + (NC + c) * BOX, &tm_v, c * 64, hk, j * BKV, b,
                   vfull + 8 * st);
      }
    }
    return;
  }

  const int cw = wg;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int qa = q0 + cw * 64;                   // the warpgroup's rows
  const int row0 = qa + warp * 16 + lane / 4;    // this lane's: row0 (+8)
  const bool live = qa < S;                      // uniform in the group
  const float sl2 = scale * LOG2E;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  int it = 0;
  for (int j = j_lo; j < j_hi; ++j, ++it) {
    const int st = it % STAGES, par = (it / STAGES) & 1;
    mbar_wait(kfull + 8 * st, par);
    const uint32_t s0 = base + L::KV + st * L::STAGE;
    if (live) {
      float s[64];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < QK; ++kc)
        wgmma_m64n128k16_ss<0>(
            s, desc_k_sw128(base + (kc / 4) * BOX + cw * 64 * 128 +
                            (kc % 4) * 32),
            desc_k_sw128(s0 + (kc / 4) * BOX + (kc % 4) * 32), kc > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int v = 0; v < 64; ++v) reg_fence(s[v]);

      const int k0 = j * BKV;
      const bool edge = (causal && k0 + BKV - 1 > qa) ||
                        (window > 0 && k0 <= qa + 63 - window) ||
                        k0 + BKV > S;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int v = 0; v < 64; ++v) {
        float x = score_log2(s[v], scale, sl2, cap);
        if (edge) {
          const int row = row0 + 8 * ((v >> 1) & 1);
          const int key = k0 + 8 * (v >> 2) + 2 * (lane % 4) + (v & 1);
          if (!key_ok(key, row, S, causal, window)) x = NEG_INF;
        }
        s[v] = x;
        mx[(v >> 1) & 1] = fmaxf(mx[(v >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        corr[i] = exp2_approx(m_run[i] - m_new);
        m_run[i] = m_new;
        l_run[i] *= corr[i];
      }
#pragma unroll
      for (int v = 0; v < 64; ++v) {
        const int i = (v >> 1) & 1;
        s[v] = exp2_approx(s[v] - m_run[i]);
        l_run[i] += s[v];
      }
#pragma unroll
      for (int v = 0; v < DH / 2; ++v) acc[v] *= corr[(v >> 1) & 1];
      // P in wgmma's register-A layout: k16 step t is accumulator columns
      // 16 t .. 16 t + 15, values 8 t .. 8 t + 7 of this lane
      uint32_t p[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          p[t][q] = pack_bf16(s[8 * t + 2 * q], s[8 * t + 2 * q + 1]);
      mbar_wait(vfull + 8 * st, par);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint64_t dv = desc_mn_sw128(s0 + NC * BOX + t * 2048, BOX);
        if constexpr (DH == 64)
          wgmma_m64n64k16_rs<1>(acc, p[t], dv, 1);
        else
          wgmma_m64n128k16_rs<1>(acc, p[t], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int v = 0; v < DH / 2; ++v) reg_fence(acc[v]);
    }
    if (lane == 0) mbar_arrive(empty + 8 * st);
    __syncwarp();
  }
  if (!live) return;

  // rows of the real width Dh; the columns past it (zeros) are not stored
  const size_t q_row = (size_t)H * Dh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = o + ((size_t)b * S + row) * q_row + (size_t)hq * Dh +
                 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj)
      if (8 * jj < Dh)
        *reinterpret_cast<uint32_t*>(orow + 8 * jj) = pack_bf16(
            acc[4 * jj + 2 * i] * inv, acc[4 * jj + 2 * i + 1] * inv);
  }
}

// General path: float32 FMAs over K and V tiles staged in shared memory.
namespace ft {
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int BQ = 64, QW = BQ / WARPS;   // 16 queries a warp, 4 a lane
constexpr int PS = QW + 4;                // P's row stride in floats (80 B)
// DHP: the width padded to a multiple of 32.  Q and K rows are DHP + 4
// floats apart, so 8 consecutive rows read 16 bytes each from 8 distinct
// bank groups.
template <int DHP>
struct Tile {
  static constexpr int BKV = DHP <= 96 ? 64 : 32;   // keys a tile
  static constexpr int NT = BKV / 8;                // keys a lane (Q K^T)
  static constexpr int NC = DHP / 32;               // float4 columns a lane
  static constexpr int KS = DHP + 4;
  static constexpr int K_OFF = BQ * KS;             // floats, after Q
  static constexpr int V_OFF = K_OFF + BKV * KS;
  static constexpr int P_OFF = V_OFF + BKV * DHP;
  static constexpr int BYTES = 4 * (P_OFF + WARPS * BKV * PS);
};
}  // namespace ft

__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Rows row0 .. row0 + ROWS - 1 of one head of a (B, S, heads, Dh) tensor
// (`src` at the head's element 0 of row 0, rows `rs` elements apart) into
// shared memory as float32, `ld` floats a row; the columns Dh .. DHP - 1
// and the rows past S are zeros.  vec: 16-byte loads (Dh * sizeof(T) a
// multiple of 16, src 16-byte aligned).
template <typename T, int DHP, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           size_t rs, int row0, int S,
                                           int Dh, bool vec) {
  if (vec) {
    // up to 8 loads of the thread in flight before their stores
    constexpr int V = 16 / sizeof(T), G = DHP / V;
    constexpr int N = ROWS * G / ft::THREADS;
    constexpr int NB = N <= 8 ? N : N % 8 == 0 ? 8 : N % 6 == 0 ? 6 : 4;
    static_assert(N * ft::THREADS == ROWS * G && N % NB == 0,
                  "whole 16-byte loads");
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += NB) {
      uint4 u[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int i = threadIdx.x + (n0 + n) * ft::THREADS;
        const int r = i / G, c = (i % G) * V, row = row0 + r;
        u[n] = row < S && c < Dh
                   ? __ldg(reinterpret_cast<const uint4*>(
                         src + (size_t)row * rs + c))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int i = threadIdx.x + (n0 + n) * ft::THREADS;
        const int r = i / G, c = (i % G) * V;
        float f[V];
        unpack16(u[n], f);
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(dst + r * ld + c + e) =
              make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DHP; i += ft::THREADS) {
      const int r = i / DHP, c = i % DHP, row = row0 + r;
      dst[r * ld + c] =
          row < S && c < Dh ? repro::to_f32(src[(size_t)row * rs + c]) : 0.f;
    }
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(ft::THREADS)
flash_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int S, int H,
                   int Hkv, int Dh, int causal, int window, float cap,
                   float scale, int vec) {
  using namespace ft;
  using L = Tile<DHP>;
  constexpr int BKV = L::BKV, NT = L::NT, NC = L::NC, KS = L::KS;
  extern __shared__ float4 smem_f4[];
  float* const qs = reinterpret_cast<float*>(smem_f4);
  float* const ks = qs + L::K_OFF;
  float* const vs = qs + L::V_OFF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // lane = 8 qi + kj: queries 4 qi .. 4 qi + 3 of the warp's 16; keys
  // kj + 8 t of a tile in Q K^T, column groups 4 kj + 32 c in P V
  const int qi = lane / 8, kj = lane % 8;
  float* const ps = qs + L::P_OFF + warp * BKV * PS;   // (BKV keys, 16 q)

  const int bh = blockIdx.x;
  const int b = bh / H, hq = bh % H, hk = hq / (H / Hkv);
  const int n_q = (S + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * BQ;   // longest tiles first
  // kv tiles that hold a key some query of this tile may see
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? q_last + 1 : S;
  const int j_lo = kv_lo / BKV, j_hi = (kv_hi + BKV - 1) / BKV;
  const size_t q_rs = (size_t)H * Dh, kv_rs = (size_t)Hkv * Dh;
  const T* kb = k + (size_t)b * S * kv_rs + (size_t)hk * Dh;
  const T* vb = v + (size_t)b * S * kv_rs + (size_t)hk * Dh;
  stage_rows<T, DHP, BQ>(qs, KS, q + (size_t)b * S * q_rs + (size_t)hq * Dh,
                         q_rs, q0, S, Dh, vec);

  const int qa = q0 + warp * QW;     // the warp's first query
  const int qr = qa + 4 * qi;        // this lane's: qr .. qr + 3
  const float* qrow = qs + (warp * QW + 4 * qi) * KS;
  const float sl2 = scale * LOG2E;
  float acc[4][4 * NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[r][c] = 0.f;
  // the running max (log2 units) of each row, and the lane's part of its sum
  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m_run[r] = NEG_INF, l_run[r] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * BKV;
    __syncthreads();   // every warp is done with the last tile
    stage_rows<T, DHP, BKV>(ks, KS, kb, kv_rs, k0, S, Dh, vec);
    stage_rows<T, DHP, BKV>(vs, DHP, vb, kv_rs, k0, S, Dh, vec);
    __syncthreads();
    // no (query, key) pair of the warp's rows in this tile is live
    if (qa >= S || (causal && k0 > qa + QW - 1) ||
        (window > 0 && k0 + BKV - 1 <= qa - window))
      continue;

    float s[4][NT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int t = 0; t < NT; ++t) s[r][t] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DHP; d += 4) {
      float4 kf[NT], qf[4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
        kf[t] = *reinterpret_cast<const float4*>(ks + (kj + 8 * t) * KS + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qf[r] = *reinterpret_cast<const float4*>(qrow + r * KS + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          s[r][t] = fmaf(qf[r].x, kf[t].x, s[r][t]);
          s[r][t] = fmaf(qf[r].y, kf[t].y, s[r][t]);
          s[r][t] = fmaf(qf[r].z, kf[t].z, s[r][t]);
          s[r][t] = fmaf(qf[r].w, kf[t].w, s[r][t]);
        }
    }

    // masks only where the tile straddles the diagonal, the window's edge
    // or the end of the sequence for some row of the warp
    const bool edge = (causal && k0 + BKV - 1 > qa) ||
                      (window > 0 && k0 <= qa + QW - 1 - window) ||
                      k0 + BKV > S;
    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float x = score_log2(s[r][t], scale, sl2, cap);
        if (edge && !key_ok(k0 + kj + 8 * t, qr + r, S, causal, window))
          x = NEG_INF;
        s[r][t] = x;
        mx = fmaxf(mx, x);
      }
      // a row's keys sit in the 8 lanes of its query group
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[r], mx);
      corr[r] = exp2_approx(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float p = exp2_approx(s[r][t] - m_new);
        l_run[r] += p;
        s[r][t] = repro::to_f32(repro::from_f32<T>(p));   // P in v's dtype
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[r][c] *= corr[r];
#pragma unroll
    for (int t = 0; t < NT; ++t)
      *reinterpret_cast<float4*>(ps + (kj + 8 * t) * PS + 4 * qi) =
          make_float4(s[0][t], s[1][t], s[2][t], s[3][t]);
    __syncwarp();

    // O += P V over the tile's keys (V's rows past S are zeros)
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + kk * PS +
                                                         4 * qi);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vf = *reinterpret_cast<const float4*>(
            vs + kk * DHP + 32 * c + 4 * kj);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][4 * c] = fmaf(pr[r], vf.x, acc[r][4 * c]);
          acc[r][4 * c + 1] = fmaf(pr[r], vf.y, acc[r][4 * c + 1]);
          acc[r][4 * c + 2] = fmaf(pr[r], vf.z, acc[r][4 * c + 2]);
          acc[r][4 * c + 3] = fmaf(pr[r], vf.w, acc[r][4 * c + 3]);
        }
      }
    }
  }
  if (qa >= S) return;

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = qr + r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + ((size_t)b * S + row) * q_rs + (size_t)hq * Dh;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * c + 4 * kj + e;
        if (col < Dh) orow[col] = repro::from_f32<T>(acc[r][4 * c + e] * inv);
      }
  }
}

template <int DH, int QK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int B, int S, int H, int Hkv, int Dh, int causal, int window,
                 float cap, float scale, cudaStream_t stream) {
  // (Dh, heads, S, B) with the layout's strides; boxes of 64 x 1 x 128 x 1,
  // zeros past Dh
  CUtensorMap mq, mk, mv;
  const cuuint64_t dq[4] = {(cuuint64_t)Dh, (cuuint64_t)H, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint64_t sq[3] = {(cuuint64_t)Dh * 2, (cuuint64_t)H * Dh * 2,
                            (cuuint64_t)S * H * Dh * 2};
  const cuuint64_t dk[4] = {(cuuint64_t)Dh, (cuuint64_t)Hkv, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint64_t sk[3] = {(cuuint64_t)Dh * 2, (cuuint64_t)Hkv * Dh * 2,
                            (cuuint64_t)S * Hkv * Dh * 2};
  const cuuint32_t box[4] = {64, 1, fa::BQ, 1};
  static_assert(fa::BQ == fa::BKV, "one box shape for q, k and v");
  if (!tensor_map(&mq, q, 4, dq, sq, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&mk, k, 4, dk, sk, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&mv, v, 4, dk, sk, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = fa::Smem<DH>::BYTES;
  allow_smem(flash_wgmma_kernel<DH, QK>, smem);
  const dim3 grid(B * H, (S + fa::BQ - 1) / fa::BQ);
  flash_wgmma_kernel<DH, QK><<<grid, fa::THREADS, smem, stream>>>(
      mq, mk, mv, (bf16*)o, S, H, Hkv, Dh, causal, window, cap, scale);
  return 0;
}

template <typename T, int DHP>
void launch_tiled(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int Hkv, int Dh, int causal,
                  int window, float cap, float scale, bool vec,
                  cudaStream_t stream) {
  constexpr int smem = ft::Tile<DHP>::BYTES;
  allow_smem(flash_tiled_kernel<T, DHP>, smem);
  const dim3 grid(B * H, (S + ft::BQ - 1) / ft::BQ);
  flash_tiled_kernel<T, DHP><<<grid, ft::THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, Hkv, Dh, causal,
      window, cap, scale, (int)vec);
}

template <typename T>
void launch_general(const void* q, const void* k, const void* v, void* o,
                    int B, int S, int H, int Hkv, int Dh, int causal,
                    int window, float cap, float scale, bool aligned,
                    cudaStream_t stream) {
  const bool vec = aligned && (Dh * (int)sizeof(T)) % 16 == 0;
#define REPRO_FLASH_TILED(DHP)                                            \
  launch_tiled<T, DHP>(q, k, v, o, B, S, H, Hkv, Dh, causal, window, cap, \
                       scale, vec, stream)
  if (Dh <= 32) REPRO_FLASH_TILED(32);
  else if (Dh <= 64) REPRO_FLASH_TILED(64);
  else if (Dh <= 96) REPRO_FLASH_TILED(96);
  else if (Dh <= 128) REPRO_FLASH_TILED(128);
  else if (Dh <= 192) REPRO_FLASH_TILED(192);
  else REPRO_FLASH_TILED(256);
#undef REPRO_FLASH_TILED
}

}  // namespace

constexpr int MAX_DH = 256;

// q, o: (B, S, H, Dh); k, v: (B, S, Hkv, Dh); one dtype; H % Hkv == 0.
// tensor_cores: 1 runs flash_wgmma_kernel (refused unless bf16, Dh a
// multiple of 8 up to 128 and every pointer 16-byte aligned), 0 the
// general kernel (any dtype code, Dh up to 256).
REPRO_API int repro_flash_attention(int dtype, int tensor_cores,
                                    const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int Hkv, int Dh, int causal,
                                    int window, float cap, float scale,
                                    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || Dh <= 0 ||
      Dh > MAX_DH)
    return (int)cudaErrorInvalidValue;
  const bool aligned = repro::aligned16(q) && repro::aligned16(k) &&
                       repro::aligned16(v) && repro::aligned16(o);
  int code = 0;
  if (tensor_cores) {
    if (dtype != REPRO_DTYPE_BF16 || Dh % 8 != 0 || Dh > 128 || !aligned)
      return (int)cudaErrorInvalidValue;
    // Dh 72-80 (HuBERT's 80): 5 k16 steps of Q K^T instead of 8
    code = Dh <= 64   ? launch_wgmma<64, 4>(q, k, v, o, B, S, H, Hkv, Dh,
                                            causal, window, cap, scale,
                                            stream)
           : Dh <= 80 ? launch_wgmma<128, 5>(q, k, v, o, B, S, H, Hkv, Dh,
                                             causal, window, cap, scale,
                                             stream)
                      : launch_wgmma<128, 8>(q, k, v, o, B, S, H, Hkv, Dh,
                                             causal, window, cap, scale,
                                             stream);
  } else if (dtype == REPRO_DTYPE_BF16) {
    launch_general<bf16>(q, k, v, o, B, S, H, Hkv, Dh, causal, window, cap,
                         scale, aligned, stream);
  } else if (dtype == REPRO_DTYPE_F32) {
    launch_general<float>(q, k, v, o, B, S, H, Hkv, Dh, causal, window, cap,
                          scale, aligned, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (code != 0) return code;
  return (int)cudaGetLastError();
}
