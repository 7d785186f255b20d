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
// B = 2, S = 2048, 32 heads of 128).  Design, for bf16 and Dh in {64, 128}
// (flash_wgmma_kernel): a producer warp brings Q once and K, V tiles of 128
// keys into a 3-stage ring, 128-byte swizzled, K and V on barriers of
// their own so Q K^T starts before V lands; two consumer warpgroups own 64
// queries each (a producer warp, not a warpgroup: at 384 threads the
// compiler holds each thread to 168 registers, too few for S, O and P, and
// serialized the wgmmas).  S = Q K^T is one wgmma
// m64n128k16 chain from shared memory (both K-major); the softmax runs on
// the accumulator registers (a row's values sit in the quad of lanes that
// own it, so its max is two shuffles away, and its sum stays a per-lane
// partial until the end; exponentials are exp2 of scores scaled by
// log2(e)); the masks are applied only on tiles that straddle the
// diagonal, the window's edge or the end of the sequence, the softcap on
// every tile when cap > 0.  P is rounded to
// bf16 in registers, where the score accumulator's layout is already
// wgmma's register-A layout, and O += P V is a register-A wgmma against V
// read MN-major from shared memory; O stays in registers until the end.
// float32 inputs and other head widths take a plain kernel: one warp per
// query row, lanes over keys for the scores and over Dh for P V
// (flash_simt_kernel).

#include "hopper.cuh"

namespace {

using namespace repro::hopper;
using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4, THREADS = WARPS * 32;   // the plain kernel

__device__ __forceinline__ bool key_ok(int key, int qpos, int S, int causal,
                                       int window) {
  return key < S && (!causal || key <= qpos) &&
         (window <= 0 || key > qpos - window);
}

__device__ __forceinline__ float score(float dot, float scale, float cap) {
  const float s = dot * scale;
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

namespace fa {
constexpr int BQ = 128, BKV = 128, STAGES = 3;
// two consumer warpgroups and one producer warp: 288 threads leave each
// thread 224 registers (384 would leave 168, too few for the S and O
// accumulators and P, and the compiler would serialize the wgmmas)
constexpr int CONSUMERS = 2, THREADS = 128 * CONSUMERS + 32;
constexpr int BOX = 128 * 128;   // bytes of one (128 rows x 64 of Dh) box
constexpr float LOG2E = 1.4426950408889634f;
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

template <int DH>
__global__ void __launch_bounds__(fa::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   bf16* __restrict__ o, int S, int H, int Hkv, int causal,
                   int window, float cap, float scale) {
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
  // scores in log2 units: exp(s - m) = 2^(s log2(e) - m log2(e))
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
      for (int kc = 0; kc < DH / 16; ++kc)
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
        float x = cap > 0.f ? cap * tanhf(s[v] * scale / cap) * LOG2E
                            : s[v] * sl2;
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

  const size_t q_row = (size_t)H * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = o + ((size_t)b * S + row) * q_row + (size_t)hq * DH +
                 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj)
      *reinterpret_cast<uint32_t*>(orow + 8 * jj) =
          pack_bf16(acc[4 * jj + 2 * i] * inv, acc[4 * jj + 2 * i + 1] * inv);
  }
}

// General path: one warp per query row.  Lanes take 32 keys at a time for
// the scores, then Dh / 32 output columns each for P V.
constexpr int MAX_DH = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S, int H,
                  int Hkv, int Dh, int causal, int window, float cap,
                  float scale) {
  __shared__ float qsh[WARPS][MAX_DH];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int qpos = blockIdx.x * WARPS + warp;
  if (qpos >= S) return;  // no block-wide barrier below
  const int bh = blockIdx.y;
  const int b = bh / H, hq = bh % H, hk = hq / (H / Hkv);
  const size_t q_row = (size_t)H * Dh, kv_row = (size_t)Hkv * Dh;
  const T* qr = q + ((size_t)b * S + qpos) * q_row + (size_t)hq * Dh;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)hk * Dh;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)hk * Dh;
  for (int t = lane; t < Dh; t += 32) qsh[warp][t] = repro::to_f32(qr[t]);
  __syncwarp();

  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int hi = causal ? qpos + 1 : S;
  float m_run = NEG_INF, l_run = 0.f;
  float acc[MAX_DH / 32];
#pragma unroll
  for (int t = 0; t < MAX_DH / 32; ++t) acc[t] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += 32) {
    const int key = k0 + lane;
    float s = NEG_INF;
    if (key < hi && key_ok(key, qpos, S, causal, window)) {
      const T* kr = kb + (size_t)key * kv_row;
      float dot = 0.f;
      for (int t = 0; t < Dh; ++t) dot = fmaf(qsh[warp][t], repro::to_f32(kr[t]), dot);
      s = score(dot, scale, cap);
    }
    const float m_new = fmaxf(m_run, repro::warp_max(s));
    // keys past the range add nothing (they are masked for every query)
    const float p = key < hi ? expf(s - m_new) : 0.f;
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + repro::warp_sum(p);
    m_run = m_new;
    const float pr = repro::to_f32(repro::from_f32<T>(p));  // P in v's dtype
#pragma unroll
    for (int t = 0; t < MAX_DH / 32; ++t) acc[t] *= corr;
    const int n = min(32, hi - k0);
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, pr, jj);
      const T* vr = vb + (size_t)(k0 + jj) * kv_row;
#pragma unroll
      for (int t = 0; t < MAX_DH / 32; ++t) {
        const int col = lane + 32 * t;
        if (col < Dh) acc[t] = fmaf(pj, repro::to_f32(vr[col]), acc[t]);
      }
    }
  }
  const float inv = 1.f / fmaxf(l_run, 1e-30f);
  T* orow = o + ((size_t)b * S + qpos) * q_row + (size_t)hq * Dh;
#pragma unroll
  for (int t = 0; t < MAX_DH / 32; ++t) {
    const int col = lane + 32 * t;
    if (col < Dh) orow[col] = repro::from_f32<T>(acc[t] * inv);
  }
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int B, int S, int H, int Hkv, int causal, int window,
                 float cap, float scale, cudaStream_t stream) {
  // (Dh, heads, S, B) with the layout's strides; boxes of 64 x 1 x 128 x 1
  CUtensorMap mq, mk, mv;
  const cuuint64_t dq[4] = {DH, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t sq[3] = {DH * 2, (cuuint64_t)H * DH * 2,
                            (cuuint64_t)S * H * DH * 2};
  const cuuint64_t dk[4] = {DH, (cuuint64_t)Hkv, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint64_t sk[3] = {DH * 2, (cuuint64_t)Hkv * DH * 2,
                            (cuuint64_t)S * Hkv * DH * 2};
  const cuuint32_t box[4] = {64, 1, fa::BQ, 1};
  static_assert(fa::BQ == fa::BKV, "one box shape for q, k and v");
  if (!tensor_map(&mq, q, 4, dq, sq, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&mk, k, 4, dk, sk, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&mv, v, 4, dk, sk, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = fa::Smem<DH>::BYTES;
  allow_smem(flash_wgmma_kernel<DH>, smem);
  const dim3 grid(B * H, (S + fa::BQ - 1) / fa::BQ);
  flash_wgmma_kernel<DH><<<grid, fa::THREADS, smem, stream>>>(
      mq, mk, mv, (bf16*)o, S, H, Hkv, causal, window, cap, scale);
  return 0;
}

template <typename T>
void launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int Hkv, int Dh, int causal, int window,
                 float cap, float scale, cudaStream_t stream) {
  dim3 grid((S + WARPS - 1) / WARPS, B * H);
  flash_simt_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, Hkv, Dh, causal,
      window, cap, scale);
}

}  // namespace

// q, o: (B, S, H, Dh); k, v: (B, S, Hkv, Dh); one dtype; H % Hkv == 0.
REPRO_API int repro_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int Hkv, int Dh, int causal,
                                    int window, float cap, float scale,
                                    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || Dh <= 0 ||
      Dh > MAX_DH)
    return (int)cudaErrorInvalidValue;
  const bool vec = repro::aligned16(q) && repro::aligned16(k) &&
                   repro::aligned16(v) && repro::aligned16(o);
  int code = 0;
  if (dtype == REPRO_DTYPE_BF16 && vec && Dh == 128) {
    code = launch_wgmma<128>(q, k, v, o, B, S, H, Hkv, causal, window, cap,
                             scale, stream);
  } else if (dtype == REPRO_DTYPE_BF16 && vec && Dh == 64) {
    code = launch_wgmma<64>(q, k, v, o, B, S, H, Hkv, causal, window, cap,
                            scale, stream);
  } else if (dtype == REPRO_DTYPE_BF16) {
    launch_simt<bf16>(q, k, v, o, B, S, H, Hkv, Dh, causal, window, cap,
                      scale, stream);
  } else if (dtype == REPRO_DTYPE_F32) {
    launch_simt<float>(q, k, v, o, B, S, H, Hkv, Dh, causal, window, cap,
                       scale, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (code != 0) return code;
  return (int)cudaGetLastError();
}
