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
// block per (batch * head, 64-query tile) walks its kv tiles in a loop,
// keeping m and l in registers and the accumulator in registers (each lane
// owns half of one query row), and reads the group's kv head in place.
// kv tiles that the causal mask or the window rules out for the whole
// query tile are never loaded.
//
// Bound: operations (4 B S^2 H Dh / 2 for causal: ~69 GFLOP, ~0.07 ms, at
// B = 2, S = 2048, 32 heads of 128).  Design: bf16 tensor cores through
// WMMA (16x16x16, float32 accumulate): each of 4 warps owns 16 query rows,
// computes its 16 x 64 score tile Q K^T (K read as a column-major
// matrix_b, no transpose), runs the softmax on the float32 scores staged in
// shared memory, and multiplies its bf16 P by V; the 16 x Dh product is
// staged through shared memory and folded into the register accumulator
// with the row's correction.  Loads are 16-byte cp.async copies; there is
// no double buffering yet (later work, with wgmma and TMA).  float32 inputs
// and head widths other than 64 and 128 take a plain kernel: one warp per
// query row, lanes over keys for the scores and over Dh for P V.

#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;

template <int DH>
struct Smem {
  static constexpr int LDQ = DH + 8;    // bf16 rows of Q, K, V
  static constexpr int LDS = BKV + 4;   // float32 scores
  static constexpr int LDP = BKV + 8;   // bf16 probabilities
  static constexpr int LDO = DH + 4;    // float32 P V staging
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LDQ * 2;
  static constexpr int V = K + BKV * LDQ * 2;
  static constexpr int SC = V + BKV * LDQ * 2;
  static constexpr int P = SC + BQ * LDS * 4;
  static constexpr int O = P + BQ * LDP * 2;
  static constexpr int BYTES = O + BQ * LDO * 4;
};

__device__ __forceinline__ bool key_ok(int key, int qpos, int S, int causal,
                                       int window) {
  return key < S && (!causal || key <= qpos) &&
         (window <= 0 || key > qpos - window);
}

__device__ __forceinline__ float score(float dot, float scale, float cap) {
  const float s = dot * scale;
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_wmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                  int H, int Hkv, int causal, int window, float cap,
                  float scale) {
  using namespace nvcuda;
  using L = Smem<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::SC);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, hq = bh % H, hk = hq / (H / Hkv);
  const size_t q_row = (size_t)H * DH, kv_row = (size_t)Hkv * DH;
  const bf16* qb = q + (size_t)b * S * q_row + (size_t)hq * DH;
  const bf16* kb = k + (size_t)b * S * kv_row + (size_t)hk * DH;
  const bf16* vb = v + (size_t)b * S * kv_row + (size_t)hk * DH;
  constexpr int CH = DH / 8;  // 16-byte chunks per row

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool ok = q0 + r < S;
    repro::cp_async16(Qs + r * L::LDQ + cc,
                      ok ? qb + (size_t)(q0 + r) * q_row + cc : qb, ok);
  }
  repro::cp_async_commit();

  // kv tiles that hold a key some query of this tile may see
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? q_last + 1 : S;
  const int j_lo = kv_lo / BKV, j_hi = (kv_hi + BKV - 1) / BKV;

  // Lane layout for the softmax and the accumulator: row rl of the warp's
  // 16, half `hf` of the columns.
  const int rl = lane / 2, hf = lane % 2;
  const int qpos = q0 + warp * 16 + rl;
  float m_run = NEG_INF, l_run = 0.f;
  float acc[DH / 2];
#pragma unroll
  for (int t = 0; t < DH / 2; ++t) acc[t] = 0.f;
  float* Sw = Ss + warp * 16 * L::LDS;
  bf16* Pw = Ps + warp * 16 * L::LDP;
  float* Ow = Os + warp * 16 * L::LDO;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // every warp is done with the previous K and V
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int r = c / CH, cc = (c % CH) * 8;
      const bool ok = k0 + r < S;
      const size_t off = (size_t)(k0 + r) * kv_row + cc;
      repro::cp_async16(Ks + r * L::LDQ + cc, ok ? kb + off : kb, ok);
      repro::cp_async16(Vs + r * L::LDQ + cc, ok ? vb + off : vb, ok);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

    // scores: (16 x DH) Q_w times K^T (DH x 64)
#pragma unroll
    for (int jn = 0; jn < BKV / 16; ++jn) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDQ + kk, L::LDQ);
        wmma::load_matrix_sync(bt, Ks + jn * 16 * L::LDQ + kk, L::LDQ);
        wmma::mma_sync(sacc, a, bt, sacc);
      }
      wmma::store_matrix_sync(Sw + jn * 16, sacc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this row's 64 scores, two lanes per row
    constexpr int HALF = BKV / 2;
    float sv[HALF];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const int col = hf * HALF + c;
      float s = score(Sw[rl * L::LDS + col], scale, cap);
      if (!key_ok(k0 + col, qpos, S, causal, window)) s = NEG_INF;
      sv[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const float p = expf(sv[c] - m_new);
      sum += p;
      Pw[rl * L::LDP + hf * HALF + c] = __float2bfloat16_rn(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + sum;
    m_run = m_new;
    __syncwarp();

    // P V: (16 x 64) times (64 x DH), staged for the register update
#pragma unroll
    for (int jn = 0; jn < DH / 16; ++jn) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pacc;
      wmma::fill_fragment(pacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Pw + kk, L::LDP);
        wmma::load_matrix_sync(bv, Vs + kk * L::LDQ + jn * 16, L::LDQ);
        wmma::mma_sync(pacc, a, bv, pacc);
      }
      wmma::store_matrix_sync(Ow + jn * 16, pacc, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < DH / 2; ++t)
      acc[t] = acc[t] * corr + Ow[rl * L::LDO + hf * (DH / 2) + t];
    __syncwarp();  // Ow and Pw are rewritten by the next tile
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    bf16* orow = o + ((size_t)b * S + qpos) * q_row + (size_t)hq * DH +
                 hf * (DH / 2);
#pragma unroll
    for (int t = 0; t < DH / 2; t += 8) {
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) vals[u] = __float2bfloat16_rn(acc[t + u] * inv);
      *reinterpret_cast<uint4*>(orow + t) =
          *reinterpret_cast<const uint4*>(vals);
    }
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
void launch_wmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int Hkv, int causal, int window, float cap,
                 float scale, cudaStream_t stream) {
  constexpr int smem = Smem<DH>::BYTES;
  cudaFuncSetAttribute(flash_wmma_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_wmma_kernel<DH><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, H, Hkv,
      causal, window, cap, scale);
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
  if (dtype == REPRO_DTYPE_BF16 && vec && Dh == 128) {
    launch_wmma<128>(q, k, v, o, B, S, H, Hkv, causal, window, cap, scale,
                     stream);
  } else if (dtype == REPRO_DTYPE_BF16 && vec && Dh == 64) {
    launch_wmma<64>(q, k, v, o, B, S, H, Hkv, causal, window, cap, scale,
                    stream);
  } else if (dtype == REPRO_DTYPE_BF16) {
    launch_simt<bf16>(q, k, v, o, B, S, H, Hkv, Dh, causal, window, cap,
                      scale, stream);
  } else if (dtype == REPRO_DTYPE_F32) {
    launch_simt<float>(q, k, v, o, B, S, H, Hkv, Dh, causal, window, cap,
                       scale, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
