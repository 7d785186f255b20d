// Paged decode attention for Hopper, over model-dtype or int8 pages.
//
// Replaces repro/kernels/paged_attention.py:paged_attention_pallas
// (_kernel), both branches.  One query token per request attends the
// request's cached keys and values through its page table.  The TPU kernel
// walks pages as a sequential grid dimension and carries the
// online-softmax state in scratch across grid steps; here one block owns
// one (request, kv head) pair and walks the pages in a loop, so the state
// stays in the block.
//
// Per block: the G = Hq / Hkv query heads of the kv head, scaled by
// Dh^-0.5, in shared memory as float32; for each live page (up to
// pos // page_size, and not wholly before the sliding window) the page's K
// and V rows of this kv head go to shared memory, one warp per query head
// computes the scores (softcap, masks t <= pos and t > pos - window),
// updates the running max m and denominator l, and all threads rescale and
// add to the float32 accumulator.  Output is acc / max(l, 1e-30) in q's
// dtype.  Pages past the position are never read; inactive slots (position
// 0, table all trash) read the trash page's first row and stay finite.
//
// int8 pages (the second instantiation, QUANT): the values are int8 and
// each (position, kv head) vector has a float16 scale (P, ps, Hkv, 1).  As
// in the TPU kernel's quantized branch, the score of a key is its int8 dot
// product times k_scale (before the softcap and the masks), the running
// denominator sums the unscaled probabilities, and each probability is
// multiplied by v_scale before it weights the int8 values.  No dequantized
// copy of a page is ever written.
//
// Bound: bytes (the live K/V rows, and their scales; about 1 operation per
// byte).  This first version reads each page once per kv head with plain
// coalesced loads and leaves the latency of a short page walk on few
// blocks (B x Hkv) exposed; splitting the walk across blocks is later work.

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

// T: q and output dtype; P: page dtype (T, or int8_t with QUANT).
template <typename T, typename P, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                       const P* __restrict__ vp,
                       const __half* __restrict__ k_scale,
                       const __half* __restrict__ v_scale,
                       const int* __restrict__ table,
                       const int* __restrict__ positions, T* __restrict__ out,
                       int Hq, int Hkv, int Dh, int ps, int pps, int window,
                       float cap, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  float* qs = sm;                     // G * Dh
  float* ks = qs + G * Dh;            // ps * (Dh + 1), padded rows
  float* vs = ks + ps * (Dh + 1);     // ps * Dh
  float* pr = vs + ps * Dh;           // G * ps
  float* acc = pr + G * ps;           // G * Dh
  float* m_s = acc + G * Dh;          // G
  float* l_s = m_s + G;               // G
  float* corr = l_s + G;              // G
  float* ksc = corr + G;              // ps (QUANT)
  float* vsc = ksc + ps;              // ps (QUANT)
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = THREADS / 32;
  const int pos = positions[b];

  for (int i = tid; i < G * Dh; i += THREADS) {
    const int g = i / Dh, dd = i % Dh;
    qs[i] = repro::to_f32(q[((size_t)b * Hq + h * G + g) * Dh + dd]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  const int p_hi = min(pos / ps, pps - 1);
  const int p_lo = window > 0 ? max(0, (pos - window + 1) / ps) : 0;
  __syncthreads();

  for (int pg = p_lo; pg <= p_hi; ++pg) {
    const size_t phys = (size_t)table[(size_t)b * pps + pg];
    const size_t base = phys * ps * Hkv * Dh + (size_t)h * Dh;
    for (int i = tid; i < ps * Dh; i += THREADS) {
      const int t = i / Dh, dd = i % Dh;
      const size_t off = base + (size_t)t * Hkv * Dh + dd;
      ks[t * (Dh + 1) + dd] = repro::to_f32(kp[off]);
      vs[t * Dh + dd] = repro::to_f32(vp[off]);
    }
    if (QUANT) {
      for (int t = tid; t < ps; t += THREADS) {
        const size_t so = (phys * ps + t) * Hkv + h;
        ksc[t] = __half2float(k_scale[so]);
        vsc[t] = __half2float(v_scale[so]);
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      float mx = NEG_INF;
      for (int t = lane; t < ps; t += 32) {
        float s = 0.f;
        for (int dd = 0; dd < Dh; ++dd) s += qs[g * Dh + dd] * ks[t * (Dh + 1) + dd];
        if (QUANT) s *= ksc[t];
        if (cap > 0.f) s = cap * tanhf(s / cap);
        const int ta = pg * ps + t;
        const bool valid = ta <= pos && (window <= 0 || ta > pos - window);
        s = valid ? s : NEG_INF;
        pr[g * ps + t] = s;
        mx = fmaxf(mx, s);
      }
      mx = repro::warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float e = expf(pr[g * ps + t] - m_new);
        pr[g * ps + t] = QUANT ? e * vsc[t] : e;   // l sums the unscaled e
        sum += e;
      }
      sum = repro::warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * Dh; i += THREADS) {
      const int g = i / Dh, dd = i % Dh;
      float a = acc[i] * corr[g];
      for (int t = 0; t < ps; ++t) a += pr[g * ps + t] * vs[t * Dh + dd];
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * Dh; i += THREADS) {
    const int g = i / Dh;
    out[((size_t)b * Hq + h * G) * Dh + i] =
        repro::from_f32<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, typename P, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* table, const int* positions, void* out,
           int B, int Hq, int Hkv, int Dh, int ps, int pps, int window,
           float cap, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) *
      ((size_t)G * Dh * 2 + (size_t)ps * (Dh + 1) + (size_t)ps * Dh +
       (size_t)G * ps + 3 * (size_t)G + (QUANT ? 2 * (size_t)ps : 0));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<T, P, QUANT>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  dim3 grid(B, Hkv);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const P*)kp, (const P*)vp, (const __half*)ks,
      (const __half*)vs, table, positions, (T*)out, Hq, Hkv, Dh, ps, pps,
      window, cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hq, Dh); k_pages, v_pages: (P, ps, Hkv, Dh); page_table:
// (B, pps) int32; positions: (B,) int32; out: (B, Hq, Dh).
REPRO_API int repro_paged_attention(int dtype, const void* q,
                                    const void* k_pages, const void* v_pages,
                                    const int* page_table,
                                    const int* positions, void* out, int B,
                                    int Hq, int Hkv, int Dh, int ps, int pps,
                                    int window, float cap, float scale,
                                    cudaStream_t stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || pps <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, page_table, positions, out, B,
        Hq, Hkv, Dh, ps, pps, window, cap, scale, stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float, float, false>(
        q, k_pages, v_pages, nullptr, nullptr, page_table, positions, out, B,
        Hq, Hkv, Dh, ps, pps, window, cap, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 pages: q: (B, Hq, Dh) in dtype; k_pages, v_pages: (P, ps, Hkv,
// Dh) int8; k_scale, v_scale: (P, ps, Hkv, 1) float16; the rest as above.
REPRO_API int repro_paged_attention_int8(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const int* page_table,
    const int* positions, void* out, int B, int Hq, int Hkv, int Dh, int ps,
    int pps, int window, float cap, float scale, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || pps <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16, int8_t, true>(
        q, k_pages, v_pages, k_scale, v_scale, page_table, positions, out, B,
        Hq, Hkv, Dh, ps, pps, window, cap, scale, stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float, int8_t, true>(
        q, k_pages, v_pages, k_scale, v_scale, page_table, positions, out, B,
        Hq, Hkv, Dh, ps, pps, window, cap, scale, stream);
  return (int)cudaErrorInvalidValue;
}
