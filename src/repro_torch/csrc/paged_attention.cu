// Paged decode attention for Hopper, over model-dtype or int8 pages.
//
// Replaces repro/kernels/paged_attention.py:paged_attention_pallas
// (_kernel), both branches.  One query token per request attends the
// request's cached keys and values through its page table.  The TPU kernel
// walks pages as a sequential grid dimension and carries the
// online-softmax state in scratch across grid steps.  A Hopper grid runs in
// no order, so the page walk is split (the flash-decoding shape):
//
//   1. paged_split_kernel, grid (B, Hkv, n_split): a block owns a
//      contiguous run of `span` positions (pages_per_split <= 32 pages,
//      their page-table entries held one per lane) of one request and one
//      kv head, and serves the G query heads of that kv head together (held in shared memory; each lane's accumulators in
//      registers), so each K/V byte is read from device memory once per
//      kv head.  A split wholly past the request's position, or wholly
//      before its sliding window, writes m = -inf, l = 0 and exits.  Its
//      four warps take the split's rows in turn; a row is Dh / VEC lanes,
//      each holding 16 bytes (8 bf16, 4 float32 or 16 int8 values), so one
//      warp step covers 32 / (Dh / VEC) rows and no lane idles at page size
//      16.  Rows arrive through 16-byte cp.async copies into the lane's own
//      shared-memory slots, CH rows a stage, two stages in flight; a lane
//      reads back only what it copied, so no barrier guards the ring.
//      Scores are reduced over the row's lanes with warp shuffles; every
//      lane keeps its own online-softmax state (m, l, acc[G][VEC]) for the
//      rows it sees, and the states merge across the rows of a warp
//      (shuffles), then across the warps (shared memory).  The split's
//      (m, l, acc[Dh]) go to a float32 workspace.
//   2. paged_merge_kernel, one block per (request, query head): merges the
//      request's live splits in their order (deterministic, no atomics)
//      and writes acc / max(l, 1e-30) in q's dtype.  It is launched as a
//      programmatic dependent of the first kernel, so its launch overlaps
//      the first kernel's tail.
//
// Scores are float32 from q * Dh^-0.5, with the optional softcap and the
// masks t <= pos and t > pos - window; masked positions take no part.
//
// int8 pages (QUANT): values are int8 and each (position, kv head) vector
// has a float16 scale (P, ps, Hkv, 1).  As in the TPU kernel's quantized
// branch, the score of a key is its int8 dot product times k_scale (before
// the softcap and the masks), the denominator l sums the unscaled
// probabilities, and each probability is multiplied by v_scale before it
// weights the int8 values.  No dequantized copy of a page is ever written.
//
// Bound: bytes (the live K/V rows and their scales), about 1 operation per
// byte; at decode (~4 MB) the bound is below one launch, so the design
// aims at latency: short splits over many blocks, two dependent
// device-memory round trips per block (the position beside the split's
// page-table entries, then the rows), a block's rows in flight together,
// no block-wide barrier inside the walk.

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int NW = 4;               // warps per block
constexpr int THREADS = NW * 32;
constexpr int CH = 4;               // warp steps per cp.async stage
constexpr int GMAX = 8;             // largest GQA group instantiated

// 16 bytes of pages -> VEC float32 values
__device__ __forceinline__ void unpack(const uint4& w, float* f, float) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float* f,
                                       __nv_bfloat16) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float* f, int8_t) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[4 * i + k] = (float)(int8_t)((u[i] >> (8 * k)) & 0xffu);
}

// Online-softmax states (m, l, acc) of two disjoint row sets merged; a
// state with m = -inf is empty.
__device__ __forceinline__ float merge_factor(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

// Live positions of a request, [t_first, t_last] (none when t_first >
// t_last): at or before its position, inside its window and the table.
struct LiveRange {
  int t_first, t_last;
  __device__ LiveRange(int pos, int window, int T) {
    t_first = window > 0 ? max(0, pos - window + 1) : 0;
    t_last = min(pos, T - 1);
  }
};

// T: q and output dtype; P: page dtype (T, or int8_t with QUANT).
template <typename T, typename P, bool QUANT, int G>
__global__ void __launch_bounds__(THREADS, QUANT ? 3 : 4)
paged_split_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                   const P* __restrict__ vp, const __half* __restrict__ kscale,
                   const __half* __restrict__ vscale,
                   const int* __restrict__ table,
                   const int* __restrict__ positions,
                   float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                   int Hkv, int Dh, int ps, int pps, int pages_per_split,
                   int n_split, int window, float cap, float scale) {
  constexpr int VEC = 16 / (int)sizeof(P);
  extern __shared__ uint4 smem[];
  // the merge kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Hq = Hkv * G;
  const int span = pages_per_split * ps;
  const int p_first = sp * pages_per_split;
  // the split's page-table entries (at most 32), one per lane, fetched
  // beside the position
  int tab = 0;
  if (lane < pages_per_split && p_first + lane < pps)
    tab = table[(size_t)b * pps + p_first + lane];
  const int pos = positions[b];
  const LiveRange live(pos, window, pps * ps);
  const int t0 = max(sp * span, live.t_first);
  const int t1 = min((sp + 1) * span, live.t_last + 1);   // exclusive
  // workspace row of query head g: ((b * Hq + h * G + g) * n_split + sp)
  const size_t ws0 = ((size_t)b * Hq + (size_t)h * G) * n_split + sp;
  if (t0 >= t1) {
    if (threadIdx.x < G) {
      const size_t o = (ws0 + (size_t)threadIdx.x * n_split) * 2;
      ws_ml[o] = -INFINITY;
      ws_ml[o + 1] = 0.f;
    }
    return;
  }
  const int lpr = Dh / VEC;          // lanes per row
  const int rpw = 32 / lpr;          // rows per warp step
  const int r = lane / lpr, c = lane % lpr;

  // the G query heads, scaled, in float32 after the ring
  float* qs = reinterpret_cast<float*>(smem + 2 * CH * 2 * THREADS);
  for (int i = threadIdx.x; i < G * Dh; i += THREADS)
    qs[i] = repro::to_f32(q[((size_t)b * Hq + (size_t)h * G) * Dh + i]) *
            scale;

  // warp step `it` of this warp covers rows t0 + (it * NW + warp) * rpw ..
  const int n_it = (t1 - t0 + NW * rpw - 1) / (NW * rpw);
  const int n_chunks = (n_it + CH - 1) / CH;
  float ksc[2][CH], vsc[2][CH];
  // slot (stage, step j, K or V) of this thread: smem[slot * THREADS + tid]
  auto slot = [&](int st, int j, int kv) -> uint4* {
    return smem + ((st * CH + j) * 2 + kv) * THREADS + threadIdx.x;
  };
  auto row_of = [&](int it) { return t0 + (it * NW + warp) * rpw + r; };

  auto issue = [&](int chunk, int st) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int it = chunk * CH + j;
      const int t = row_of(it);
      const bool ok = it < n_it && t < t1;
      const int pg = t / ps;
      const int phys = __shfl_sync(0xffffffffu, tab, (pg - p_first) & 31);
      size_t off = 0, so = 0;
      if (ok) {
        so = ((size_t)phys * ps + (t - pg * ps)) * Hkv + h;
        off = so * Dh + c * VEC;
      }
      repro::cp_async16(slot(st, j, 0), kp + off, ok);
      repro::cp_async16(slot(st, j, 1), vp + off, ok);
      if (QUANT) {
        ksc[st][j] = ok ? __half2float(kscale[so]) : 0.f;
        vsc[st][j] = ok ? __half2float(vscale[so]) : 0.f;
      }
    }
  };

  float acc[G][VEC], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  // A chunk's scores first, then one rescale of the running state to the
  // chunk's max, then its probabilities against the values.
  auto compute = [&](int chunk, int st) {
    const int nj = min(CH, n_it - chunk * CH);    // warp-uniform
    float sc[CH][G];
    bool val[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j >= nj) break;
      val[j] = row_of(chunk * CH + j) < t1;
      float kf[VEC];
      unpack(*slot(st, j, 0), kf, P());
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + g * Dh +
                                                           c * VEC);
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC / 4; ++i) {
          const float4 qv = q4[i];
          s = fmaf(qv.x, kf[4 * i], s);
          s = fmaf(qv.y, kf[4 * i + 1], s);
          s = fmaf(qv.z, kf[4 * i + 2], s);
          s = fmaf(qv.w, kf[4 * i + 3], s);
        }
        for (int o = lpr >> 1; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (QUANT) s *= ksc[st][j];
        if (cap > 0.f) s = cap * tanhf(s / cap);
        sc[j][g] = s;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mn = m[g];
#pragma unroll
      for (int j = 0; j < CH; ++j)
        if (j < nj && val[j]) mn = fmaxf(mn, sc[j][g]);
      if (mn != m[g]) {                   // m = -inf gives corr = 0
        const float corr = expf(m[g] - mn);
        l[g] *= corr;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] *= corr;
        m[g] = mn;
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j >= nj) break;
      float vf[VEC];
      unpack(*slot(st, j, 1), vf, P());
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = val[j] ? expf(sc[j][g] - m[g]) : 0.f;
        l[g] += p;                              // l sums the unscaled p
        const float pv = QUANT ? p * vsc[st][j] : p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i]);
      }
    }
  };

  // Two stages: while chunk k is computed, chunk k + 1 is in flight.
  issue(0, 0);
  repro::cp_async_commit();
  __syncthreads();                                // qs is written
  for (int base = 0; base < n_chunks; base += 2) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int chunk = base + st;
      if (chunk >= n_chunks) break;
      __syncwarp();       // this lane's reads of the other stage are done
      if (chunk + 1 < n_chunks) issue(chunk + 1, st ^ 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
      compute(chunk, st);
    }
  }
  repro::cp_async_wait<0>();

  // merge the row slots of the warp: lanes c, c + lpr, c + 2 lpr, ...
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float M = fmaxf(m[g], mo);
      const float f1 = merge_factor(m[g], M), f2 = merge_factor(mo, M);
      l[g] = l[g] * f1 + lo * f2;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * f1 + ao * f2;
      }
      m[g] = M;
    }
  }

  // merge the warps in shared memory (the cp.async slots are free now)
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(smem);        // NW x G x Dh
  float* wm = wacc + NW * G * Dh;                      // NW x G
  float* wl = wm + NW * G;                             // NW x G
  if (r == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        wacc[(warp * G + g) * Dh + c * VEC + i] = acc[g][i];
      if (c == 0) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * Dh; idx += THREADS) {
    const int g = idx / Dh, dd = idx % Dh;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = merge_factor(wm[w * G + g], M);
      L += wl[w * G + g] * f;
      A += wacc[(w * G + g) * Dh + dd] * f;
    }
    const size_t row = ws0 + (size_t)g * n_split;
    ws_acc[row * Dh + dd] = A;
    if (dd == 0) {
      ws_ml[row * 2] = M;
      ws_ml[row * 2 + 1] = L;
    }
  }
}

// One block per (request, query head): the request's live splits merged in
// their order (deterministic, no atomics), one pass with a running max.
// Launched as a programmatic dependent of the split kernel: it reads the
// position first, then waits for the split kernel's results.
template <typename T>
__global__ void paged_merge_kernel(const float* __restrict__ ws_acc,
                                   const float* __restrict__ ws_ml,
                                   const int* __restrict__ positions,
                                   T* __restrict__ out, int Hq, int n_split,
                                   int Dh, int span, int n_pos, int window) {
  const size_t row = blockIdx.x;
  const LiveRange live(positions[row / Hq], window, n_pos);
  const int s_lo = live.t_first / span, s_hi = live.t_last / span;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* ml = ws_ml + row * n_split * 2;
  const float* acc = ws_acc + row * n_split * Dh;
  for (int dd = threadIdx.x; dd < Dh; dd += blockDim.x) {
    float M = -INFINITY, L = 0.f, A = 0.f;
#pragma unroll 4
    for (int s = s_lo; s <= s_hi; ++s) {
      const float ms = ml[2 * s], ls = ml[2 * s + 1];
      const float as = acc[(size_t)s * Dh + dd];
      const float Mn = fmaxf(M, ms);
      const float f_old = merge_factor(M, Mn), f_new = expf(ms - Mn);
      L = L * f_old + ls * f_new;
      A = A * f_old + as * f_new;
      M = Mn;
    }
    out[row * Dh + dd] = repro::from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, typename P, bool QUANT, int G>
void launch_split(dim3 grid, size_t smem, cudaStream_t stream,
                  const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const int* table,
                  const int* positions, float* ws_acc, float* ws_ml, int Hkv,
                  int Dh, int ps, int pps, int pages_per_split, int n_split,
                  int window, float cap, float scale) {
  paged_split_kernel<T, P, QUANT, G><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const P*)kp, (const P*)vp, (const __half*)ks,
      (const __half*)vs, table, positions, ws_acc, ws_ml, Hkv, Dh, ps, pps,
      pages_per_split, n_split, window, cap, scale);
}

template <typename T, typename P, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* table, const int* positions, void* out,
           float* ws_acc, float* ws_ml, int B, int Hq, int Hkv, int Dh, int ps,
           int pps, int pages_per_split, int window, float cap, float scale,
           cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(P);
  const int G = Hq / Hkv;
  const int lpr = Dh / VEC;
  // a row is a power-of-two count of lanes within one warp
  if (G > GMAX || Dh % VEC != 0 || lpr < 1 || lpr > 32 || (lpr & (lpr - 1)))
    return (int)cudaErrorInvalidValue;
  // a split's page-table entries are held one per lane
  if (pages_per_split <= 0 || pages_per_split > 32)
    return (int)cudaErrorInvalidValue;
  if (!repro::aligned16(kp) || !repro::aligned16(vp))
    return (int)cudaErrorMisalignedAddress;
  const int n_split = (pps + pages_per_split - 1) / pages_per_split;
  const size_t ring = (size_t)2 * CH * 2 * THREADS * sizeof(uint4);
  const size_t merge = sizeof(float) * (size_t)NW * G * (Dh + 2);
  const size_t smem =
      (ring > merge ? ring : merge) + sizeof(float) * (size_t)G * Dh;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv, n_split);
#define REPRO_PAGED_G(NG)                                                    \
  case NG:                                                                   \
    launch_split<T, P, QUANT, NG>(grid, smem, stream, q, kp, vp, ks, vs,     \
                                  table, positions, ws_acc, ws_ml, Hkv, Dh,  \
                                  ps, pps, pages_per_split, n_split, window, \
                                  cap, scale);                               \
    break;
  switch (G) {
    REPRO_PAGED_G(1)
    REPRO_PAGED_G(2)
    REPRO_PAGED_G(3)
    REPRO_PAGED_G(4)
    REPRO_PAGED_G(5)
    REPRO_PAGED_G(6)
    REPRO_PAGED_G(7)
    REPRO_PAGED_G(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_G
  const int err = (int)cudaGetLastError();
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hq);
  cfg.blockDim = dim3(Dh < 32 ? 32 : (Dh > 256 ? 256 : (Dh + 31) / 32 * 32));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int span = pages_per_split * ps;
  return (int)cudaLaunchKernelEx(&cfg, paged_merge_kernel<T>,
                                 (const float*)ws_acc, (const float*)ws_ml,
                                 positions, (T*)out, Hq, n_split, Dh, span,
                                 pps * ps, window);
}

}  // namespace

// q: (B, Hq, Dh); k_pages, v_pages: (P, ps, Hkv, Dh); page_table:
// (B, pps) int32; positions: (B,) int32; out: (B, Hq, Dh); ws_acc:
// (B, Hq, n_split, Dh) and ws_ml: (B, Hq, n_split, 2) float32, with
// n_split = ceil(pps / pages_per_split).
REPRO_API int repro_paged_attention(int dtype, const void* q,
                                    const void* k_pages, const void* v_pages,
                                    const int* page_table,
                                    const int* positions, void* out,
                                    float* ws_acc, float* ws_ml, int B,
                                    int Hq, int Hkv, int Dh, int ps, int pps,
                                    int pages_per_split, int window, float cap,
                                    float scale, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || pps <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, page_table, positions, out,
        ws_acc, ws_ml, B, Hq, Hkv, Dh, ps, pps, pages_per_split, window, cap,
        scale, stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float, float, false>(
        q, k_pages, v_pages, nullptr, nullptr, page_table, positions, out,
        ws_acc, ws_ml, B, Hq, Hkv, Dh, ps, pps, pages_per_split, window, cap,
        scale, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 pages: q: (B, Hq, Dh) in dtype; k_pages, v_pages: (P, ps, Hkv,
// Dh) int8; k_scale, v_scale: (P, ps, Hkv, 1) float16; the rest as above.
REPRO_API int repro_paged_attention_int8(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const int* page_table,
    const int* positions, void* out, float* ws_acc, float* ws_ml, int B,
    int Hq, int Hkv, int Dh, int ps, int pps, int pages_per_split, int window,
    float cap, float scale, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || pps <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16, int8_t, true>(
        q, k_pages, v_pages, k_scale, v_scale, page_table, positions, out,
        ws_acc, ws_ml, B, Hq, Hkv, Dh, ps, pps, pages_per_split, window, cap,
        scale, stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float, int8_t, true>(
        q, k_pages, v_pages, k_scale, v_scale, page_table, positions, out,
        ws_acc, ws_ml, B, Hq, Hkv, Dh, ps, pps, pages_per_split, window, cap,
        scale, stream);
  return (int)cudaErrorInvalidValue;
}
