// Gather-of-partials combine (paper §3.1 output aggregation) for Hopper.
//
// Replaces repro/kernels/combine.py:combine (_combine_kernel).
// y[l] = sum_i g[l, i] * p[tim[l, i]], accumulated in float32 in the order
// i = 0..k-1 (a separate multiply and add, no fused multiply-add, so the sum
// rounds exactly as the plain version's), then cast to the output dtype.
//
// Bound: bytes.  Each token reads its k partial rows and writes one row;
// there are about 2 operations per 2-byte element, far below the ~295
// operations per byte where bf16 tensor work would bind.  Design: a block
// of 256 threads holds 256 / tpt tokens, `tpt` threads each: from a warp,
// doubled while the tokens fill less than half of the card's threads (4
// warps a token at Mixtral's prefill, the whole block at decode).  A
// thread keeps its token's first KM slot ids and gates in registers (KM =
// k rounded up to 1, 2, 4 or 8), loaded once, and walks the row in 16-byte
// pieces (8 bf16 or 4 float32), U pieces at a time: it issues all the
// pieces' k row loads before it sums any of them, so each thread has U k
// loads in flight.  Slots past 8 (k > 8) are read as they are summed.  The
// partials are read once and y is written once, so both bypass L1 and are
// marked evict-first (streaming loads and stores).  Rows whose width is not
// a multiple of a piece, or unaligned pointers, take the same walk one
// element at a time.  No shared memory, no atomics, no (L, k, d) buffer.
//
// What the design was chosen from (tools/kernel_ab.py on an H100 80GB
// HBM3 at 700 W, Mixtral's prefill: S = 4096, L = 2048, d = 4096, medians
// of 2): a warp a token read 0.0257 ms, 2 warps 0.0255, 4 warps 0.0251;
// with the streaming hints 2 warps 0.0249 and 4 warps 0.0246; 4 pieces in
// flight a thread instead of 2 read 0.0257.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int U = 2;       // pieces of the row in flight per thread
// threads per token double while all tokens hold fewer threads than this:
// half of what an H100's 132 SMs hold
constexpr long long SPREAD_THREADS = 132 * 1024;

// VEC elements of T in one load: 16 bytes, or one element.
template <typename T, int VEC>
struct Piece {
  static_assert(VEC * sizeof(T) == 16 || VEC == 1, "16-byte pieces");
  using Raw = typename std::conditional<VEC == 1, T, uint4>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldcs(reinterpret_cast<const Raw*>(p));
  }
  __device__ __forceinline__ float at(int e) const {
    if constexpr (VEC == 1) {
      return repro::to_f32(raw);
    } else {
      return repro::to_f32(reinterpret_cast<const T*>(&raw)[e]);
    }
  }
};

template <typename T, int VEC>
__device__ __forceinline__ void store_piece(T* dst, const float (&acc)[VEC]) {
  if constexpr (VEC == 1) {
    __stcs(dst, repro::from_f32<T>(acc[0]));
  } else {
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = repro::from_f32<T>(acc[e]);
    __stcs(reinterpret_cast<uint4*>(dst), out);
  }
}

template <typename T, int VEC, int KM>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const T* __restrict__ p, const int* __restrict__ tim,
               const T* __restrict__ g, T* __restrict__ y, int L, int k,
               int d, int tpt) {
  const int l = blockIdx.x * (THREADS / tpt) + threadIdx.x / tpt;
  if (l >= L) return;
  const int t = threadIdx.x % tpt;
  const int* tl = tim + (size_t)l * k;
  const T* gl = g + (size_t)l * k;
  const T* rows[KM];
  float gate[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    rows[i] = i < k ? p + (size_t)tl[i] * d : p;
    gate[i] = i < k ? repro::to_f32(gl[i]) : 0.f;
  }
  const int step = tpt * VEC;
  for (int c0 = t * VEC; c0 < d; c0 += U * step) {
    Piece<T, VEC> v[U][KM];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < KM; ++i)
        if (i < k && c0 + u * step < d) v[u][i].load(rows[i] + c0 + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * step;
      if (c >= d) continue;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
      for (int i = 0; i < KM; ++i)
        if (i < k)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(gate[i], v[u][i].at(e)));
      for (int i = KM; i < k; ++i) {
        Piece<T, VEC> w;
        w.load(p + (size_t)tl[i] * d + c);
        const float gi = repro::to_f32(gl[i]);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(gi, w.at(e)));
      }
      store_piece<T, VEC>(y + (size_t)l * d + c, acc);
    }
  }
}

template <typename T, int VEC>
void launch_km(int blocks, const void* p, const int* tim, const void* g,
               void* y, int L, int k, int d, int tpt, cudaStream_t stream) {
  auto kernel = k <= 1   ? combine_kernel<T, VEC, 1>
                : k <= 2 ? combine_kernel<T, VEC, 2>
                : k <= 4 ? combine_kernel<T, VEC, 4>
                         : combine_kernel<T, VEC, 8>;
  kernel<<<blocks, THREADS, 0, stream>>>((const T*)p, tim, (const T*)g,
                                         (T*)y, L, k, d, tpt);
}

template <typename T>
int launch(const void* p, const int* tim, const void* g, void* y, int L,
           int k, int d, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = d % VEC == 0 && repro::aligned16(p) && repro::aligned16(y);
  const int piece = vec ? VEC : 1;
  // threads per token: a warp, doubled (up to the block) while the tokens
  // hold fewer than SPREAD_THREADS threads and the row still gives every
  // thread U pieces
  int tpt = 32;
  while (tpt < THREADS && (long long)L * tpt < SPREAD_THREADS &&
         2 * tpt * piece * U <= d)
    tpt *= 2;
  const int per_block = THREADS / tpt;
  const int blocks = (L + per_block - 1) / per_block;
  if (vec)
    launch_km<T, VEC>(blocks, p, tim, g, y, L, k, d, tpt, stream);
  else
    launch_km<T, 1>(blocks, p, tim, g, y, L, k, d, tpt, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// p: (S, d); tim: (L, k) int32 slot ids; g: (L, k) gates in p's dtype;
// y: (L, d).
REPRO_API int repro_combine(int dtype, const void* p, const int* tim,
                            const void* g, void* y, int L, int k, int d,
                            cudaStream_t stream) {
  if (L <= 0 || d <= 0) return 0;
  if (k < 0) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(p, tim, g, y, L, k, d, stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(p, tim, g, y, L, k, d, stream);
  return (int)cudaErrorInvalidValue;
}
