// Gather-of-partials combine (paper §3.1 output aggregation) for Hopper.
//
// Replaces repro/kernels/combine.py:combine (_combine_kernel).
// y[l] = sum_i g[l, i] * p[tim[l, i]], accumulated in float32 in the order
// i = 0..k-1 (a separate multiply and add, no fused multiply-add, so the sum
// rounds exactly as the plain version's), then cast to the output dtype.
//
// Bound: bytes.  Each token reads its k partial rows and writes one row;
// there are about 2 operations per 2-byte element, far below the ~295
// operations per byte where bf16 tensor work would bind.  Design: one block
// per token, threads across d, so the k row reads and the row write are
// coalesced; no shared memory, no atomics, no (L, k, d) buffer.

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
combine_kernel(const T* __restrict__ p, const int* __restrict__ tim,
               const T* __restrict__ g, T* __restrict__ y, int k, int d) {
  const size_t l = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < k; ++i) {
      const size_t slot = (size_t)tim[l * k + i];
      acc = __fadd_rn(acc, __fmul_rn(repro::to_f32(g[l * k + i]),
                                     repro::to_f32(p[slot * d + c])));
    }
    y[l * d + c] = repro::from_f32<T>(acc);
  }
}

}  // namespace

// p: (S, d); tim: (L, k) int32 slot ids; g: (L, k) gates in p's dtype;
// y: (L, d).
REPRO_API int repro_combine(int dtype, const void* p, const int* tim,
                            const void* g, void* y, int L, int k, int d,
                            cudaStream_t stream) {
  if (L <= 0 || d <= 0) return 0;
  const int threads = d < 256 ? ((d + 31) / 32) * 32 : 256;
  if (dtype == REPRO_DTYPE_BF16) {
    combine_kernel<__nv_bfloat16><<<L, threads, 0, stream>>>(
        (const __nv_bfloat16*)p, tim, (const __nv_bfloat16*)g,
        (__nv_bfloat16*)y, k, d);
  } else if (dtype == REPRO_DTYPE_F32) {
    combine_kernel<float><<<L, threads, 0, stream>>>(
        (const float*)p, tim, (const float*)g, (float*)y, k, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
