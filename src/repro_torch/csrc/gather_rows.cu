// Row gather with zero rows: the ep_a2a send-buffer builder, for Hopper.
//
// Replaces repro/kernels/gather_gmm.py:gather_rows_pallas
// (_gather_rows_kernel).  out[i] = src[ids[i]], and an exact zero row where
// ids[i] < 0 (a pad slot of the send buffer).  An id at or past L is a
// caller's error; the kernel writes a zero row for it rather than read
// outside src.
//
// Bound: bytes.  A pure copy: each valid output row reads one src row and
// every output row is written once, with no arithmetic.  The TPU kernel maps
// all of src into VMEM as one block and walks its rows one by one in a
// fori_loop; here nothing is staged.  One warp owns one output row (8 rows a
// 256-thread block); lane 0 reads the row's id once and broadcasts it, and
// the 32 lanes move the row in 16-byte vectors, neighbouring lanes on
// neighbouring addresses, eight vectors a lane in flight (a 4096-wide bf16
// row in two steps; the first design had four).  A pad row is stores of
// zeros only.  Measured against it (PERF.md, tools/kernel_ab.py): two or
// four rows a warp, sixteen vectors in flight and streaming stores read
// no faster.  A row width or a pointer that is not 16-byte aligned takes
// the element-wise copy instead (a width that is not a multiple of 8 bf16
// or 4 float32 elements).  No shared memory, no atomics, no device-side
// synchronisation; N = 0 launches nothing.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;   // output rows a block, one a warp
constexpr int kUnroll = 8;  // 16-byte vectors a lane in flight

__device__ __forceinline__ int row_id(const int* __restrict__ ids,
                                      size_t row, int lane, int L) {
  int id = lane == 0 ? ids[row] : 0;
  id = __shfl_sync(0xffffffffu, id, 0);
  return id < L ? id : -1;
}

__global__ void __launch_bounds__(kWarps * 32)
gather_rows_vec(const uint4* __restrict__ src, const int* __restrict__ ids,
                uint4* __restrict__ out, int N, int L, int nvec) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (size_t)N) return;
  const int id = row_id(ids, row, lane, L);
  uint4* dst = out + row * nvec;
  const uint4* s = src + (size_t)(id < 0 ? 0 : id) * nvec;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int c = lane; c < nvec; c += 32 * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c + 32 * u;
      v[u] = id >= 0 && i < nvec ? __ldg(s + i) : z;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c + 32 * u;
      if (i < nvec) dst[i] = v[u];
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_elem(const W* __restrict__ src, const int* __restrict__ ids,
                 W* __restrict__ out, int N, int L, int d) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (size_t)N) return;
  const int id = row_id(ids, row, lane, L);
  W* dst = out + row * d;
  if (id < 0) {
    for (int c = lane; c < d; c += 32) dst[c] = W(0);
    return;
  }
  const W* s = src + (size_t)id * d;
  for (int c = lane; c < d; c += 32) dst[c] = s[c];
}

}  // namespace

// src: (L, d) of elem_bytes-wide elements (4: float32, 2: bf16); ids: (N,)
// int32; out: (N, d).
REPRO_API int repro_gather_rows(int elem_bytes, const void* src,
                                const int* ids, void* out, int N, int L,
                                int d, cudaStream_t stream) {
  if (N <= 0 || d <= 0) return 0;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const dim3 block(kWarps * 32);
  const size_t row_bytes = (size_t)d * elem_bytes;
  if (row_bytes % 16 == 0 && repro::aligned16(src) && repro::aligned16(out)) {
    gather_rows_vec<<<(N + kWarps - 1) / kWarps, block, 0, stream>>>(
        (const uint4*)src, ids, (uint4*)out, N, L, (int)(row_bytes / 16));
  } else if (elem_bytes == 2) {
    gather_rows_elem<unsigned short><<<(N + kWarps - 1) / kWarps, block, 0,
                                       stream>>>(
        (const unsigned short*)src, ids, (unsigned short*)out, N, L, d);
  } else {
    gather_rows_elem<unsigned int><<<(N + kWarps - 1) / kWarps, block, 0,
                                     stream>>>(
        (const unsigned int*)src, ids, (unsigned int*)out, N, L, d);
  }
  return (int)cudaGetLastError();
}
