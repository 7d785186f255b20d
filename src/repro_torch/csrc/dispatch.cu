// Sort-free dispatch build (paper §4.2) for Hopper.
//
// Replaces repro/kernels/dispatch.py:build_dispatch_pallas (_count_kernel,
// _route_kernel).  The TPU kernels carry a per-expert counter across grid
// steps, which only works because a TPU grid runs in order; here blocks run
// in any order, so the build is the paper's three atomic-free steps:
//
//   1. count: each block counts, per expert, the slots of its CHUNK-slot
//      chunk (thread e scans the chunk held in shared memory);
//   2. scan:  one block sums the per-block counts into lengths, takes the
//      exclusive scan into offsets, and gives each (block, expert) its base
//      offsets[e] + (slots of e in earlier blocks);
//   3. route: each slot's rank among the same-expert slots of its block, in
//      slot order, gives dest = base + rank; tim[slot] = dest and
//      eti[dest] = slot / k.
//
// Ranks follow slot order, so the result is bit-identical to the one-hot
// cumulative-sum build (core/routing.py build_dispatch).  Bound: a few KB of
// integers per call, so launch latency, not bytes or operations; three small
// launches and no atomics or host round trip are the whole design.

#include "common.cuh"

namespace {

constexpr int CHUNK = 256;  // slots per block, one per thread
constexpr int MAX_E = 256;

__global__ void __launch_bounds__(CHUNK)
count_kernel(const int* __restrict__ topk, int n, int E,
             int* __restrict__ block_counts) {
  __shared__ int ids[CHUNK];
  const int b = blockIdx.x;
  const int slot = b * CHUNK + threadIdx.x;
  ids[threadIdx.x] = slot < n ? topk[slot] : -1;  // ragged tail masked
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int c = 0;
    for (int j = 0; j < CHUNK; ++j) c += ids[j] == e;
    block_counts[b * E + e] = c;
  }
}

__global__ void __launch_bounds__(256)
scan_kernel(const int* __restrict__ block_counts, int nb, int E,
            int* __restrict__ lengths, int* __restrict__ offsets,
            int* __restrict__ block_base) {
  __shared__ int tot[MAX_E];
  __shared__ int off[MAX_E + 1];
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int t = 0;
    for (int b = 0; b < nb; ++b) t += block_counts[b * E + e];
    tot[e] = t;
    lengths[e] = t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int e = 0; e < E; ++e) {
      off[e] = run;
      run += tot[e];
    }
    off[E] = run;
  }
  __syncthreads();
  for (int e = threadIdx.x; e <= E; e += blockDim.x) offsets[e] = off[e];
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int run = off[e];
    for (int b = 0; b < nb; ++b) {
      block_base[b * E + e] = run;
      run += block_counts[b * E + e];
    }
  }
}

__global__ void __launch_bounds__(CHUNK)
route_kernel(const int* __restrict__ topk, int n, int k, int E,
             const int* __restrict__ block_base, int* __restrict__ tim,
             int* __restrict__ eti) {
  __shared__ int ids[CHUNK];
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int slot = b * CHUNK + i;
  ids[i] = slot < n ? topk[slot] : -1;
  __syncthreads();
  if (slot >= n) return;
  const int e = ids[i];
  if (e < 0 || e >= E) return;  // not an expert id: nothing to route
  int rank = 0;
  for (int j = 0; j < i; ++j) rank += ids[j] == e;
  const int dest = block_base[b * E + e] + rank;
  tim[slot] = dest;
  eti[dest] = slot / k;
}

}  // namespace

// topk: (n,) int32 expert ids (the flattened (L, k) top-k).  Scratch
// block_counts / block_base: (ceil(n / 256), E) int32.  Outputs: lengths
// (E,), offsets (E+1,), tim (n,), eti (n,), all int32.
REPRO_API int repro_dispatch_build(const int* topk, int n, int k, int E,
                                   int* block_counts, int* block_base,
                                   int* lengths, int* offsets, int* tim,
                                   int* eti, cudaStream_t stream) {
  if (E < 1 || E > MAX_E || k < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const int nb = (n + CHUNK - 1) / CHUNK;
  if (nb > 0) count_kernel<<<nb, CHUNK, 0, stream>>>(topk, n, E, block_counts);
  scan_kernel<<<1, 256, 0, stream>>>(block_counts, nb, E, lengths, offsets,
                                     block_base);
  if (nb > 0)
    route_kernel<<<nb, CHUNK, 0, stream>>>(topk, n, k, E, block_base, tim, eti);
  return (int)cudaGetLastError();
}
