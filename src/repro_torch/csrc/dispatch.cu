// Sort-free dispatch build (paper §4.2) for Hopper.
//
// Replaces repro/kernels/dispatch.py:build_dispatch_pallas (_count_kernel,
// _route_kernel).  The TPU kernels carry a per-expert counter across grid
// steps, which only works because a TPU grid runs in order.  Here the build
// is the paper's GPU pipeline: a token->expert map, per-expert lengths by
// warp reductions, and the location map from CTA-local exclusive scans plus
// global offsets.  No atomics, no host round trip.
//
// A block takes a tile of slots and stages its ids in shared memory (16-byte
// loads, a scalar tail).  Each of its W warps owns a contiguous run of the
// tile, so slot order is tile order, then warp order, then lane order.  A
// warp walks its run 32 slots at a time (the count walk).  The lanes that
// hold a lane's expert are the AND over the id's bits of the ballots that
// agree with it (ceil(log2 E) ballots); the slot's rank in the piece is
// popc(peers & lanemask_lt), and the lowest lane of each group adds
// popc(peers) to the warp's own count row in shared memory (one writer per
// row, so no atomics).  The slot's rank, group leader and group size replace
// its id in shared memory.  Shared-memory scans then give, per expert, the
// slots of earlier warps and the offsets (a scan over experts); a second
// walk of the run (the route walk) lets each group's leader take the
// group's places from the warp's row and hand the first to the group by a
// shuffle:
//   tim[slot]  = offsets[e] + tile_base[e] + warp_base[w][e] + running[e]
//                + rank,
//   eti[dest]  = slot / k.
//
// Where the tiles' slots come from (kernels/dispatch.py:dispatch_plan):
// - n <= N_ONE (16384): one launch, a thread-block cluster of at most 8
//   blocks (a plain launch of one block up to 512 slots).  After the count
//   walk each block reads the other blocks' tile totals from their shared
//   memory (DSMEM) between two cluster barriers (hardware barriers, not
//   atomics), a warp an expert, a lane a block.
// - past N_ONE: two launches over tiles of TILE slots.  count_kernel writes
//   each tile's per-expert counts (E, T); build_kernel<false>, launched as
//   its programmatic dependent, stages and counts its own tile before it
//   waits for them, then forms its base and the totals by warps that stride
//   over the tiles' counts (each lane reads T / 32 of them).
// Block 0 writes lengths and offsets.  No thread loops over all tiles or all
// slots.
//
// Ranks follow slot order, so the result is bit-identical to the one-hot
// cumulative-sum build (core/routing.py build_dispatch).  An id outside
// [0, E) is counted nowhere and not routed (its tim entry is not written).
//
// Bound: 12 bytes a slot plus 8 an expert (ids read, tim and eti written,
// lengths and offsets), ~0.1 MB at n = 8192, so the bound is the launch:
// one at n <= N_ONE, past it a pair, the second the first's programmatic
// dependent (repro_noop times both).

#include "common.cuh"

namespace {

constexpr int MAX_E = 256;
constexpr int MAX_WARPS = 32;
constexpr int MAX_CLUSTER = 8;  // blocks of the one-launch build (portable)
constexpr unsigned FULL = 0xffffffffu;
// the plan's tiles need at most ~45 KB (2048 slots, 256 experts), within
// the default a launch gets without opting in
constexpr size_t SMEM_DEFAULT = 48 * 1024;

__host__ __device__ inline int warps_for(int tile) {
  const int pieces = (tile + 31) / 32;
  return pieces < 1 ? 1 : (pieces < MAX_WARPS ? pieces : MAX_WARPS);
}

// ids (tile, rounded up to 4) | counts (W, E) | tot (E) | gbase (E) |
// tile_tot (E) | off (E + 1), all int32.  kernels/dispatch.py:dispatch_plan
// mirrors it.
__host__ __device__ inline size_t smem_bytes(int tile, int E) {
  const size_t tile4 = ((size_t)tile + 3) / 4 * 4;
  return 4 * (tile4 + (size_t)warps_for(tile) * E + 4 * (size_t)E + 1);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// p's int in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ int ld_dsmem(const int* p, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned ra;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(ra)
               : "memory");
  return v;
}

// A routed slot's record in its id's place after the count walk: the
// expert (8 bits), the slot's rank among the piece's lanes of that expert
// (5), the lowest such lane (5) and their number (6); -1 for a slot that
// is not routed.
__device__ __forceinline__ int pack(int e, int rank, int leader, int size) {
  return e | rank << 8 | leader << 13 | size << 18;
}

struct Tile {
  int* ids;       // the tile's ids, then the slots' records
  int* cnt;       // (W, E): per-warp counts, then per-warp bases
  int* tot;       // (E,): slots of each expert in all tiles
  int* gbase;     // (E,): slots of each expert in earlier tiles
  int* tile_tot;  // (E,): slots of each expert in this tile
  int* off;       // (E + 1,)
  int t0, len, W, warp, lane, lo, hi;
};

// Stage the tile's ids, zero the count rows, and count each warp's run.
__device__ Tile count_tile(const int* __restrict__ topk, int n, int E,
                           int tile, int* smem) {
  Tile s;
  s.W = warps_for(tile);
  s.ids = smem;
  s.cnt = smem + ((tile + 3) / 4 * 4);
  s.tot = s.cnt + s.W * E;
  s.gbase = s.tot + E;
  s.tile_tot = s.gbase + E;
  s.off = s.tile_tot + E;
  s.t0 = blockIdx.x * tile;
  s.len = max(0, min(tile, n - s.t0));
  s.warp = threadIdx.x >> 5;
  s.lane = threadIdx.x & 31;
  const int per_warp = (tile + 32 * s.W - 1) / (32 * s.W) * 32;
  s.lo = min(s.len, s.warp * per_warp);
  s.hi = min(s.len, s.lo + per_warp);

  const int* src = topk + s.t0;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const int nv = s.len >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(s.ids);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = __ldg(s4 + i);
    head = nv << 2;
  }
  for (int i = head + threadIdx.x; i < s.len; i += blockDim.x)
    s.ids[i] = __ldg(src + i);
  for (int i = threadIdx.x; i < s.W * E; i += blockDim.x) s.cnt[i] = 0;
  __syncthreads();

  const int bits = E > 1 ? 32 - __clz(E - 1) : 0;
  const unsigned below = lanemask_lt();
  int* row = s.cnt + s.warp * E;
  for (int b = s.lo; b < s.hi; b += 32) {
    const int i = b + s.lane;
    const int e = i < s.hi ? s.ids[i] : -1;
    const bool ok = (unsigned)e < (unsigned)E;
    unsigned peers = __ballot_sync(FULL, ok);
    for (int bit = 0; bit < bits; ++bit) {
      const bool set = (e >> bit) & 1;
      const unsigned v = __ballot_sync(FULL, set);
      peers &= set ? v : ~v;
    }
    if (ok) {
      const int rank = __popc(peers & below);
      const int size = __popc(peers);
      if (rank == 0) row[e] += size;
      s.ids[i] = pack(e, rank, __ffs(peers) - 1, size);
    } else if (i < s.hi) {
      s.ids[i] = -1;
    }
    __syncwarp();
  }
  __syncthreads();
  return s;
}

// Per expert: cnt[w][e] <- slots of e in the tile's earlier warps;
// tile_tot[e] <- the tile's slots of e.  Up to 4 rows a thread an expert
// walks them; more take a warp-shuffle scan, a warp an expert.
__device__ void scan_warps(const Tile& s, int E) {
  if (s.W <= 4) {
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      int run = 0;
      for (int w = 0; w < s.W; ++w) {
        const int c = s.cnt[w * E + e];
        s.cnt[w * E + e] = run;
        run += c;
      }
      s.tile_tot[e] = run;
    }
    return;
  }
  for (int e = s.warp; e < E; e += s.W) {
    const int c = s.lane < s.W ? s.cnt[s.lane * E + e] : 0;
    const int incl = warp_incl_scan(c, s.lane);
    if (s.lane < s.W) s.cnt[s.lane * E + e] = incl - c;
    if (s.lane == 31) s.tile_tot[e] = incl;
  }
}

// Per-tile counts, (E, T): the first of the two launches past N_ONE.
__global__ void __launch_bounds__(1024)
count_kernel(const int* __restrict__ topk, int n, int E, int tile, int T,
             int* __restrict__ counts) {
  // build_kernel<false> may start now: it counts its own tile before it
  // waits for these counts
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ int4 smem4[];
  const Tile s = count_tile(topk, n, E, tile, reinterpret_cast<int*>(smem4));
  scan_warps(s, E);
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    counts[e * T + blockIdx.x] = s.tile_tot[e];
}

// The build.  CLUSTER: the grid is one cluster and the tiles' totals are in
// its blocks' shared memory; otherwise one block a tile, launched as
// count_kernel's programmatic dependent, the totals in counts (E, T).
template <bool CLUSTER>
__global__ void __launch_bounds__(1024)
build_kernel(const int* __restrict__ topk, int n, int k, int kshift, int E,
             int tile, int T, const int* __restrict__ counts,
             int* __restrict__ lengths, int* __restrict__ offsets,
             int* __restrict__ tim, int* __restrict__ eti) {
  extern __shared__ int4 smem4[];
  const Tile s = count_tile(topk, n, E, tile, reinterpret_cast<int*>(smem4));
  scan_warps(s, E);
  if (CLUSTER) {
    if (T > 1) {
      cluster_arrive();  // this block's tile totals are ready
      cluster_wait();
    } else {
      __syncthreads();
    }
  } else {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }
  if (CLUSTER && T == 1) {
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      s.gbase[e] = 0;
      s.tot[e] = s.tile_tot[e];
    }
  } else {
    // per expert (a warp each), lanes over the tiles: the slots of earlier
    // tiles and of all
    for (int e = s.warp; e < E; e += s.W) {
      int before = 0, all = 0;
      for (int t = s.lane; t < T; t += 32) {
        const int v = CLUSTER ? ld_dsmem(s.tile_tot + e, t) : counts[e * T + t];
        all += v;
        before += t < (int)blockIdx.x ? v : 0;
      }
      before = warp_sum_int(before);
      all = warp_sum_int(all);
      if (s.lane == 0) {
        s.gbase[e] = before;
        s.tot[e] = all;
      }
    }
  }
  // no block may leave (and free its shared memory) before every block has
  // read it: arrive now, wait at the end
  if (CLUSTER && T > 1) cluster_arrive();
  __syncthreads();

  // offsets: exclusive scan of the totals over experts (warp 0, a run of
  // ceil(E / 32) experts a lane)
  if (s.warp == 0) {
    const int per = (E + 31) / 32;
    const int e0 = min(E, s.lane * per), e1 = min(E, e0 + per);
    int sum = 0;
    for (int e = e0; e < e1; ++e) sum += s.tot[e];
    const int incl = warp_incl_scan(sum, s.lane);
    int run = incl - sum;
    for (int e = e0; e < e1; ++e) {
      s.off[e] = run;
      run += s.tot[e];
    }
    if (s.lane == 31) s.off[E] = incl;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      lengths[e] = s.tot[e];
      offsets[e] = s.off[e];
    }
    if (threadIdx.x == 0) offsets[E] = s.off[E];
  }
  for (int i = threadIdx.x; i < s.W * E; i += blockDim.x) {
    const int e = i % E;
    s.cnt[i] += s.off[e] + s.gbase[e];
  }
  __syncthreads();

  // route: the second walk of the warp's run, from the slots' records.  The
  // lowest lane of each expert's group takes the group's places from the
  // warp's row and hands the first to the group.
  int* row = s.cnt + s.warp * E;
  for (int b = s.lo; b < s.hi; b += 32) {
    const int i = b + s.lane;
    const int v = i < s.hi ? s.ids[i] : -1;
    const int rank = (v >> 8) & 31;
    int base = 0;
    if (v >= 0 && rank == 0) {
      const int e = v & 255;
      base = row[e];
      row[e] = base + (v >> 18);
    }
    base = __shfl_sync(FULL, base, (v >> 13) & 31);
    if (v >= 0) {
      const int slot = s.t0 + i;
      tim[slot] = base + rank;
      eti[base + rank] = kshift >= 0 ? slot >> kshift : slot / k;
    }
    __syncwarp();
  }
  if (CLUSTER && T > 1) cluster_wait();
}

// An empty kernel.  DEPENDENT: it lets its programmatic dependent start at
// once and waits for its own predecessor, as count_kernel and
// build_kernel<false> do.
template <bool DEPENDENT>
__global__ void noop_kernel() {
  if (DEPENDENT) {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }
}

}  // namespace

// topk: (n,) int32 expert ids (the flattened (L, k) top-k).  tile: slots a
// block takes (kernels/dispatch.py:dispatch_plan).  T = ceil(n / tile)
// tiles: up to 8 are one launch of one cluster; more are two launches,
// with scratch counts (E, T) int32.  Outputs: lengths (E,), offsets (E+1,),
// tim (n,), eti (n,), all int32.
REPRO_API int repro_dispatch_build(const int* topk, int n, int k, int E,
                                   int tile, int* counts, int* lengths,
                                   int* offsets, int* tim, int* eti,
                                   cudaStream_t stream) {
  if (E < 1 || E > MAX_E || k < 1 || n < 0 || tile < 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(tile, E);
  if (smem > SMEM_DEFAULT) return (int)cudaErrorInvalidValue;
  const int T = n > tile ? (n + tile - 1) / tile : 1;
  const int kshift = (k & (k - 1)) == 0 ? __builtin_ctz(k) : -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T);
  cfg.blockDim = dim3(32 * warps_for(tile));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (T <= MAX_CLUSTER) {
    // one block needs no cluster (a cluster launch read ~3 us slower)
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = T;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = T > 1 ? 1 : 0;
    return (int)cudaLaunchKernelEx(&cfg, build_kernel<true>, topk, n, k,
                                   kshift, E, tile, T, (const int*)nullptr,
                                   lengths, offsets, tim, eti);
  }
  count_kernel<<<T, cfg.blockDim, smem, stream>>>(topk, n, E, tile, T,
                                                  counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the build starts while the counts are written: it stages and counts its
  // tile, then waits for them (griddepcontrol.wait)
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  return (int)cudaLaunchKernelEx(&cfg, build_kernel<false>, topk, n, k,
                                 kshift, E, tile, T, (const int*)counts,
                                 lengths, offsets, tim, eti);
}

// `launches` empty kernels back to back, each after the first launched as
// its predecessor's programmatic dependent if `dependent`: chip_smoke.py
// times them as the launch floor of a kernel that needs as many launches
// (in the same pattern) in its bound.
REPRO_API int repro_noop(int launches, int dependent, cudaStream_t stream) {
  if (launches < 1) return (int)cudaErrorInvalidValue;
  if (!dependent) {
    for (int i = 0; i < launches; ++i)
      noop_kernel<false><<<1, 32, 0, stream>>>();
    return (int)cudaGetLastError();
  }
  noop_kernel<true><<<1, 32, 0, stream>>>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int i = 1; i < launches; ++i) {
    const cudaError_t err = cudaLaunchKernelEx(&cfg, noop_kernel<true>);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
