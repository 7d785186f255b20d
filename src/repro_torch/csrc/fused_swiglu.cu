// Fused dense SwiGLU (paper §5.2 and Algorithm 1) for Hopper: the forward
// dual GEMM with its SwiGLU epilogue and the two backward kernels.
//
// Replaces repro/kernels/fused_swiglu.py:
//   fused_swiglu_fwd   (_fwd_kernel)    a = x w1, b = x w2 (float32
//       accumulators), y = silu(a) b; y, a and b rounded once to x's dtype;
//   fused_swiglu_bwd_x (_bwd_x_kernel)  da = dy b silu'(a), db = dy silu(a)
//       in float32, each rounded to dy's dtype; dx = da w1^T + db w2^T in
//       one float32 accumulator, rounded once;
//   fused_swiglu_bwd_w (_bwd_w_kernel)  the same da, db (rounded to x's
//       dtype); dw1 = x^T da, dw2 = x^T db sharing one read of x; output in
//       x's dtype.
// with silu'(a) = s (1 + a (1 - s)), s = sigmoid(a).
//
// The TPU kernels zero float32 scratch at the first step of an innermost
// contraction axis (d, h or L) and carry it across grid steps that run in
// order.  A Hopper grid runs in no order, so here every block owns one
// output tile and loops over the whole contraction itself, with the
// accumulators in registers: no sum crosses blocks, so there are no atomics.
//
//   fwd:   block = (128 rows x 64 columns of h) of a and b; each x tile is
//          staged in shared memory once and feeds both products (the single
//          read of x that is the §5.2 fusion); the epilogue runs from the
//          float32 accumulators.
//   bwd_x: block = (128 rows x 256 columns of d) of dx, warp-specialized
//          for Hopper: a producer warp streams dy, a, b and w1, w2 tiles by
//          TMA into a 4-stage ring; two consumer warpgroups form da and db
//          in registers, in the wgmma A-fragment layout, and issue wgmma
//          against w1 and w2 into one float32 accumulator.  da and db never
//          reach HBM; they are recomputed for each 256-wide d-tile.
//   bwd_w: block = (128 rows of d x 64 columns of h) of dw1 and dw2; per
//          32-row chunk of L it forms da and db in shared memory the same
//          way and accumulates x^T da and x^T db (the x chunk read
//          column-major is x^T without a copy).
//
// Bound: operations at training and prefill (4 L d h each: 1.46 TFLOP at
// L = 4096, d = 5120, h = 17408) and bytes at decode (L = 4 slots read
// 356.5 MB of w1 | w2).  Design: fwd and bwd_w are bf16 WMMA (16x16x16,
// float32 accumulate) fed by rings of 16-byte cp.async copies; bwd_x is
// wgmma (m64n256k16, A from registers) fed by TMA.
// Any L, d and h: tails are bounds-checked (rows past L and columns past d
// or h are zero-filled on load and never stored).  float32, and bf16 widths
// that are not a multiple of 8 (or unaligned pointers), take a plain
// float32-FMA tiled kernel with scalar, masked loads.

#include <cuda.h>
#include <mma.h>

#include <initializer_list>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16,
                                       16, float>;

constexpr int THREADS = 256;
constexpr int BK = 32;   // contraction depth of one pipeline step

// sigmoid in float32.  The tensor-core path rounds every result to bf16,
// so it takes the fast exponential and division; the float32 path keeps
// the accurate ones.
template <bool FAST>
__device__ __forceinline__ float sigmoid_(float a) {
  if (FAST) return __fdividef(1.f, 1.f + __expf(-a));
  return 1.f / (1.f + expf(-a));
}

// da = (dy b) silu'(a) and db = dy silu(a), as the TPU kernels order them.
template <bool FAST>
__device__ __forceinline__ void swiglu_grads(float dy, float a, float b,
                                             float& da, float& db) {
  const float s = sigmoid_<FAST>(a);
  da = dy * b * (s * (1.f + a * (1.f - s)));
  db = dy * (a * s);
}

// Converts 8 consecutive bf16 elements of dy, a, b in shared memory into
// da (over dy) and db (over a), rounded to bf16.
__device__ __forceinline__ void grads8_inplace(bf16* dy, bf16* a,
                                               const bf16* b) {
  __align__(16) bf16 vd[8], va[8], vb[8];
  *reinterpret_cast<uint4*>(vd) = *reinterpret_cast<const uint4*>(dy);
  *reinterpret_cast<uint4*>(va) = *reinterpret_cast<const uint4*>(a);
  *reinterpret_cast<uint4*>(vb) = *reinterpret_cast<const uint4*>(b);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float da, db;
    swiglu_grads<true>(__bfloat162float(vd[u]), __bfloat162float(va[u]),
                       __bfloat162float(vb[u]), da, db);
    vd[u] = __float2bfloat16_rn(da);
    va[u] = __float2bfloat16_rn(db);
  }
  *reinterpret_cast<uint4*>(dy) = *reinterpret_cast<const uint4*>(vd);
  *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(va);
}

// Stores a BM x BN float32 staging tile (row stride ldc) to out (row
// stride ld) as bf16, 8 elements (16 bytes) per thread per step; rows at
// or past nrows and columns at or past ncols are skipped.
template <int BM, int BN>
__device__ __forceinline__ void store_tile(const float* Cs, int ldc, bf16* out,
                                           int ld, int m0, int n0, int nrows,
                                           int ncols) {
  for (int c = threadIdx.x; c < BM * (BN / 8); c += THREADS) {
    const int r = c / (BN / 8);
    const int cc = (c % (BN / 8)) * 8;
    const int gr = m0 + r, gc = n0 + cc;
    if (gr >= nrows || gc >= ncols) continue;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __float2bfloat16_rn(Cs[r * ldc + cc + u]);
    *reinterpret_cast<uint4*>(out + (size_t)gr * ld + gc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// Writes a warp's MI x NI accumulator fragments at (wm, wn) of a float32
// staging tile.
template <int MI, int NI>
__device__ __forceinline__ void stage_acc(float* Cs, int ldc,
                                          AccFrag (&acc)[MI][NI], int wm,
                                          int wn) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      nvcuda::wmma::store_matrix_sync(Cs + (wm + i * 16) * ldc + wn + j * 16,
                                      acc[i][j], ldc,
                                      nvcuda::wmma::mem_row_major);
}

template <int MI, int NI>
__device__ __forceinline__ void zero_acc(AccFrag (&acc)[MI][NI]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
}

// ---------------------------------------------------------------------------
// forward, tensor cores: (x, w1, w2) -> (y, a, b)
// ---------------------------------------------------------------------------

namespace fwd {
constexpr int BM = 128, BN = 64, STAGES = 4;
constexpr int LDA = BK + 8;   // x tile: BM rows of BK
constexpr int LDB = BN + 8;   // weight tile: BK rows of BN
constexpr int LDC = BN + 4;
constexpr int A_STAGE = BM * LDA, B_STAGE = BK * LDB;
constexpr int PIPE = STAGES * (A_STAGE + 2 * B_STAGE) * (int)sizeof(bf16);
constexpr int EPI = BM * LDC * (int)sizeof(float);
constexpr int SMEM = PIPE > EPI ? PIPE : EPI;
}  // namespace fwd

// SPARSE (L <= BM, decode): a 16-row fragment at or past L holds only
// zero-filled rows, so its products are skipped; the test costs a dense
// tile, so dense launches compile without it.
template <bool SPARSE>
__global__ void __launch_bounds__(THREADS)
swiglu_fwd_wmma(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const bf16* __restrict__ w2, bf16* __restrict__ y,
                bf16* __restrict__ a_out, bf16* __restrict__ b_out, int L,
                int d, int h) {
  using namespace nvcuda;
  using namespace fwd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* B1s = As + STAGES * A_STAGE;
  bf16* B2s = B1s + STAGES * B_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nsteps = (d + BK - 1) / BK;

  // x tile: BM rows x BK/8 16-byte pieces (2 per thread); weight tiles:
  // BK rows x BN/8 pieces (1 per thread per weight).
  auto load_stage = [&](int step, int stage) {
    const int k0 = step * BK;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int piece = tid + c * THREADS;
      const int row = piece / (BK / 8), col = (piece % (BK / 8)) * 8;
      const int r = m0 + row, kc = k0 + col;
      const bool ok = r < L && kc < d;
      repro::cp_async16(As + stage * A_STAGE + row * LDA + col,
                        ok ? x + (size_t)r * d + kc : x, ok);
    }
    const int brow = tid / (BN / 8), bcol = (tid % (BN / 8)) * 8;
    const int kr = k0 + brow, col = n0 + bcol;
    const bool ok = kr < d && col < h;
    const size_t off = (size_t)kr * h + col;
    repro::cp_async16(B1s + stage * B_STAGE + brow * LDB + bcol,
                      ok ? w1 + off : w1, ok);
    repro::cp_async16(B2s + stage * B_STAGE + brow * LDB + bcol,
                      ok ? w2 + off : w2, ok);
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // 4 x 2 warps, 32 x 32 each
  const int wn = (warp % 2) * 32;
  int ni = 2;
  if (SPARSE) {
    // warp-uniform: the row fragments [0, ni) hold rows below L
    ni = 0;
    for (int i = 0; i < 2; ++i)
      if (m0 + wm + i * 16 < L) ni = i + 1;
  }
  AccFrag acc1[2][2], acc2[2][2];
  zero_acc(acc1);
  zero_acc(acc2);

  // Ring of STAGES tiles (as in gather_gmm.cu): at step s the wait leaves
  // the newest STAGES - 2 groups in flight, so step s's tile has landed;
  // the barrier frees the stage that the next load reuses.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    repro::cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = s + STAGES - 1;
    if (nxt < nsteps) load_stage(nxt, nxt % STAGES);
    repro::cp_async_commit();
    const bf16* A = As + (s % STAGES) * A_STAGE;
    const bf16* B1 = B1s + (s % STAGES) * B_STAGE;
    const bf16* B2 = B2s + (s % STAGES) * B_STAGE;
    if (ni == 0) continue;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < ni)
          wmma::load_matrix_sync(a[i], A + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], B1 + kk * LDB + wn + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < ni)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc1[i][j], a[i], b[j], acc1[i][j]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], B2 + kk * LDB + wn + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < ni)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc2[i][j], a[i], b[j], acc2[i][j]);
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // the epilogue reuses the ring's shared memory

  // a and b, each rounded once; then y = silu(a) b from the float32
  // accumulators (both share one fragment layout), rounded once.
  stage_acc(Cs, LDC, acc1, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, a_out, h, m0, n0, L, h);
  __syncthreads();
  stage_acc(Cs, LDC, acc2, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, b_out, h, m0, n0, L, h);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      for (int t = 0; t < acc1[i][j].num_elements; ++t) {
        const float av = acc1[i][j].x[t];
        acc1[i][j].x[t] = (av * sigmoid_<true>(av)) * acc2[i][j].x[t];
      }
  stage_acc(Cs, LDC, acc1, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, y, h, m0, n0, L, h);
}

// ---------------------------------------------------------------------------
// backward dx, Hopper tensor cores: (dy, a, b, w1, w2) -> dx
//
// dx (L x d) = da w1^T + db w2^T with K = h.  w1 and w2 are (d, h) row-major,
// so as the B operand (N = d, K = h) they are already K-major: TMA copies
// their (BN x BK) tiles, 64-byte swizzled, which is the layout wgmma reads
// from shared memory.  dy, a and b arrive the same way as (BM x BK) tiles.
// One producer warp issues the TMA copies into a ring of STAGES stages
// (mbarriers full / empty); two consumer warpgroups, 64 rows each, read
// their dy, a, b fragments with ldmatrix straight into the wgmma A-register
// layout, form da = dy b silu'(a) and db = dy silu(a) in float32, round each
// to bf16 (the reference's rounding points), and issue register-A wgmma
// m64n256k16 against w1 and then w2 into one float32 accumulator.  One
// wgmma group stays in flight, so the next k-step's elementwise work
// overlaps the tensor cores.  da and db never leave registers; they are
// recomputed once per 256-wide d-tile (d / 256 times).  One persistent
// block per SM walks the tiles, rows of L fastest, so the blocks at work
// share their w1 / w2 tiles in L2, and the producer fills the ring for the
// next tile while the consumers store the last one.  Tails
// (rows past L, columns past d, h past the last BK) are zero-filled by TMA
// and never stored.
// ---------------------------------------------------------------------------

namespace bwdx {
constexpr int BM = 128, BN = 256, STAGES = 4;
static_assert(BK == 32, "the 64-byte swizzle holds rows of 32 bf16");
constexpr int CONSUMERS = 2;                       // warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 2;               // a dy, a or b tile
constexpr int B_BYTES = BN * BK * 2;               // a w1 or w2 tile
constexpr int STAGE_BYTES = 3 * A_BYTES + 2 * B_BYTES;
// the ring, 1024 bytes to align it, the full and empty barriers
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
}  // namespace bwdx

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the (BK x rows) box at (k0, row0) of a 2-D tensor map into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k0, int row0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 64-byte swizzle:
// rows of 64 bytes, 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of v across this point
// (the wgmma unit reads and writes these registers asynchronously).
__device__ __forceinline__ void reg_fence(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& v) {
  asm volatile("" : "+r"(v)::"memory");
}

// d (64 x 256, float32, this thread's 128 values) += A (64 x 16, bf16, in
// registers) x B (16 x 256, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// da, db of two bf16 pairs (dy, a, b) as bf16 pairs, each element rounded
// once from float32.
__device__ __forceinline__ void grads_pair(uint32_t dy, uint32_t a,
                                           uint32_t b, uint32_t& da,
                                           uint32_t& db) {
  float da0, db0, da1, db1;
  swiglu_grads<true>(__uint_as_float(dy << 16), __uint_as_float(a << 16),
                     __uint_as_float(b << 16), da0, db0);
  swiglu_grads<true>(__uint_as_float(dy & 0xffff0000u),
                     __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b & 0xffff0000u), da1, db1);
  const __nv_bfloat162 pa = __floats2bfloat162_rn(da0, da1);
  const __nv_bfloat162 pb = __floats2bfloat162_rn(db0, db1);
  da = *reinterpret_cast<const uint32_t*>(&pa);
  db = *reinterpret_cast<const uint32_t*>(&pb);
}

__global__ void __launch_bounds__(bwdx::THREADS, 1)
swiglu_bwd_x_wgmma(const __grid_constant__ CUtensorMap tm_dy,
                   const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_w1,
                   const __grid_constant__ CUtensorMap tm_w2,
                   bf16* __restrict__ dx, int L, int d, int h) {
  using namespace bwdx;
  extern __shared__ unsigned char smem[];
  // the swizzle is a function of address bits: align the ring to 1024
  const uint32_t raw = smem_u32(smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;   // STAGES barriers
  const uint32_t empty = full + STAGES * 8;            // STAGES barriers

  // Persistent: each block walks tiles blockIdx.x, + gridDim.x, ...; the
  // tile index runs over rows of L fastest.  Ring positions count k-steps
  // across tiles, so the producer runs ahead into the next tile while the
  // consumers store the last one.
  const int n_m = (L + BM - 1) / BM;
  const int n_tiles = n_m * ((d + BN - 1) / BN);
  const int nk = (h + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::);
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile % n_m) * BM, n0 = (tile / n_m) * BN;
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
          const uint32_t bar = full + 8 * st;
          const uint32_t s0 = ring + st * STAGE_BYTES;
          const int k0 = ks * BK;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(s0, &tm_dy, k0, m0, bar);
          tma_load(s0 + A_BYTES, &tm_a, k0, m0, bar);
          tma_load(s0 + 2 * A_BYTES, &tm_b, k0, m0, bar);
          tma_load(s0 + 3 * A_BYTES, &tm_w1, k0, n0, bar);
          tma_load(s0 + 3 * A_BYTES + B_BYTES, &tm_w2, k0, n0, bar);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::);
  const int cw = wg - 1;                       // consumer warpgroup
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // ldmatrix: lanes 0-7 / 8-15 / 16-23 / 24-31 address rows 0-7 / 8-15 /
  // 0-7 / 8-15 of the warp's 16 rows, at k 0-7 / 0-7 / 8-15 / 8-15.
  const int lrow = cw * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t lrow_off = (uint32_t)lrow * 64;
  const int lswz = (lrow >> 1) & 3;            // the 64-byte swizzle
  uint32_t fa[2][4] = {}, fb[2][4] = {};       // da, db of two k-steps
  float acc[128];
  int it = 0;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile % n_m) * BM, n0 = (tile / n_m) * BN;
    if (m0 + cw * 64 >= L) {
      // rows wholly past L (uniform in the warpgroup): no products, but
      // the ring's stages are released
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int st = it % STAGES;
        mbar_wait(full + 8 * st, (it / STAGES) & 1);
        if (lane == 0) mbar_arrive(empty + 8 * st);
        __syncwarp();
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      const uint32_t s0 = ring + st * STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t off =
            lrow_off + ((uint32_t)((kk * 2 + (lane >> 4)) ^ lswz) << 4);
        uint32_t vdy[4], va[4], vb[4];
        ldmatrix_x4(vdy, s0 + off);
        ldmatrix_x4(va, s0 + A_BYTES + off);
        ldmatrix_x4(vb, s0 + 2 * A_BYTES + off);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          grads_pair(vdy[i], va[i], vb[i], fa[kk][i], fb[kk][i]);
        wgmma_fence();
        wgmma_m64n256k16_rs(acc, fa[kk],
                            desc_sw64(s0 + 3 * A_BYTES + kk * 32));
        wgmma_m64n256k16_rs(acc, fb[kk],
                            desc_sw64(s0 + 3 * A_BYTES + B_BYTES + kk * 32));
        wgmma_commit();
        // the previous k-step's products are done: its fragments may be
        // overwritten, and at a stage boundary its stage is free
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          reg_fence(fa[kk ^ 1][i]);
          reg_fence(fb[kk ^ 1][i]);
        }
        if (kk == 0 && ks > 0) {
          if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
          __syncwarp();
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    __syncwarp();

    // accumulator layout: value 4j + 2i + e is row 16 warp + lane / 4 + 8 i,
    // column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 256 tile
    const int row = m0 + cw * 64 + warp * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      if (col >= d) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row + 8 * i;
        if (r < L)
          *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)r * d + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i],
                                    acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward dw, tensor cores: (x, dy, a, b) -> (dw1, dw2)
// ---------------------------------------------------------------------------

namespace bwdw {
constexpr int BM = 128, BN = 64, STAGES = 4;
constexpr int LDX = BM + 8;   // x chunk: BK rows of BM (d) columns
constexpr int LDY = BN + 8;   // dy / a / b chunks: BK rows of BN (h)
constexpr int LDC = BN + 4;
constexpr int X_TILE = BK * LDX, Y_TILE = BK * LDY;
constexpr int STAGE = X_TILE + 3 * Y_TILE;
constexpr int PIPE = STAGES * STAGE * (int)sizeof(bf16);
constexpr int EPI = BM * LDC * (int)sizeof(float);
constexpr int SMEM = PIPE > EPI ? PIPE : EPI;
}  // namespace bwdw

__global__ void __launch_bounds__(THREADS)
swiglu_bwd_w_wmma(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const bf16* __restrict__ a, const bf16* __restrict__ b,
                  bf16* __restrict__ dw1, bf16* __restrict__ dw2, int L,
                  int d, int h) {
  using namespace nvcuda;
  using namespace bwdw;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;   // rows of d
  const int n0 = blockIdx.y * BN;   // columns of h
  const int nsteps = (L + BK - 1) / BK;

  auto tile = [&](int stage, int which) {   // 0: x, 1-3: dy, a, b
    return ring + stage * STAGE +
           (which == 0 ? 0 : X_TILE + (which - 1) * Y_TILE);
  };
  auto load_stage = [&](int step, int stage) {
    const int r0 = step * BK;
    // x chunk: BK rows x BM/8 pieces, 2 per thread
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int piece = tid + c * THREADS;
      const int row = piece / (BM / 8), col = (piece % (BM / 8)) * 8;
      const int r = r0 + row, gc = m0 + col;
      const bool ok = r < L && gc < d;
      repro::cp_async16(tile(stage, 0) + row * LDX + col,
                        ok ? x + (size_t)r * d + gc : x, ok);
    }
    // dy / a / b chunks: BK rows x BN/8 pieces, 1 per thread each
    const int row = tid / (BN / 8), col = (tid % (BN / 8)) * 8;
    const int r = r0 + row, gc = n0 + col;
    const bool ok = r < L && gc < h;
    const size_t off = (size_t)r * h + gc;
    const int so = row * LDY + col;
    repro::cp_async16(tile(stage, 1) + so, ok ? dy + off : dy, ok);
    repro::cp_async16(tile(stage, 2) + so, ok ? a + off : a, ok);
    repro::cp_async16(tile(stage, 3) + so, ok ? b + off : b, ok);
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // 4 x 2 warps, 32 x 32 each
  const int wn = (warp % 2) * 32;
  AccFrag acc1[2][2], acc2[2][2];
  zero_acc(acc1);
  zero_acc(acc2);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    repro::cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = s + STAGES - 1;
    if (nxt < nsteps) load_stage(nxt, nxt % STAGES);
    repro::cp_async_commit();
    const int st = s % STAGES;
    bf16* DA = tile(st, 1);   // dy, becomes da
    bf16* DB = tile(st, 2);   // a, becomes db
    {  // BK x BN elements: one piece of 8 per thread
      const int so = (tid / (BN / 8)) * LDY + (tid % (BN / 8)) * 8;
      grads8_inplace(DA + so, DB + so, tile(st, 3) + so);
    }
    __syncthreads();
    const bf16* X = tile(st, 0);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // x^T(i, k) = X[k * LDX + i]: the chunk read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], X + kk * LDX + wm + i * 16, LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], DA + kk * LDY + wn + j * 16, LDY);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc1[i][j], fa[i], fb[j], acc1[i][j]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], DB + kk * LDY + wn + j * 16, LDY);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc2[i][j], fa[i], fb[j], acc2[i][j]);
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  stage_acc(Cs, LDC, acc1, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, dw1, h, m0, n0, d, h);
  __syncthreads();
  stage_acc(Cs, LDC, acc2, wm, wn);
  __syncthreads();
  store_tile<BM, BN>(Cs, LDC, dw2, h, m0, n0, d, h);
}

// ---------------------------------------------------------------------------
// general path (float32, or bf16 at any width): float32 FMA on 64 x 64
// output tiles, SBK deep per step, each thread a 4 x 4 sub-tile
// ---------------------------------------------------------------------------

constexpr int SB = 64, SBK = 16;

// rounds a float32 value through T (the TPU kernels' cast of da, db)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return repro::to_f32(repro::from_f32<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(256)
swiglu_fwd_simt(const T* __restrict__ x, const T* __restrict__ w1,
                const T* __restrict__ w2, T* __restrict__ y,
                T* __restrict__ a_out, T* __restrict__ b_out, int L, int d,
                int h) {
  __shared__ float Xs[SBK][SB + 1];
  __shared__ float W1s[SBK][SB + 1];
  __shared__ float W2s[SBK][SB + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * SB, n0 = blockIdx.y * SB;
  float acc1[4][4] = {}, acc2[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += SBK) {
    for (int i = tid; i < SB * SBK; i += 256) {
      const int r = i / SBK, kk = i % SBK;
      const int gr = m0 + r, gk = k0 + kk;
      Xs[kk][r] = (gr < L && gk < d) ? repro::to_f32(x[(size_t)gr * d + gk])
                                     : 0.f;
    }
    for (int i = tid; i < SBK * SB; i += 256) {
      const int kk = i / SB, c = i % SB;
      const int gk = k0 + kk, gc = n0 + c;
      const bool ok = gk < d && gc < h;
      const size_t off = (size_t)gk * h + gc;
      W1s[kk][c] = ok ? repro::to_f32(w1[off]) : 0.f;
      W2s[kk][c] = ok ? repro::to_f32(w2[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float xv[4], b1[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = W1s[kk][tx * 4 + j];
        b2[j] = W2s[kk][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] = fmaf(xv[i], b1[j], acc1[i][j]);
          acc2[i][j] = fmaf(xv[i], b2[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty * 4 + i, gc = n0 + tx * 4 + j;
      if (gr >= L || gc >= h) continue;
      const size_t o = (size_t)gr * h + gc;
      const float av = acc1[i][j], bv = acc2[i][j];
      a_out[o] = repro::from_f32<T>(av);
      b_out[o] = repro::from_f32<T>(bv);
      y[o] = repro::from_f32<T>((av * sigmoid_<false>(av)) * bv);
    }
}

template <typename T>
__global__ void __launch_bounds__(256)
swiglu_bwd_x_simt(const T* __restrict__ dy, const T* __restrict__ a,
                  const T* __restrict__ b, const T* __restrict__ w1,
                  const T* __restrict__ w2, T* __restrict__ dx, int L, int d,
                  int h) {
  __shared__ float DAs[SBK][SB + 1];   // (k of h, row)
  __shared__ float DBs[SBK][SB + 1];
  __shared__ float W1s[SBK][SB + 1];   // w1^T: (k of h, column of d)
  __shared__ float W2s[SBK][SB + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * SB, n0 = blockIdx.y * SB;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < h; k0 += SBK) {
    for (int i = tid; i < SB * SBK; i += 256) {
      const int r = i / SBK, kk = i % SBK;
      const int gr = m0 + r, gk = k0 + kk;
      float da = 0.f, db = 0.f;
      if (gr < L && gk < h) {
        const size_t o = (size_t)gr * h + gk;
        swiglu_grads<false>(repro::to_f32(dy[o]), repro::to_f32(a[o]),
                            repro::to_f32(b[o]), da, db);
      }
      DAs[kk][r] = round_to<T>(da);
      DBs[kk][r] = round_to<T>(db);
    }
    for (int i = tid; i < SBK * SB; i += 256) {
      // consecutive threads walk k, the weights' contiguous (h) axis
      const int kk = i % SBK, c = i / SBK;
      const int gk = k0 + kk, gc = n0 + c;
      const bool ok = gk < h && gc < d;
      const size_t off = (size_t)gc * h + gk;
      W1s[kk][c] = ok ? repro::to_f32(w1[off]) : 0.f;
      W2s[kk][c] = ok ? repro::to_f32(w2[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float va[4], vb[4], b1[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        va[i] = DAs[kk][ty * 4 + i];
        vb[i] = DBs[kk][ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = W1s[kk][tx * 4 + j];
        b2[j] = W2s[kk][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(vb[i], b2[j], fmaf(va[i], b1[j], acc[i][j]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty * 4 + i, gc = n0 + tx * 4 + j;
      if (gr < L && gc < d)
        dx[(size_t)gr * d + gc] = repro::from_f32<T>(acc[i][j]);
    }
}

template <typename T>
__global__ void __launch_bounds__(256)
swiglu_bwd_w_simt(const T* __restrict__ x, const T* __restrict__ dy,
                  const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ dw1, T* __restrict__ dw2, int L, int d,
                  int h) {
  __shared__ float Xs[SBK][SB + 1];    // (row of L, column of d)
  __shared__ float DAs[SBK][SB + 1];   // (row of L, column of h)
  __shared__ float DBs[SBK][SB + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * SB, n0 = blockIdx.y * SB;
  float acc1[4][4] = {}, acc2[4][4] = {};
  for (int r0 = 0; r0 < L; r0 += SBK) {
    for (int i = tid; i < SBK * SB; i += 256) {
      const int kr = i / SB, c = i % SB;
      const int r = r0 + kr;
      const int gd = m0 + c, gh = n0 + c;
      Xs[kr][c] = (r < L && gd < d) ? repro::to_f32(x[(size_t)r * d + gd])
                                    : 0.f;
      float da = 0.f, db = 0.f;
      if (r < L && gh < h) {
        const size_t o = (size_t)r * h + gh;
        swiglu_grads<false>(repro::to_f32(dy[o]), repro::to_f32(a[o]),
                            repro::to_f32(b[o]), da, db);
      }
      DAs[kr][c] = round_to<T>(da);
      DBs[kr][c] = round_to<T>(db);
    }
    __syncthreads();
#pragma unroll
    for (int kr = 0; kr < SBK; ++kr) {
      float xv[4], va[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[kr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        va[j] = DAs[kr][tx * 4 + j];
        vb[j] = DBs[kr][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] = fmaf(xv[i], va[j], acc1[i][j]);
          acc2[i][j] = fmaf(xv[i], vb[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gd = m0 + ty * 4 + i, gh = n0 + tx * 4 + j;
      if (gd >= d || gh >= h) continue;
      const size_t o = (size_t)gd * h + gh;
      dw1[o] = repro::from_f32<T>(acc1[i][j]);
      dw2[o] = repro::from_f32<T>(acc2[i][j]);
    }
}

// The tensor-core kernels' rings need more than the default 48 KB of
// dynamic shared memory.
template <typename K>
void allow_smem(K kernel, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
}

// cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPoint (the library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix read in (box_rows x box_cols) boxes
// with the 64-byte swizzle; out-of-bounds elements read as zeros.
bool tensor_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
                   int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device (one persistent bwd_x block each).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

bool vec_ok(int dtype, int d, int h, std::initializer_list<const void*> ps) {
  if (dtype != REPRO_DTYPE_BF16 || d % 8 != 0 || h % 8 != 0) return false;
  for (const void* p : ps)
    if (!repro::aligned16(p)) return false;
  return true;
}

dim3 grid2(int rows, int bm, int cols, int bn) {
  return dim3((rows + bm - 1) / bm, (cols + bn - 1) / bn);
}

}  // namespace

// x: (L, d); w1, w2: (d, h); y, a, b: (L, h); all of one dtype.
REPRO_API int repro_fused_swiglu_fwd(int dtype, const void* x, const void* w1,
                                     const void* w2, void* y, void* a, void* b,
                                     int L, int d, int h,
                                     cudaStream_t stream) {
  if (L <= 0 || h <= 0) return 0;
  if (d < 0) return (int)cudaErrorInvalidValue;
  if (vec_ok(dtype, d, h, {x, w1, w2, y, a, b})) {
    const dim3 grid = grid2(L, fwd::BM, h, fwd::BN);
    auto kernel = L <= fwd::BM ? swiglu_fwd_wmma<true> : swiglu_fwd_wmma<false>;
    allow_smem(kernel, fwd::SMEM);
    kernel<<<grid, THREADS, fwd::SMEM, stream>>>(
        (const bf16*)x, (const bf16*)w1, (const bf16*)w2, (bf16*)y, (bf16*)a,
        (bf16*)b, L, d, h);
  } else if (dtype == REPRO_DTYPE_BF16) {
    swiglu_fwd_simt<bf16><<<grid2(L, SB, h, SB), 256, 0, stream>>>(
        (const bf16*)x, (const bf16*)w1, (const bf16*)w2, (bf16*)y, (bf16*)a,
        (bf16*)b, L, d, h);
  } else if (dtype == REPRO_DTYPE_F32) {
    swiglu_fwd_simt<float><<<grid2(L, SB, h, SB), 256, 0, stream>>>(
        (const float*)x, (const float*)w1, (const float*)w2, (float*)y,
        (float*)a, (float*)b, L, d, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dy, a, b: (L, h); w1, w2: (d, h); dx: (L, d); all of one dtype.
REPRO_API int repro_fused_swiglu_bwd_x(int dtype, const void* dy, const void* a,
                                       const void* b, const void* w1,
                                       const void* w2, void* dx, int L, int d,
                                       int h, cudaStream_t stream) {
  if (L <= 0 || d <= 0) return 0;
  if (h < 0) return (int)cudaErrorInvalidValue;
  if (vec_ok(dtype, d, h, {dy, a, b, w1, w2, dx})) {
    if (h == 0) return (int)cudaMemsetAsync(dx, 0, (size_t)L * d * 2, stream);
    CUtensorMap maps[5];
    const void* src[5] = {dy, a, b, w1, w2};
    for (int i = 0; i < 5; ++i) {
      const bool act = i < 3;   // (L, h) activations, else (d, h) weights
      if (!tensor_map_2d(&maps[i], src[i], act ? L : d, h,
                         act ? bwdx::BM : bwdx::BN, BK))
        return (int)cudaErrorInvalidValue;
    }
    allow_smem(swiglu_bwd_x_wgmma, bwdx::SMEM);
    const int n_tiles = ((L + bwdx::BM - 1) / bwdx::BM) *
                        ((d + bwdx::BN - 1) / bwdx::BN);
    const int n_sm = sm_count();
    if (n_sm <= 0) return (int)cudaErrorInvalidDevice;
    swiglu_bwd_x_wgmma<<<n_tiles < n_sm ? n_tiles : n_sm, bwdx::THREADS,
                         bwdx::SMEM, stream>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], (bf16*)dx, L, d, h);
  } else if (dtype == REPRO_DTYPE_BF16) {
    swiglu_bwd_x_simt<bf16><<<grid2(L, SB, d, SB), 256, 0, stream>>>(
        (const bf16*)dy, (const bf16*)a, (const bf16*)b, (const bf16*)w1,
        (const bf16*)w2, (bf16*)dx, L, d, h);
  } else if (dtype == REPRO_DTYPE_F32) {
    swiglu_bwd_x_simt<float><<<grid2(L, SB, d, SB), 256, 0, stream>>>(
        (const float*)dy, (const float*)a, (const float*)b, (const float*)w1,
        (const float*)w2, (float*)dx, L, d, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: (L, d); dy, a, b: (L, h); dw1, dw2: (d, h); all of one dtype.  L may
// be 0 (the gradients are then zeros).
REPRO_API int repro_fused_swiglu_bwd_w(int dtype, const void* x, const void* dy,
                                       const void* a, const void* b, void* dw1,
                                       void* dw2, int L, int d, int h,
                                       cudaStream_t stream) {
  if (d <= 0 || h <= 0) return 0;
  if (L < 0) return (int)cudaErrorInvalidValue;
  if (vec_ok(dtype, d, h, {x, dy, a, b, dw1, dw2})) {
    allow_smem(swiglu_bwd_w_wmma, bwdw::SMEM);
    swiglu_bwd_w_wmma<<<grid2(d, bwdw::BM, h, bwdw::BN), THREADS, bwdw::SMEM,
                        stream>>>((const bf16*)x, (const bf16*)dy,
                                  (const bf16*)a, (const bf16*)b, (bf16*)dw1,
                                  (bf16*)dw2, L, d, h);
  } else if (dtype == REPRO_DTYPE_BF16) {
    swiglu_bwd_w_simt<bf16><<<grid2(d, SB, h, SB), 256, 0, stream>>>(
        (const bf16*)x, (const bf16*)dy, (const bf16*)a, (const bf16*)b,
        (bf16*)dw1, (bf16*)dw2, L, d, h);
  } else if (dtype == REPRO_DTYPE_F32) {
    swiglu_bwd_w_simt<float><<<grid2(d, SB, h, SB), 256, 0, stream>>>(
        (const float*)x, (const float*)dy, (const float*)a, (const float*)b,
        (float*)dw1, (float*)dw2, L, d, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
