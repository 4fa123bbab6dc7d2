// Blocked norm-aggregation kernels for Hopper (sm_90a): the giant-n tier,
// where the m bucketed worker rows (m > 64, unbounded) no longer fit in the
// fused kernels' blocks.
//
// Replace the TPU kernels of repro/kernels/norm_agg.py:
//   pair_gram_blocked     (m, m) Gram G = x x^T          (Krum's distances)
//   sqdist_to_blocked     sq_i = |x_i - z|^2             (RFA's distances)
//   weighted_sum_blocked  out = sum_i w_i x_i            (RFA's z, Krum's
//                                                         winner)
// Inputs are dense (m, d) float32 stacks, row-major, with the attack and
// the bucketing already applied (the tier does both in plain PyTorch first).
// Offsets are 64-bit: at m = 1024, d = 2^20 the stack holds 2^30 elements.
//
// On the TPU each kernel accumulates into a revisited output block along a
// sequential grid axis. Blocks on the card run in any order; every kernel
// here is one launch, and where d is split into chunks across blocks, the
// last block of a unit to finish adds the chunks' partials in a fixed order
// in the same launch (blocks_finish, finish.cuh, with tickets in a buffer
// the wrapper keeps for each stream). No floating-point atomics: a call
// repeats bit for bit.
//
// pair_gram_blocked. Bound: tensor-core operations, 3 m(m+1) d at the TF32
//   rate for the upper triangle (the stack's bytes where m is one row tile).
//   The product runs on the tensor cores in split float32: each value x =
//   hi+lo with hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
//   (cvt.rna), and x y is taken as hi hi + hi lo + lo hi, the two small terms
//   first, each product accumulated in float32. That keeps float32's own
//   error, where one TF32 product misses 1e-5 of the largest entry. A block
//   of two consumer warpgroups and a producer warpgroup owns one 128 x 128
//   output tile (ti <= tj) of one chunk of columns. The producer keeps (128
//   rows x 32 columns) raw slabs of both row tiles in flight in a ring of
//   four, under the 128-byte swizzle: TMA loads where x and d allow a tensor
//   map, else asynchronous copies of one float a lane and row. The consumers
//   split each slab in place into hi and a lo buffer, and each warpgroup
//   issues wgmma.m64n128k8 (TF32, both operands K-major from shared memory)
//   for its 64 rows, one slab's products in flight while the next slab is
//   split. A diagonal tile loads its rows once, and its lower warpgroup
//   multiplies the 64 columns right of the diagonal alone (m64n64k8). What
//   bounds it in practice is the slabs' traffic from L2 (each row tile is
//   read by every pair it is in) and shared memory: each slab of an off-
//   diagonal pair moves some 270 KB through it (the slabs, the split, the
//   operand reads of 24 products). The running sums restart every 128 columns
//   and fold into a second float32 accumulator (__fadd_rn): the tensor cores'
//   accumulation truncates, and over the reference's 2048-column tile the
//   diagonal came out 2e-5 low. When the tile pairs are too few to fill the
//   card, d is split into chunks of whole column tiles (grid y), the last
//   chunk block of a pair adding them. Only entries i <= j are results,
//   written to both (i, j) and (j, i) from shared memory, two coalesced
//   passes, so G is symmetric bit for bit, as Krum's tie rule needs (inside a
//   diagonal tile the (j, i) product takes hi lo and lo hi in the other
//   order: it is not computed).
// sqdist_to_blocked. Bound: bytes (the stack read once). One warp per row
//   and chunk of columns, float4 loads where d allows (four in flight a
//   lane), a fixed lane order and a fixed shuffle tree. A grid of one chunk
//   (the main path's narrow leaves) writes the row sums at once; at full
//   width the chunks give some ten waves of blocks (the last, partial wave
//   costs little), their partials added in chunk order by the last blocks
//   of a row block.
// weighted_sum_blocked. Bound: bytes (the stack read once). Each column is
//   the reference's order bit for bit: a worker tile of 64 rows (the last
//   one short) summed as its compiled float32 code sums it on the CPU (the
//   rounded products of two windows of 32 rows, each in order, then the two
//   window sums added), the tiles added in tile order from 0. One launch, a
//   block for each group of 128 columns (32 where d or the alignment does
//   not allow 16-byte loads), a lane 4 columns (or 1) read with one 16-byte
//   load a row, eight (or 32) rows' loads issued before their first add.
//   The eight warps of a block sum eight consecutive worker tiles of the
//   group at once (with fewer tiles, a block takes two to four groups and
//   their tiles at once), so that a narrow stack or one of many rows still
//   fills the card, and a thread a column adds their sums in tile order
//   from shared memory: no workspace in device memory, no second pass.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached
                   // through the runtime, so no driver library is linked
#include <cuda_runtime.h>

#include <cstdint>

#include "finish.cuh"

namespace {

constexpr int GT = 128;          // Gram output tile: rows and columns
constexpr int GK = 32;           // columns of a slab: one 128-byte row
constexpr int SLAB = GT * GK;    // floats of one row tile's slab (16 KB)
constexpr int G_RING = 4;        // raw slabs of each row tile in flight
constexpr int G_LO = 3;          // lo buffers (see the consumer loop)
constexpr int G_FOLD = 4;        // slabs (128 columns) between folds
constexpr int G_CONSUMERS = 256; // two warpgroups, 64 tile rows each
// and a producer warpgroup: 12 warps, three on each SM sub-partition, as
// with one producer warp, so no register is lost to it
constexpr int G_THREADS = G_CONSUMERS + 128;
// row strides of the finished tile (G_PART: also a chunk's partial) and
// of its transpose (G_FT), so that the fragments' stores (float2 and
// scalar) and the output passes' float4 reads meet no bank conflict
constexpr int G_PART = GT + 8;
constexpr int G_FT = GT + 4;
// the ring and the lo buffers, both row tiles each, then the barriers;
// 1024 bytes of slack to align the swizzled slabs
constexpr int G_SMEM_BYTES =
    (G_RING + G_LO) * 2 * SLAB * 4 + 2 * G_RING * 8 + 1024;
constexpr int SQ_WARPS = 8;   // rows per sqdist block, one warp each
constexpr int WS_WARPS = 8;   // worker tiles of the weighted sum at once
constexpr int WS_THREADS = WS_WARPS * 32;
constexpr int WS_TILE = 64;   // worker tile of the weighted sum
constexpr int WS_WINDOW = 32; // rows summed in order within a tile

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (ti, tj), ti <= tj, of the p-th tile pair of the row-major upper
// triangle of nt x nt tiles.
__device__ inline void tile_pair(int p, int nt, int* ti, int* tj) {
  int r = p, a = 0;
  while (r >= nt - a) {
    r -= nt - a;
    ++a;
  }
  *ti = a;
  *tj = a + r;
}

// --- Hopper primitives: shared-memory barriers, TMA, wgmma ---------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// Arrive on `bar` where `pred` holds (a predicate inside the instruction:
// no branch around it while products are in flight).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}

// Wait for the phase of `bar` of this parity to complete. The polling loop
// stays inside the asm, so that the compiler sees no divergent path where
// products are in flight (it would serialize the wgmma instructions).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Rows [row, row + 128) x columns [col, col + 32) of the tensor map's
// (m, d) stack into a swizzled slab (rows past m and columns past d
// zero-filled); completion counts on `bar`.
__device__ __forceinline__ void tma_slab(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// One float from src into shared memory at dst (zero where `ok` fails)
// as an asynchronous copy of the issuing thread.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// `bar` counts one arrival of this thread when its asynchronous copies so
// far have landed (the arrival is one of those set at init).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Shared-memory writes of the generic proxy made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The two consumer warpgroups meet (named barrier 1; the producer keeps
// going).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(G_CONSUMERS) : "memory");
}

// The float offset of (row, col), col < 32, in a slab of 128-byte rows
// under the 128-byte swizzle that TMA writes and wgmma reads: the 16-byte
// group of a row XOR the row's index mod 8 (the slab 1024-byte aligned).
__device__ __forceinline__ int swz(int row, int col) {
  return row * GK + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds it: half of the 13 dropped bits added to the
// magnitude, then cleared (an infinity stays one; a NaN stays NaN or, for
// a payload in the dropped bits alone, becomes an infinity, and its lo
// NaN). Two integer operations: 5% faster than the conversion at
// m = 1024, d = 2^20 (an H100).
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x = hi + lo to about 2^-22 of x: hi = tf32(x), lo = tf32(x - hi) (the
// difference is exact in float32).
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, hi));
}

// wgmma descriptor of a K-major operand at p in a 128-byte-swizzled slab:
// the start address (>> 4), the leading offset unused under a swizzle (1),
// 1024 bytes between groups of 8 rows, the 128-byte swizzle. Eight columns
// further along K (32 bytes) is p + 8.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
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

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous products' fences and waits.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, the warpgroup's fragment) = A (64 x 8) B^T (128 x 8) + d
// (+ 0 where `acc` is 0), TF32 operands from shared memory, float32
// accumulation.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(a), "l"(b), "r"(acc));
}

// The first 32 registers of d (64 x 64) = A (64 x 8) B^T (64 x 8) + d.
__device__ __forceinline__ void wgmma_n64(float (&d)[64], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(a), "l"(b), "r"(acc));
}

#undef ACC8

// Row and column (within the warpgroup's 64 x N block) of accumulator
// register i of thread `t` (0..127) of a warpgroup: warp t / 32 owns rows
// 16 (t / 32) + [0, 16); each 8-column group takes four registers.
__device__ __forceinline__ int frag_row(int t, int i) {
  return ((t >> 5) << 4) + ((t & 31) >> 2) + (((i >> 1) & 1) << 3);
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return ((i >> 2) << 3) + ((t & 3) << 1) + (i & 1);
}

// --- pair_gram_blocked ----------------------------------------------------

// The dynamic shared memory of a Gram block: the raw slab ring (split in
// place into hi), G_RING x (tile a, tile b); the lo buffers, G_LO x (a, b);
// the ring's barriers (full: the slab has landed; empty: both warpgroups'
// products of it are done).
struct GramSmem {
  float* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ float* hi(int s, int t) const {
    return base + ((s % G_RING) * 2 + t) * SLAB;
  }
  __device__ float* lo(int s, int t) const {
    return base + ((G_RING + s % G_LO) * 2 + t) * SLAB;
  }
};

// One warpgroup's half (rows [64 g, 64 g + 64)) of a raw slab split in
// place: hi over the raw values, lo into `lo` at the same offsets (the
// swizzle is the same for both).
__device__ __forceinline__ void split_half(float* hi, float* lo, int g,
                                           int t) {
  float4* h4 = reinterpret_cast<float4*>(hi + g * (SLAB / 2));
  float4* l4 = reinterpret_cast<float4*>(lo + g * (SLAB / 2));
  float4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = h4[t + 128 * i];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 h, l;
    split_tf32(v[i].x, h.x, l.x);
    split_tf32(v[i].y, h.y, l.y);
    split_tf32(v[i].z, h.z, l.z);
    split_tf32(v[i].w, h.w, l.w);
    h4[t + 128 * i] = h;
    l4[t + 128 * i] = l;
  }
}

// One block: the 128 x 128 tile pair blockIdx.x of an nt x nt grid of row
// tiles over the columns of chunk blockIdx.y, [k0, k1). The producer
// fills the ring: with TMA by the tensor map `map` (x 16-byte aligned, d a
// multiple of 4), else with asynchronous copies of one float a lane and
// row, into the same swizzled layout.
//
// Consumer loop, slab s: both warpgroups have split s (barrier); each
// issues its products of s, splits s + 1 while they run, waits for its
// products of s - 1 (of s too at a fold) and hands slab s - 1 back to the
// producer. A warpgroup may run one slab ahead of the other, so the lo
// buffer it writes for s + 1 must not be one that the other's products of
// s - 1 or s may still read: three lo buffers. The running sums restart
// every G_FOLD slabs: the tensor cores' float32 accumulation truncates, so
// over the reference's 2048-column tile (768 products into one sum) the
// diagonal came out 2e-5 low on an H100; over 128 columns the error is
// about 1e-6 of the largest entry, and the folds, __fadd_rn on the CUDA
// cores, round to nearest.
template <bool TMA>
__global__ void __launch_bounds__(G_THREADS, 1) pair_gram_blocked_kernel(
    const __grid_constant__ CUtensorMap map, const float* __restrict__ x,
    long long m, long long d, long long cols, int nt,
    float* __restrict__ part, float* __restrict__ out,
    unsigned* __restrict__ tickets) {
  extern __shared__ unsigned char g_smem[];
  GramSmem sm;
  sm.base = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(g_smem) + 1023) & ~uintptr_t(1023));
  sm.full = reinterpret_cast<uint64_t*>(sm.base + (G_RING + G_LO) * 2 * SLAB);
  sm.empty = sm.full + G_RING;
  int ti, tj;
  tile_pair(blockIdx.x, nt, &ti, &tj);
  const bool diag = ti == tj;
  const long long ra = (long long)ti * GT, rb = (long long)tj * GT;
  const long long k0 = (long long)blockIdx.y * cols;
  const long long k1 = k0 + cols < d ? k0 + cols : d;
  const int ns = (int)((k1 - k0 + GK - 1) / GK);
  const int tid = threadIdx.x, t = tid & 127;
  // the warpgroup (2: the producer's), uniform across each warp as the
  // compiler sees it (a branch on tid alone would look divergent and
  // serialize the products)
  const int g = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (tid == 0) {
    for (int s = 0; s < G_RING; ++s) {
      mbar_init(&sm.full[s], TMA ? 1 : 128);
      mbar_init(&sm.empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float fold[64];
  if (g == 2) {  // the producer warpgroup
    const int lane = tid & 31, pw = (tid >> 5) & 3;
    for (int s = 0; s < ns; ++s) {
      uint64_t* full = &sm.full[s % G_RING];
      if (s >= G_RING) mbar_wait(&sm.empty[s % G_RING], (s / G_RING - 1) & 1);
      const long long c = k0 + (long long)s * GK;
      if (TMA) {
        if (t == 0) {
          mbar_expect_tx(full, (diag ? 1 : 2) * SLAB * 4);
          tma_slab(sm.hi(s, 0), &map, full, (int)c, (int)ra);
          if (!diag) tma_slab(sm.hi(s, 1), &map, full, (int)c, (int)rb);
        }
      } else {  // a lane a column, warp pw rows pw + 4 i of both tiles
        const bool col_ok = c + lane < k1;
        for (int u = 0; u < (diag ? 1 : 2); ++u) {
          const long long r0 = (u ? rb : ra) + pw;
          const float* src = x + r0 * d + c + lane;
          float* dst = sm.hi(s, u) + pw * GK + (lane & 3);
#pragma unroll 8
          for (int i = 0; i < GT / 4; ++i) {
            // row pw + 4 i: its 16-byte group (lane / 4) XOR the row mod 8
            const int sw = (((lane >> 2) ^ (pw + 4 * i)) & 7) << 2;
            const bool ok = col_ok && r0 + 4 * i < m;
            cp_async_f32(dst + 4 * i * GK + sw, ok ? src : x, ok);
            src += 4 * d;
          }
        }
        cp_async_arrive(full);
      }
    }
    __syncwarp();
  } else {
    // rows [64, 128) of a diagonal tile: only the 64 columns right of the
    // diagonal hold results
    const bool half = diag && g == 1;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = fold[i] = 0.f;
    auto prep = [&](int s) {
      mbar_wait(&sm.full[s % G_RING], (s / G_RING) & 1);
      split_half(sm.hi(s, 0), sm.lo(s, 0), g, t);
      if (!diag) split_half(sm.hi(s, 1), sm.lo(s, 1), g, t);
      fence_async_smem();
    };
    prep(0);
    for (int s = 0; s < ns; ++s) {
      consumers_sync();
      const int tb = diag ? 0 : 1;
      const float* ha = sm.hi(s, 0) + g * (SLAB / 2);
      const float* la = sm.lo(s, 0) + g * (SLAB / 2);
      const float* hb = sm.hi(s, tb) + (half ? SLAB / 2 : 0);
      const float* lb = sm.lo(s, tb) + (half ? SLAB / 2 : 0);
      // the first product of a run overwrites the sums the last fold took
      const int keep = s % G_FOLD != 0;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < GK; k += 8) {
        if (half) {
          wgmma_n64(acc, wgmma_desc(ha + k), wgmma_desc(lb + k),
                    k ? 1 : keep);
          wgmma_n64(acc, wgmma_desc(la + k), wgmma_desc(hb + k), 1);
          wgmma_n64(acc, wgmma_desc(ha + k), wgmma_desc(hb + k), 1);
        } else {
          wgmma_n128(acc, wgmma_desc(ha + k), wgmma_desc(lb + k),
                     k ? 1 : keep);
          wgmma_n128(acc, wgmma_desc(la + k), wgmma_desc(hb + k), 1);
          wgmma_n128(acc, wgmma_desc(ha + k), wgmma_desc(hb + k), 1);
        }
      }
      wgmma_commit();
      if (s + 1 < ns) prep(s + 1);
      const bool at_fold = (s + 1) % G_FOLD == 0 || s + 1 == ns;
      if (at_fold)
        wgmma_wait<0>();
      else
        wgmma_wait<1>();
      pin(acc);
      mbar_arrive_if(&sm.empty[(s + G_RING - 1) % G_RING], s > 0 && t == 0);
      if (at_fold) {
#pragma unroll
        for (int i = 0; i < 64; ++i) fold[i] = __fadd_rn(fold[i], acc[i]);
      }
    }
  }
  __syncthreads();
  // The block's tile, row-major into s_fin and, for one chunk, transposed
  // into s_fint; a chunk's tile goes through the finish, whose last block
  // writes the sums into both.
  float* s_fin = sm.base;
  float* s_fint = sm.base + GT * G_PART;
  const int chunks = gridDim.y;
  if (g < 2) {
    const int cb = diag && g == 1 ? 64 : 0;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = 64 * g + frag_row(t, i), c = (cb + frag_col(t, i)) & 127;
      *reinterpret_cast<float2*>(s_fin + r * G_PART + c) =
          make_float2(fold[i], fold[i + 1]);
      if (chunks == 1) {
        s_fint[c * G_FT + r] = fold[i];
        s_fint[(c + 1) * G_FT + r] = fold[i + 1];
      }
    }
  }
  __syncthreads();
  if (chunks > 1) {
    const int groups = finish_groups(chunks);
    if (!blocks_finish(
            s_fin, GT * G_PART,
            part + (long long)blockIdx.x * (chunks + groups) * GT * G_PART,
            tickets + (long long)blockIdx.x * (groups + 1), blockIdx.y,
            chunks, [=](int q, float v) {
              const int r = q / G_PART, c = q % G_PART;
              s_fin[q] = v;
              if (c < GT) s_fint[c * G_FT + r] = v;
            }))
      return;
    __syncthreads();
  }
  // G[i][j] for i <= j from s_fin, a warp a row of G; then G[j][i] from
  // s_fint, the same entries: every row of G written whole, float4 stores
  // where m and out allow them
  const int warp = tid >> 5, e0 = 4 * (tid & 31);
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int rows = m - ra < GT ? (int)(m - ra) : GT;
  const int cols_in = m - rb < GT ? (int)(m - rb) : GT;
  for (int pass = 0; pass < 2; ++pass) {
    for (int l = warp; l < (pass ? cols_in : rows); l += G_THREADS / 32) {
      // pass 0: entries (l, e) to G[ra + l][rb + e]; pass 1: entries
      // (e, l) to G[rb + l][ra + e]; in a diagonal tile e >= l, e <= l
      const int lo = !pass && diag ? l : 0;
      const int hi = !pass ? cols_in : diag && l + 1 < rows ? l + 1 : rows;
      const float4 v = *reinterpret_cast<const float4*>(
          pass ? s_fint + l * G_FT + e0 : s_fin + l * G_PART + e0);
      float* line = pass ? out + (rb + l) * m + ra : out + (ra + l) * m + rb;
      if (vec && lo <= e0 && e0 + 4 <= hi) {
        *reinterpret_cast<float4*>(line + e0) = v;
      } else {
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (lo <= e0 + k && e0 + k < hi) line[e0 + k] = w[k];
      }
    }
  }
}

// A check of the product alone: one warpgroup, out (64, 128) = a (64, k)
// b (128, k)^T for k = 8 ksteps (at most 32), a and b float32 that the
// tensor cores read as TF32, through the swizzled slabs, the descriptors
// and the fragment layout of the Gram kernel.
__global__ void __launch_bounds__(128) tf32_tile_kernel(
    const float* __restrict__ a, const float* __restrict__ b, int ksteps,
    float* __restrict__ out) {
  __shared__ __align__(1024) float sa[64 * GK];
  __shared__ __align__(1024) float sb[GT * GK];
  const int t = threadIdx.x, k = 8 * ksteps;
  for (int q = t; q < GT * GK; q += 128) {
    const int r = q / GK, c = q % GK;
    if (r < 64) sa[swz(r, c)] = c < k ? a[r * k + c] : 0.f;
    sb[swz(r, c)] = c < k ? b[r * k + c] : 0.f;
  }
  fence_async_smem();
  __syncthreads();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  pin(acc);
  wgmma_fence();
  for (int s = 0; s < ksteps; ++s)
    wgmma_n128(acc, wgmma_desc(sa + 8 * s), wgmma_desc(sb + 8 * s), 1);
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    out[frag_row(t, i) * GT + frag_col(t, i)] = acc[i];
}

// --- sqdist_to_blocked ----------------------------------------------------

// Rows [8 blockIdx.x, + 8) over the columns of chunk blockIdx.y; each row
// block's chunks are one finish unit.
template <bool VEC4>
__global__ void __launch_bounds__(SQ_WARPS * 32) sqdist_to_blocked_kernel(
    const float* __restrict__ x, const float* __restrict__ z, long long m,
    long long d, long long cols, float* __restrict__ part,
    float* __restrict__ out, unsigned* __restrict__ tickets) {
  __shared__ float s_part[SQ_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * SQ_WARPS + warp;
  const long long k0 = (long long)blockIdx.y * cols;
  const long long k1 = k0 + cols < d ? k0 + cols : d;
  float acc = 0.f;
  if (row < m) {
    const float* xr = x + row * d;
    if (VEC4) {  // x and z 16-byte aligned, d and cols multiples of 4
#pragma unroll 4
      for (long long c = k0 + lane * 4; c < k1; c += 128) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(xr + c));
        const float4 w = __ldg(reinterpret_cast<const float4*>(z + c));
        float e = __fsub_rn(v.x, w.x);
        acc = __fmaf_rn(e, e, acc);
        e = __fsub_rn(v.y, w.y);
        acc = __fmaf_rn(e, e, acc);
        e = __fsub_rn(v.z, w.z);
        acc = __fmaf_rn(e, e, acc);
        e = __fsub_rn(v.w, w.w);
        acc = __fmaf_rn(e, e, acc);
      }
    } else {
#pragma unroll 4
      for (long long c = k0 + lane; c < k1; c += 32) {
        const float e = __fsub_rn(__ldcs(xr + c), __ldg(z + c));
        acc = __fmaf_rn(e, e, acc);
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) s_part[warp] = acc;
  __syncthreads();
  const int chunks = gridDim.y, groups = finish_groups(chunks);
  float* upart =
      chunks > 1 ? part + (long long)blockIdx.x * (chunks + groups) * SQ_WARPS
                 : nullptr;
  unsigned* utickets =
      chunks > 1 ? tickets + (long long)blockIdx.x * (groups + 1) : nullptr;
  const long long r0 = (long long)blockIdx.x * SQ_WARPS;
  blocks_finish(s_part, SQ_WARPS, upart, utickets, blockIdx.y, chunks,
                [=](int q, float v) {
                  if (r0 + q < m) out[r0 + q] = v;
                });
}

// --- weighted_sum_blocked -------------------------------------------------

// The V values of a thread at p (V = 4: one 16-byte load, p 16-byte
// aligned); x is read once (evict first).
template <int V>
__device__ __forceinline__ void ws_load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 u = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
    v[0] = __ldcs(p);
  }
}

// Rows [a, b) of a window of a worker tile, added in order into acc: the
// rounded products x_rc w_r of a thread's V columns (p: row a's). Rows go
// in batches of 32 / V, every load of a batch issued before its first add.
template <int V>
__device__ __forceinline__ void window_sum(const float* __restrict__ p,
                                           const float* __restrict__ w,
                                           long long d, long long a,
                                           long long b, float (&acc)[V]) {
  constexpr int B = 32 / V;
  long long r = a;
  for (; r + B <= b; r += B, p += B * d) {
    float v[B][V];
#pragma unroll
    for (int j = 0; j < B; ++j) ws_load<V>(p + j * d, v[j]);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const float wr = __ldg(w + r + j);
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(v[j][k], wr));
    }
  }
  for (; r < b; ++r, p += d) {
    float v[V];
    ws_load<V>(p, v);
    const float wr = __ldg(w + r);
#pragma unroll
    for (int k = 0; k < V; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k], wr));
  }
}

// Warps of a block that take a column group's worker tiles at once: the
// least power of two not below the tiles, at most WS_WARPS; the block takes
// WS_WARPS / that many column groups.
__host__ __device__ inline int ws_tile_warps(long long tiles) {
  int tw = WS_WARPS;
  while (tw > 1 && tw / 2 >= tiles) tw /= 2;
  return tw;
}

// A block takes cg = WS_WARPS / tw groups of 32 V columns: a lane owns V
// consecutive columns (4 where x is 16-byte aligned and d a multiple of 4,
// else 1), and the tw warps of a group take its
// worker tiles in batches, warp j tile t0 + j of the batch at t0: its sum
// as the reference's compiled float32 code takes it (the rounded products
// of rows [r0, r0 + 32) added in order, those of the rest of the tile in
// order, then the two window sums added; the zero-padded rows of its last
// tile add +0 to sums that start at +0), into shared memory. Then a thread
// a column adds the batch's sums in tile order onto its running sum, from
// 0 (a block of one group, tw = WS_WARPS, which may take many batches), or
// sums every tile at once (several groups: their tiles are one batch).
// Every sum in the reference's order; no workspace.
template <int V>
__global__ void __launch_bounds__(WS_THREADS) weighted_sum_blocked_kernel(
    const float* __restrict__ x, const float* __restrict__ w, long long m,
    long long d, float* __restrict__ out) {
  constexpr int GROUP = 32 * V;
  __shared__ __align__(16) float s_ts[WS_WARPS][GROUP];
  const long long tiles = (m + WS_TILE - 1) / WS_TILE;
  const int tw = ws_tile_warps(tiles), cg = WS_WARPS / tw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long g0 = (long long)blockIdx.x * cg;      // the first group
  const long long c0 = (g0 + warp / tw) * GROUP + (long long)lane * V;
  const long long col = g0 * GROUP + tid;    // cg == 1: tid < GROUP adds
  float acc = 0.f;
  for (long long t0 = 0; t0 < tiles; t0 += tw) {
    const long long t = t0 + warp % tw;
    if (c0 < d && t < tiles) {
      const long long r0 = t * WS_TILE;
      const long long r1 = r0 + WS_TILE < m ? r0 + WS_TILE : m;
      const long long cut = r0 + WS_WINDOW < r1 ? r0 + WS_WINDOW : r1;
      float lo[V], hi[V];
#pragma unroll
      for (int k = 0; k < V; ++k) lo[k] = hi[k] = 0.f;
      window_sum<V>(x + r0 * d + c0, w, d, r0, cut, lo);
      window_sum<V>(x + cut * d + c0, w, d, cut, r1, hi);
#pragma unroll
      for (int k = 0; k < V; ++k)
        s_ts[warp][lane * V + k] = __fadd_rn(lo[k], hi[k]);
    }
    __syncthreads();
    if (cg == 1) {
      if (tid < GROUP && col < d)
        for (int j = 0; j < tw && t0 + j < tiles; ++j)
          acc = __fadd_rn(acc, s_ts[j][tid]);
    } else {
      for (int cc = tid; cc < cg * GROUP; cc += WS_THREADS) {
        const int q = cc / GROUP, i = cc % GROUP;
        if (g0 * GROUP + cc >= d) break;
        float a = 0.f;
        for (int j = 0; j < tiles; ++j) a = __fadd_rn(a, s_ts[q * tw + j][i]);
        out[g0 * GROUP + cc] = a;
      }
    }
    __syncthreads();
  }
  if (cg == 1 && tid < GROUP && col < d) out[col] = acc;
}


unsigned grid_for(long long items, int threads) {
  return (unsigned)((items + threads - 1) / threads);
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (null where the driver does not offer it).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Dynamic shared memory above 48 KB, set once for each kernel.
template <bool TMA>
cudaError_t gram_smem_attr() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(pair_gram_blocked_kernel<TMA>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           G_SMEM_BYTES);
  done = err == cudaSuccess;
  return err;
}

// Where a unit's chunks need the finish: its tickets and workspace fit.
bool finish_fits(long long units, int chunks) {
  return chunks == 1 ||
         units * (finish_groups(chunks) + 1) <= FINISH_TICKETS;
}

}  // namespace

// The launch entry points enqueue one kernel on `stream` and return
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// or plan they do not take. Where d is split into chunks > 1, a unit (a
// tile pair of the Gram, a row block of 8 rows of the distances) needs
// `part` (units, chunks + ceil(chunks / 16), entries) with entries 128 x 136
// for the Gram and 8 for the distances, and units (ceil(chunks / 16) + 1)
// of `tickets` (finish_tickets(),) uint32, which starts at zero and is left
// at zero; no two launches in flight at once may share it. With one chunk
// neither is read.

// G (m, m) of x (m, d): tile pairs of nt = ceil(m / 128) row tiles,
// `chunks` chunks of `cols` columns (whole column tiles of `tile`, a
// multiple of 128). The tensor map needs x 16-byte aligned and d a
// multiple of 4; otherwise the slabs come by asynchronous copies of one
// float. 10000 + the driver's CUresult where it refuses the tensor map.
extern "C" int pair_gram_blocked_launch(const float* x, long long m,
                                        long long d, int chunks,
                                        long long cols, long long tile,
                                        float* part, float* out,
                                        unsigned* tickets, void* stream) {
  const long long nt = (m + GT - 1) / GT, pairs = nt * (nt + 1) / 2;
  if (m < 1 || d < 1 || d > INT32_MAX || m > INT32_MAX || chunks < 1 ||
      chunks > 65535 || tile < 1 || tile % (G_FOLD * GK) || cols < tile ||
      cols % tile || (chunks - 1) * cols >= d || chunks * cols < d ||
      pairs > INT32_MAX || !finish_fits(pairs, chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)pairs, (unsigned)chunks);
  CUtensorMap map{};
  const bool tma = (uintptr_t)x % 16 == 0 && d % 4 == 0;
  cudaError_t err;
  if (tma) {
    EncodeTiled encode = encode_tiled();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
    const cuuint32_t box[2] = {GK, GT};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult res = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)x, dims, strides,
        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return 10000 + (int)res;
    if ((err = gram_smem_attr<true>())) return (int)err;
    pair_gram_blocked_kernel<true><<<grid, G_THREADS, G_SMEM_BYTES, st>>>(
        map, x, m, d, cols, (int)nt, part, out, tickets);
  } else {
    if ((err = gram_smem_attr<false>())) return (int)err;
    pair_gram_blocked_kernel<false><<<grid, G_THREADS, G_SMEM_BYTES, st>>>(
        map, x, m, d, cols, (int)nt, part, out, tickets);
  }
  return (int)cudaGetLastError();
}

// out (64, 128) = a (64, 8 ksteps) b (128, 8 ksteps)^T on the tensor cores
// (TF32), ksteps in 1..4: the Gram kernel's product checked alone.
extern "C" int tf32_tile_launch(const float* a, const float* b, int ksteps,
                                float* out, void* stream) {
  if (ksteps < 1 || ksteps > GK / 8) return (int)cudaErrorInvalidValue;
  tf32_tile_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(a, b, ksteps, out);
  return (int)cudaGetLastError();
}

// sq (m,) of x (m, d) and z (d,): rows in blocks of 8, `chunks` chunks of
// `cols` columns (a multiple of 128).
extern "C" int sqdist_to_blocked_launch(const float* x, const float* z,
                                        long long m, long long d, int chunks,
                                        long long cols, float* part,
                                        float* out, unsigned* tickets,
                                        void* stream) {
  const long long rows = (m + SQ_WARPS - 1) / SQ_WARPS;
  if (m < 1 || d < 1 || chunks < 1 || chunks > 65535 || cols < 1 ||
      cols % 128 || (chunks - 1) * cols >= d || chunks * cols < d ||
      rows > INT32_MAX || !finish_fits(rows, chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)rows, (unsigned)chunks);
  if (((uintptr_t)x | (uintptr_t)z) % 16 == 0 && d % 4 == 0)
    sqdist_to_blocked_kernel<true><<<grid, SQ_WARPS * 32, 0, st>>>(
        x, z, m, d, cols, part, out, tickets);
  else
    sqdist_to_blocked_kernel<false><<<grid, SQ_WARPS * 32, 0, st>>>(
        x, z, m, d, cols, part, out, tickets);
  return (int)cudaGetLastError();
}

// One launch over the groups of 128 columns where x is 16-byte aligned and
// d a multiple of 4, else of 32; a block takes one or several groups
// (ws_tile_warps).
extern "C" int weighted_sum_blocked_launch(const float* x, const float* w,
                                           long long m, long long d,
                                           float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int cg = WS_WARPS / ws_tile_warps((m + WS_TILE - 1) / WS_TILE);
  if ((uintptr_t)x % 16 == 0 && d % 4 == 0)
    weighted_sum_blocked_kernel<4>
        <<<grid_for(d, 128 * cg), WS_THREADS, 0, st>>>(x, w, m, d, out);
  else
    weighted_sum_blocked_kernel<1>
        <<<grid_for(d, 32 * cg), WS_THREADS, 0, st>>>(x, w, m, d, out);
  return (int)cudaGetLastError();
}
