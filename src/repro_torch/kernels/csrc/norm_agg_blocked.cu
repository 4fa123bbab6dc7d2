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
// sequential grid axis. Blocks on the card run in any order, so a sum
// across blocks goes to a workspace, added in a fixed order by a second
// launch (the Gram, the distances), or stays in one block (the weighted
// sum). No floating-point atomics: a call repeats bit for bit.
//
// pair_gram_blocked. Bound: float32 operations, m(m+1) d for the upper
//   triangle (2 m^2 d for the full product). A register-tiled SIMT product,
//   no tensor cores (TF32 misses the 1e-5 tolerance): a block of 64 threads
//   owns one 64 x 64 output tile (ti <= tj) of one chunk of columns, stages
//   (64 rows x 32 columns) slabs of both row tiles in shared memory (a
//   two-slab ring filled by cp.async where d allows), and each thread
//   accumulates an 8 x 8 micro-tile with one fused multiply-add per column,
//   in column order. The running sums restart every column tile of the
//   reference (2048 columns) and fold into the output tile: a single chain
//   over 65536 columns missed 1e-5 of the largest entry. When the tile
//   pairs are too few to fill the card, d is split into chunks of whole
//   column tiles (grid y); each writes its tile to a (chunks, pairs, 64, 64)
//   workspace, and gram_blocked_finish sums the chunks in chunk order into
//   both (i, j) and (j, i), so G is symmetric bit for bit, as Krum's tie
//   rule needs.
// sqdist_to_blocked. Bound: bytes (the stack read once). One warp per row
//   and chunk of columns, float4 loads where d allows, a fixed lane order
//   and a fixed shuffle tree; (chunks, m) partials, summed in chunk order.
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

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GT = 64;        // Gram output tile: rows and columns
constexpr int GK = 32;        // columns staged per step
constexpr int GLD = GK + 4;   // staged row stride: 16-byte rows, no conflicts
constexpr int GTHREADS = 64;  // 8 x 8 threads, 8 x 8 outputs each
constexpr int SQ_WARPS = 8;   // rows per sqdist block, one warp each
constexpr int WS_WARPS = 8;   // worker tiles of the weighted sum at once
constexpr int WS_THREADS = WS_WARPS * 32;
constexpr int WS_TILE = 64;   // worker tile of the weighted sum
constexpr int WS_WINDOW = 32; // rows summed in order within a tile
constexpr int FINISH_THREADS = 256;

typedef float Slab[GT][GLD];  // (64 rows, 32 columns) of one row tile

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

// Stage the slab of row tile `r0` at columns [c0, c0 + GK) with 16-byte
// asynchronous copies (x 16-byte aligned, d and c1 multiples of 4); rows
// past m and columns past c1 are zero-filled.
__device__ __forceinline__ void stage_async(const float* x, long long m,
                                            long long d, long long r0,
                                            long long c0, long long c1,
                                            Slab& s) {
#pragma unroll
  for (int q = 0; q < GT * GK / 4 / GTHREADS; ++q) {
    const int f = threadIdx.x + GTHREADS * q;
    const int row = f >> 3, cg = (f & 7) * 4;
    const long long c = c0 + cg;
    const bool ok = r0 + row < m && c < c1;
    const float* src = ok ? x + (r0 + row) * d + c : x;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&s[row][cg]);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0));
  }
}

// The same slab with plain loads, one column per lane (any d).
__device__ __forceinline__ void stage_sync(const float* __restrict__ x,
                                           long long m, long long d,
                                           long long r0, long long c0,
                                           long long c1, Slab& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c = c0 + lane;
#pragma unroll 8
  for (int row = warp; row < GT; row += GTHREADS / 32)
    s[row][lane] = (c < c1 && r0 + row < m) ? x[(r0 + row) * d + c] : 0.f;
}

// acc[i][j] += the slab's 32 columns of row ty + 8i of `a` times row
// tx + 8j of `b`, one fused multiply-add per column, in column order.
__device__ __forceinline__ void gram_step(const Slab& a, const Slab& b,
                                          int ty, int tx,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < GK; kk += 4) {
    float4 av[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = *(const float4*)&a[ty + 8 * i][kk];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = *(const float4*)&b[tx + 8 * j][kk];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = acc[i][j];
        v = __fmaf_rn(av[i].x, bv[j].x, v);
        v = __fmaf_rn(av[i].y, bv[j].y, v);
        v = __fmaf_rn(av[i].z, bv[j].z, v);
        acc[i][j] = __fmaf_rn(av[i].w, bv[j].w, v);
      }
  }
}

// Fold the running sums of one column tile into the block's output tile
// (written on the first fold, added after) and restart them at zero.
__device__ __forceinline__ void gram_fold(float* out, int ty, int tx,
                                          bool first, float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* o = out + (ty + 8 * i) * GT + tx + 8 * j;
      *o = first ? acc[i][j] : __fadd_rn(*o, acc[i][j]);
      acc[i][j] = 0.f;
    }
}

// One block: the 64 x 64 tile pair blockIdx.x over the columns of chunk
// blockIdx.y, [k0, k1). The running sums restart every `tile` columns (the
// reference's column tile) and fold into the output tile, so no sum runs
// over more than `tile` terms in a row. ASYNC: a two-slab ring filled by
// cp.async, the next slab in flight while the current one is multiplied.
template <bool ASYNC>
__global__ void __launch_bounds__(GTHREADS) gram_blocked_tiles(
    const float* __restrict__ x, long long m, long long d, long long cols,
    long long tile, int nt, float* __restrict__ part) {
  __shared__ __align__(16) Slab sa[ASYNC ? 2 : 1];
  __shared__ __align__(16) Slab sb[ASYNC ? 2 : 1];
  int ti, tj;
  tile_pair(blockIdx.x, nt, &ti, &tj);
  const long long ra = (long long)ti * GT, rb = (long long)tj * GT;
  const long long k0 = (long long)blockIdx.y * cols;
  const long long k1 = k0 + cols < d ? k0 + cols : d;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  float* out = part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                          (GT * GT);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  bool first = true;
  if (ASYNC) {
    stage_async(x, m, d, ra, k0, k1, sa[0]);
    stage_async(x, m, d, rb, k0, k1, sb[0]);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  int buf = 0;
  for (long long k = k0; k < k1; k += GK) {
    if (ASYNC) {
      if (k + GK < k1) {
        stage_async(x, m, d, ra, k + GK, k1, sa[buf ^ 1]);
        stage_async(x, m, d, rb, k + GK, k1, sb[buf ^ 1]);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      stage_sync(x, m, d, ra, k, k1, sa[0]);
      stage_sync(x, m, d, rb, k, k1, sb[0]);
    }
    __syncthreads();
    gram_step(sa[buf], sb[buf], ty, tx, acc);
    if ((k + GK - k0) % tile == 0 || k + GK >= k1) {
      gram_fold(out, ty, tx, first, acc);
      first = false;
    }
    __syncthreads();
    if (ASYNC) buf ^= 1;
  }
}

// G[i][j] = G[j][i] = sum over the chunks, in chunk order, of the partial
// of entry (min(i, j), max(i, j)).
__global__ void gram_blocked_finish(const float* __restrict__ part,
                                    long long m, int nt, int chunks,
                                    float* __restrict__ out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m * m) return;
  const long long i = q / m, j = q % m;
  const long long a = i < j ? i : j, b = i < j ? j : i;
  const int ta = (int)(a / GT), tb = (int)(b / GT);
  const long long pairs = (long long)nt * (nt + 1) / 2;
  const long long p = (long long)ta * nt - (long long)ta * (ta - 1) / 2 +
                      (tb - ta);
  const long long off = p * (GT * GT) + (a % GT) * GT + (b % GT);
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c)
    acc = __fadd_rn(acc, part[(long long)c * pairs * (GT * GT) + off]);
  out[q] = acc;
}

template <bool VEC4>
__global__ void __launch_bounds__(SQ_WARPS * 32) sqdist_blocked_rows(
    const float* __restrict__ x, const float* __restrict__ z, long long m,
    long long d, long long cols, float* __restrict__ part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * SQ_WARPS + warp;
  if (row >= m) return;
  const long long k0 = (long long)blockIdx.y * cols;
  const long long k1 = k0 + cols < d ? k0 + cols : d;
  const float* xr = x + row * d;
  float acc = 0.f;
  if (VEC4) {  // x and z 16-byte aligned, d and cols multiples of 4
#pragma unroll 4
    for (long long c = k0 + lane * 4; c < k1; c += 128) {
      const float4 v = *(const float4*)(xr + c);
      const float4 w = *(const float4*)(z + c);
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
      const float e = __fsub_rn(xr[c], z[c]);
      acc = __fmaf_rn(e, e, acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) part[(long long)blockIdx.y * m + row] = acc;
}

// out[i] = sum over the p partials of column i, in order.
__global__ void sum_partials(const float* __restrict__ part, int p,
                             long long width, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  float acc = 0.f;
  for (int c = 0; c < p; ++c) acc = __fadd_rn(acc, part[c * width + i]);
  out[i] = acc;
}

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

}  // namespace

// The launch entry points enqueue on `stream` and return cudaGetLastError()
// (0 on success). The wrappers size the workspaces `part`: (chunks, pairs,
// 64, 64) for the Gram with pairs = nt (nt + 1) / 2, nt = ceil(m / 64);
// (chunks, m) for the distances.

extern "C" int pair_gram_blocked_launch(const float* x, long long m,
                                        long long d, int chunks,
                                        long long cols, long long tile,
                                        float* part, float* out,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = (int)((m + GT - 1) / GT);
  const dim3 grid((unsigned)nt * (nt + 1) / 2, chunks);
  if ((uintptr_t)x % 16 == 0 && d % 4 == 0 && cols % 4 == 0)
    gram_blocked_tiles<true><<<grid, GTHREADS, 0, st>>>(x, m, d, cols, tile,
                                                        nt, part);
  else
    gram_blocked_tiles<false><<<grid, GTHREADS, 0, st>>>(x, m, d, cols,
                                                         tile, nt, part);
  cudaError_t err;
  if ((err = cudaGetLastError())) return (int)err;
  gram_blocked_finish<<<grid_for(m * m, FINISH_THREADS), FINISH_THREADS, 0,
                        st>>>(part, m, nt, chunks, out);
  return (int)cudaGetLastError();
}

extern "C" int sqdist_to_blocked_launch(const float* x, const float* z,
                                        long long m, long long d, int chunks,
                                        long long cols, float* part,
                                        float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((m + SQ_WARPS - 1) / SQ_WARPS), chunks);
  const bool aligned = ((uintptr_t)x | (uintptr_t)z) % 16 == 0;
  if (aligned && d % 4 == 0 && cols % 4 == 0)
    sqdist_blocked_rows<true><<<grid, SQ_WARPS * 32, 0, st>>>(x, z, m, d,
                                                              cols, part);
  else
    sqdist_blocked_rows<false><<<grid, SQ_WARPS * 32, 0, st>>>(x, z, m, d,
                                                               cols, part);
  cudaError_t err;
  if ((err = cudaGetLastError())) return (int)err;
  sum_partials<<<grid_for(m, FINISH_THREADS), FINISH_THREADS, 0, st>>>(
      part, chunks, m, out);
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
