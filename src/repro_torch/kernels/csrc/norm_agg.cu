// Norm-based aggregation kernels for Hopper (sm_90a): the passes Krum and
// RFA (smoothed Weiszfeld) make over the attacked, bucketed worker stack.
//
// Replace the TPU kernels of repro/kernels/norm_agg.py:
//   pair_gram     (m, m) Gram G = xb xb^T            (Krum's distances)
//   rfa_iter      z = w^T xb and sq_b = |xb_b - z|^2 (one Weiszfeld pass)
//   weighted_sum  sum_i w_i sent_i, bucketing folded into w
// Each takes the dense (n, d) float32 or bfloat16 stack or a wire payload
// (sparse, int8, sign or bf16, with its base), with the fused BF / ALIE /
// IPM attack and, under the fault guard or partial
// participation, the (n,) validity select, through the loads of
// agg_prologue.cuh, so neither the attacked nor the bucketed stack is
// written to device memory. The masked cases change the load alone: the
// drivers apply the bucket validity to the weights and the scores.
//
// Bound: device-memory bytes. Each pass reads the stack (or the wire
// payload) and mean / std once, and rfa_iter writes z (d floats) only where
// its caller reads z (RFA's driver reads sq alone); the Gram adds m(m+1)
// flops per column, rfa_iter 5 m, and W x 2 m n, which stay below the
// float32 rate up to m = n = 64.
//
// Design. On the TPU, pair_gram and rfa_iter accumulate over d into a
// revisited output block along a sequential grid. Blocks on the card run in
// any order, so a fixed grid of blocks (as many as are resident at once)
// loops over the columns, each block keeping its partial Gram, or its m
// partial sums of squares, on chip; one launch finishes them
// (blocks_finish, finish.cuh): the last block of each group of 16 to finish (tickets
// after a __threadfence, in a buffer the wrapper keeps for each stream)
// sums the group's partials in block order, the last group the groups' in
// group order; a grid of one block writes at once. No floating-point
// atomics: every sum is taken in a fixed order, so a call repeats bit for
// bit, and Krum's argmin and RFA's trajectory with it. pair_gram and
// rfa_iter share their loads and their path by m:
//   registers (m <= 8 bucketed rows): the register load of agg_prologue.cuh
//     (the looping grid of robust_agg.cu's register path: V columns a
//     thread read with loads of up to 16 bytes, the rows streamed through
//     registers into the bucket sums, one fused multiply-add a term in
//     worker order, the sparse wire's bounds found on the card). pair_gram
//     keeps the m(m+1)/2 pair products of a thread in registers across
//     every column it visits; rfa_iter takes z_c of each column
//     (weighted_col's order) and adds (xb_bc - z_c)^2 into m registers.
//   shared memory (8 < m <= 64): the attacked rows staged a group of 128
//     columns at a time, 129 floats a row (a column of rows falls in 32
//     banks), then W x a thread a column over W's nonzero terms where the
//     column is finite (a term of weight zero adds nothing there, but
//     0 * inf is NaN: a column that is not finite takes every worker).
//     pair_gram: each thread adds an 8 x 8 tile of the upper triangle over a
//     slice of the columns (16 shared loads for 64 fused multiply-adds).
//     rfa_iter: a thread a column takes z_c, then each thread adds the
//     squared differences of one row over a slice of m columns.
//   pair_gram writes G mirrored, so G is symmetric bit for bit, as Krum's
//   tied nearest neighbours need. No TF32: its rounding would break the
//   Gram's tolerance and those ties.
//   weighted_sum: the register load; no W and no reduction across blocks.

#include "agg_prologue.cuh"
#include "finish.cuh"

__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (i, j), i <= j, of the q-th entry of the row-major upper triangle.
__host__ __device__ inline void pair_of(int q, int m, int* i, int* j) {
  int r = q, a = 0;
  while (r >= m - a) {
    r -= m - a;
    ++a;
  }
  *i = a;
  *j = a + r;
}

// q of the pair (i, j), i <= j, in the row-major upper triangle of m x m.
__host__ __device__ inline int pair_index(int i, int j, int m) {
  return i * m - i * (i - 1) / 2 + (j - i);
}

// What a pair_gram or rfa_iter launch takes besides its source: W (m, n),
// or null and m = n; RFA's weights w (m,) and z (d,), or null where the
// caller reads sq alone; whether the register load may take vector loads;
// the partials' workspace (blocks + ceil(blocks / 16), entries), the result
// (G (m, m), or sq (m,)) and the tickets.
struct NormArgs {
  const float* w_mat;
  int m;
  const float* w;
  float* z;
  int aligned;
  float* part;
  float* out;
  unsigned* tickets;
};

// --- the register path (m <= 8) -------------------------------------------

// Blocks an SM must hold where the register path's accumulators are few
// (four bucket sums of at most four columns: pair_gram at 73 registers a
// thread).
#define REGS_MIN_BLOCKS(mb, v) ((mb) == 4 && (v) <= 4 ? 7 : 1)

// Shared memory of the register path, in floats: the sparse tile
// (n, TILE * V), W (MB, n) zero-padded past m, the byzantine mask and the
// validity (n,), `extra` floats of the kernel's own, the sparse walk's
// positions (n,).
struct RegsSmem {
  float *tile, *w, *mask, *valid, *extra;
  int* pos;
};

__host__ __device__ inline size_t regs_words(int n, int mb, int v,
                                             bool bucketed, bool sparse,
                                             int extra) {
  return (sparse ? (size_t)n * TILE * v : 0) +
         (bucketed ? (size_t)mb * n : 0) + 3 * (size_t)n + extra;
}

__device__ __forceinline__ RegsSmem regs_carve(float* smem, int n, int mb,
                                               int v, bool bucketed,
                                               bool sparse, int extra) {
  RegsSmem s;
  s.tile = smem;
  s.w = s.tile + (sparse ? n * TILE * v : 0);
  s.mask = s.w + (bucketed ? mb * n : 0);
  s.valid = s.mask + n;
  s.extra = s.valid + n;
  s.pos = reinterpret_cast<int*>(s.extra + extra);
  return s;
}

// W (zero-padded past m to MB rows), the mask and the validity (1 where
// none is given) into shared memory; readers wait for the next barrier.
__device__ __forceinline__ void stage_regs(const Src& a, const float* w_mat,
                                           int m, int mb, const RegsSmem& s) {
  const int tid = threadIdx.x;
  if (w_mat)
    for (int q = tid; q < mb * a.n; q += TILE)
      s.w[q] = q < m * a.n ? w_mat[q] : 0.f;
  for (int q = tid; q < a.n; q += TILE) {
    s.mask[q] = a.mask ? mask_at(a.mask, q, a.u8_masks & MASK_U8) : 0.f;
    s.valid[q] = a.valid ? mask_at(a.valid, q, a.u8_masks & VALID_U8) : 1.f;
  }
}

// The MB bucket sums of a thread's V columns c0.. (rows past m hold W's
// zero padding times the rows): each of the n rows loaded (row_values),
// attacked and guarded (attack_row), then one fused multiply-add a term
// into each bucket sum, in worker order; without W the first MB rows
// themselves (rows past n zero).
template <int LOAD, int MB, int V>
__device__ __forceinline__ void bucket_regs(const Src& a, bool bucketed,
                                            const RegsSmem& s, long long c0,
                                            bool full, const float (&f)[V],
                                            const float (&base1)[V],
                                            float (&xb)[MB][V]) {
  constexpr int GROUP = TILE * V;
  constexpr int UNROLL = V <= 4 ? 4 : 2;
  const int col = threadIdx.x * V;
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int v = 0; v < V; ++v) xb[b][v] = 0.f;
  if (bucketed) {
#pragma unroll UNROLL
    for (int j = 0; j < a.n; ++j) {
      float q[V];
      row_values<LOAD, V>(a, j, c0, full, s.tile, GROUP, col, base1, q);
      attack_row<V>(a, s.mask[j], s.valid[j], f, q);
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        const float wb = s.w[b * a.n + j];
#pragma unroll
        for (int v = 0; v < V; ++v) xb[b][v] = __fmaf_rn(wb, q[v], xb[b][v]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < MB; ++j) {
      if (j >= a.n) break;
      float q[V];
      row_values<LOAD, V>(a, j, c0, full, s.tile, GROUP, col, base1, q);
      attack_row<V>(a, s.mask[j], s.valid[j], f, q);
#pragma unroll
      for (int v = 0; v < V; ++v) xb[j][v] = q[v];
    }
  }
}

// m <= MB <= 8 bucketed rows, V columns a thread (bucket_regs), then each
// of the MB (MB + 1) / 2 pair products added into its register, column by
// column. Shared memory past the register path's: the warps' sums
// (TILE / 32, P) and the block's Gram (P,).
template <int LOAD, int MB, int V>
__global__ void __launch_bounds__(TILE, REGS_MIN_BLOCKS(MB, V))
    pair_gram_regs(Src a, NormArgs k) {
  constexpr int GROUP = TILE * V;
  constexpr int P = MB * (MB + 1) / 2;
  constexpr int WARPS = TILE / 32;
  extern __shared__ float4 smem4[];
  const RegsSmem s =
      regs_carve(reinterpret_cast<float*>(smem4), a.n, MB, V,
                 k.w_mat != nullptr, LOAD == LOAD_SPARSE, (WARPS + 1) * P);
  float* s_red = s.extra;
  float* s_part = s_red + WARPS * P;
  const int tid = threadIdx.x;
  const long long groups = (a.d + GROUP - 1) / GROUP;
  const long long g0 = groups * blockIdx.x / gridDim.x;
  const long long g1 = groups * (blockIdx.x + 1) / gridDim.x;
  stage_regs(a, k.w_mat, k.m, MB, s);
  __syncthreads();
  if (LOAD == LOAD_SPARSE) sparse_starts(a, g0 * GROUP, s.valid, s.pos);
  float gp[P];
#pragma unroll
  for (int p = 0; p < P; ++p) gp[p] = 0.f;

  // as in robust_agg_regs: a contiguous range for the sparse walk, the grid
  // strided on the other loads
  constexpr bool RANGE = LOAD == LOAD_SPARSE;
  const long long step = RANGE ? 1 : gridDim.x;
  for (long long g = RANGE ? g0 : blockIdx.x; g < (RANGE ? g1 : groups);
       g += step) {
    const long long c0 = g * GROUP + (long long)tid * V;
    const bool full = k.aligned && c0 + V <= a.d;
    float mu[V], sd[V], f[V], base1[V], xb[MB][V];
#pragma unroll
    for (int v = 0; v < V; ++v) mu[v] = sd[v] = base1[v] = 0.f;
    if (c0 < a.d) {        // issued before the walk, which hides them
      forged_load<V>(a, c0, full, mu, sd);
      if (a.base && a.base_rows == 1)
        load_row<float, V>(a.base + c0, full, a.d - c0, base1);
    }
    if (LOAD == LOAD_SPARSE)
      scatter_group(a, g * GROUP, GROUP, s.valid, s.pos, s.tile);
    if (c0 < a.d) {
      forged_finish<V>(a, mu, sd, f);
      bucket_regs<LOAD, MB, V>(a, k.w_mat != nullptr, s, c0, full, f, base1,
                               xb);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        int p = 0;
#pragma unroll
        for (int i = 0; i < MB; ++i)
#pragma unroll
          for (int j = i; j < MB; ++j, ++p)
            gp[p] = __fmaf_rn(xb[i][v], xb[j][v], gp[p]);
      }
    }
  }
  // the block's sums: a butterfly in each warp, then the warps in order
  const int warp = tid >> 5, lane = tid & 31, m = k.m;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float r = warp_sum(gp[p], 32);
    if (lane == 0) s_red[warp * P + p] = r;
  }
  __syncthreads();
  for (int q = tid; q < m * (m + 1) / 2; q += TILE) {
    int i, j;
    pair_of(q, m, &i, &j);
    const int p = pair_index(i, j, MB);
    float acc = s_red[p];
    for (int w = 1; w < WARPS; ++w) acc = __fadd_rn(acc, s_red[w * P + p]);
    s_part[q] = acc;
  }
  __syncthreads();
  float* out = k.out;
  blocks_finish(s_part, m * (m + 1) / 2, k.part, k.tickets,
                blockIdx.x, gridDim.x, [=](int q, float v) {
                  int i, j;
                  pair_of(q, m, &i, &j);
                  out[i * m + j] = v;
                  out[j * m + i] = v;
                });
}

// m <= MB <= 8 bucketed rows, V columns a thread (bucket_regs): z_c of each
// column in weighted_col's order (one fused multiply-add a row), written
// where the caller reads z, then (xb_bc - z_c)^2 added into MB registers,
// column by column. Shared memory past the register path's: the Weiszfeld
// weights (MB,) zero past m, the warps' sums (TILE / 32, MB) and the
// block's (MB,).
template <int LOAD, int MB, int V>
__global__ void __launch_bounds__(TILE, REGS_MIN_BLOCKS(MB, V))
    rfa_iter_regs(Src a, NormArgs k) {
  constexpr int GROUP = TILE * V;
  constexpr int WARPS = TILE / 32;
  extern __shared__ float4 smem4[];
  const RegsSmem s =
      regs_carve(reinterpret_cast<float*>(smem4), a.n, MB, V,
                 k.w_mat != nullptr, LOAD == LOAD_SPARSE, (WARPS + 2) * MB);
  float* s_wr = s.extra;
  float* s_red = s_wr + MB;
  float* s_part = s_red + WARPS * MB;
  const int tid = threadIdx.x, m = k.m;
  const long long groups = (a.d + GROUP - 1) / GROUP;
  const long long g0 = groups * blockIdx.x / gridDim.x;
  const long long g1 = groups * (blockIdx.x + 1) / gridDim.x;
  stage_regs(a, k.w_mat, m, MB, s);
  for (int q = tid; q < MB; q += TILE) s_wr[q] = q < m ? k.w[q] : 0.f;
  __syncthreads();
  if (LOAD == LOAD_SPARSE) sparse_starts(a, g0 * GROUP, s.valid, s.pos);
  float acc[MB];
#pragma unroll
  for (int b = 0; b < MB; ++b) acc[b] = 0.f;

  // as in robust_agg_regs: a contiguous range for the sparse walk, the grid
  // strided on the other loads
  constexpr bool RANGE = LOAD == LOAD_SPARSE;
  const long long step = RANGE ? 1 : gridDim.x;
  for (long long g = RANGE ? g0 : blockIdx.x; g < (RANGE ? g1 : groups);
       g += step) {
    const long long c0 = g * GROUP + (long long)tid * V;
    const bool full = k.aligned && c0 + V <= a.d;
    float mu[V], sd[V], f[V], base1[V], xb[MB][V];
#pragma unroll
    for (int v = 0; v < V; ++v) mu[v] = sd[v] = base1[v] = 0.f;
    if (c0 < a.d) {        // issued before the walk, which hides them
      forged_load<V>(a, c0, full, mu, sd);
      if (a.base && a.base_rows == 1)
        load_row<float, V>(a.base + c0, full, a.d - c0, base1);
    }
    if (LOAD == LOAD_SPARSE)
      scatter_group(a, g * GROUP, GROUP, s.valid, s.pos, s.tile);
    if (c0 < a.d) {
      forged_finish<V>(a, mu, sd, f);
      bucket_regs<LOAD, MB, V>(a, k.w_mat != nullptr, s, c0, full, f, base1,
                               xb);
      float zc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        zc[v] = 0.f;      // rows past m left out: 0 * inf would be NaN
#pragma unroll
        for (int b = 0; b < MB; ++b)
          if (b < m) zc[v] = __fmaf_rn(xb[b][v], s_wr[b], zc[v]);
      }
      if (k.z) store_row<V>(k.z + c0, full, a.d - c0, zc);
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          const float e = __fsub_rn(xb[b][v], zc[v]);
          acc[b] = __fmaf_rn(e, e, acc[b]);
        }
    }
  }
  // the block's sums: a butterfly in each warp, then the warps in order
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int b = 0; b < MB; ++b) {
    const float r = warp_sum(acc[b], 32);
    if (lane == 0) s_red[warp * MB + b] = r;
  }
  __syncthreads();
  for (int q = tid; q < m; q += TILE) {
    float v = s_red[q];
    for (int w = 1; w < WARPS; ++w) v = __fadd_rn(v, s_red[w * MB + q]);
    s_part[q] = v;
  }
  __syncthreads();
  float* sq = k.out;
  blocks_finish(s_part, m, k.part, k.tickets,
                blockIdx.x, gridDim.x, [=](int q, float v) { sq[q] = v; });
}

// --- the shared-memory path (8 < m <= 64) ---------------------------------

constexpr int RS = TILE + 1;                    // floats a staged row
constexpr int ROWS_A_WARP = 64 / (TILE / 32);   // MAX_FUSED_WORKERS rows

// Shared memory of the shared-memory path, in floats: the sparse tile
// (n, TILE); the staged rows: without W the attacked rows (MB, RS), zero
// past n; with W the attacked rows (n, RS) and the bucket sums (MB, RS); at
// least `min_rows` floats, which a kernel may take for itself once its loop
// is done; with W, the terms of W x (MB * n, two words each: the worker's
// row offset, the bucket and whether the term ends its bucket; the weight);
// the mask and validity (n,); the columns' non-finite flags (TILE,); the
// walk's positions (n,); the buckets' first terms (MB + 1,); `extra` floats
// of the kernel's own.
struct StageWords {
  size_t tile, rows, terms, total;
};

__host__ __device__ inline StageWords stage_words(int n, int mb,
                                                  bool bucketed, bool sparse,
                                                  size_t min_rows,
                                                  int extra) {
  StageWords g;
  g.tile = sparse ? (size_t)n * TILE : 0;
  size_t rows = (size_t)(bucketed ? n + mb : mb) * RS;
  if (rows < min_rows) rows = min_rows;
  g.rows = (rows + 3) / 4 * 4;
  g.terms = bucketed ? 2 * (size_t)mb * n : 0;
  g.total = g.tile + g.rows + g.terms + 2 * (size_t)n + TILE + n + mb + 1 +
            extra;
  return g;
}

struct Stage {
  float *tile, *x, *xb, *mask, *valid, *extra;
  int2* terms;
  int *bad, *pos, *first;
};

__device__ __forceinline__ Stage stage_carve(float* smem, const StageWords& g,
                                             int n, int mb, bool bucketed) {
  Stage s;
  s.tile = smem;
  s.x = smem + g.tile;
  s.xb = bucketed ? s.x + (size_t)n * RS : s.x;
  s.terms = reinterpret_cast<int2*>(s.x + g.rows);
  s.mask = s.x + g.rows + g.terms;
  s.valid = s.mask + n;
  s.bad = reinterpret_cast<int*>(s.valid + n);
  s.pos = s.bad + TILE;
  s.first = s.pos + n;
  s.extra = reinterpret_cast<float*>(s.first + mb + 1);
  return s;
}

// Once a block: W's nonzero terms, by bucket, in worker order (returns how
// many); the bucket sums' rows zeroed (without W the rows past n), so that
// a bucket without terms and the rows past m add nothing; the non-finite
// flags cleared; the mask and the validity. Readers wait for the next
// barrier.
template <int MB>
__device__ int stage_consts_smem(const Src& a, const float* w_mat, int m,
                                 const Stage& s) {
  const int tid = threadIdx.x;
  const bool bucketed = w_mat != nullptr;
  int n_terms = 0;
  if (bucketed) {
    for (int b = tid; b < m; b += TILE) {
      int cnt = 0;
      for (int j = 0; j < a.n; ++j) cnt += w_mat[b * a.n + j] != 0.f;
      s.first[b + 1] = cnt;
    }
    __syncthreads();
    if (tid == 0) {
      s.first[0] = 0;
      for (int b = 0; b < m; ++b) s.first[b + 1] += s.first[b];
    }
    __syncthreads();
    for (int b = tid; b < m; b += TILE) {
      int t = s.first[b];
      for (int j = 0; j < a.n; ++j) {
        const float wv = w_mat[b * a.n + j];
        if (wv != 0.f) {
          const bool last = t + 1 == s.first[b + 1];
          s.terms[t++] = make_int2(j * RS | b << 16 | (last ? 1 << 30 : 0),
                                   __float_as_int(wv));
        }
      }
    }
    n_terms = s.first[m];
  }
  for (int q = (bucketed ? 0 : a.n) * RS + tid; q < MB * RS; q += TILE)
    s.xb[q] = 0.f;
  for (int q = tid; q < TILE; q += TILE) s.bad[q] = 0;
  for (int q = tid; q < a.n; q += TILE) {
    s.mask[q] = a.mask ? mask_at(a.mask, q, a.u8_masks & MASK_U8) : 0.f;
    s.valid[q] = a.valid ? mask_at(a.valid, q, a.u8_masks & VALID_U8) : 1.f;
  }
  return n_terms;
}

// Group g of TILE columns into the staged rows: the attacked rows (each
// warp every fourth row, a lane four columns with one load of up to 16
// bytes, all of a thread's n / 4 loads issued before the first is used;
// columns past d zero), a column with a value that is not finite flagged
// when bucketed; then, with W, the bucket sums, a thread a column: each
// bucket's sum over the workers of nonzero weight, one fused multiply-add a
// term in worker order, from the term list where the column is finite, and
// over every worker (W read from device memory) where it is not. Starts
// with a barrier (the last group's readers of the staged rows are done; the
// sparse walk's first) and ends with one.
template <int LOAD>
__device__ __forceinline__ void stage_group(const Src& a, long long g,
                                            int aligned, const float* w_mat,
                                            int m, int n_terms,
                                            const Stage& s) {
  constexpr int WARPS = TILE / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool bucketed = w_mat != nullptr;
  const long long c0 = g * TILE + 4 * lane;      // this lane's 4 columns
  const bool in = c0 < a.d, full = aligned && c0 + 4 <= a.d;
  float mu[4], sd[4], f[4], base1[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) mu[v] = sd[v] = base1[v] = 0.f;
  if (in) {
    forged_load<4>(a, c0, full, mu, sd);
    if (a.base && a.base_rows == 1)
      load_row<float, 4>(a.base + c0, full, a.d - c0, base1);
  }
  if (LOAD == LOAD_SPARSE)
    scatter_group(a, g * TILE, TILE, s.valid, s.pos, s.tile);
  else
    __syncthreads();
  // every row of this warp (at most 64 / 4) read before any is used, so
  // that the loads, the mean and the std are in flight together
  float q[ROWS_A_WARP][4];
#pragma unroll
  for (int r = 0; r < ROWS_A_WARP; ++r) {
    const int j = warp + r * WARPS;
#pragma unroll
    for (int v = 0; v < 4; ++v) q[r][v] = 0.f;
    if (in && j < a.n)
      row_values<LOAD, 4>(a, j, c0, full, s.tile, TILE, 4 * lane, base1,
                          q[r]);
  }
  forged_finish<4>(a, mu, sd, f);
#pragma unroll
  for (int r = 0; r < ROWS_A_WARP; ++r) {
    const int j = warp + r * WARPS;
    if (j >= a.n) break;
    if (in) attack_row<4>(a, s.mask[j], s.valid[j], f, q[r]);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      s.x[j * RS + 4 * lane + v] = q[r][v];
      if (bucketed && !(fabsf(q[r][v]) <= 3.402823466e38f))
        atomicOr(&s.bad[4 * lane + v], 1);
    }
  }
  __syncthreads();
  if (!bucketed) return;
  const float* xc = s.x + tid;
  if (!s.bad[tid]) {
    float acc_b = 0.f;
#pragma unroll 4
    for (int t = 0; t < n_terms; ++t) {
      const int2 tm = s.terms[t];
      acc_b = __fmaf_rn(__int_as_float(tm.y), xc[tm.x & 0xFFFF], acc_b);
      if (tm.x & 1 << 30) {
        s.xb[(tm.x >> 16 & 63) * RS + tid] = acc_b;
        acc_b = 0.f;
      }
    }
  } else {
    for (int b = 0; b < m; ++b) {
      float acc_b = 0.f;
      for (int j = 0; j < a.n; ++j)
        acc_b = __fmaf_rn(__ldg(w_mat + b * a.n + j), xc[j * RS], acc_b);
      s.xb[b * RS + tid] = acc_b;
    }
    s.bad[tid] = 0;
  }
  __syncthreads();
}

// pair_gram's layout: 8 x 8 tiles of the upper triangle, TP of them, each
// split over S column slices, one (tile, slice) a thread.
template <int MB>
struct GramTiles {
  static constexpr int MT = MB / 8;              // 8-row blocks
  static constexpr int TP = MT * (MT + 1) / 2;   // tiles I <= J
  static constexpr int S = TILE / TP;            // column slices a tile
  static constexpr int P = MB * (MB + 1) / 2;
};

// 8 < m <= MB <= 64 bucketed rows, a group at a time (stage_group), then
// each thread adds its tile's 8 x 8 products over its column slice, 16
// shared loads for 64 fused multiply-adds. After the loop the threads'
// tiles (TP * S, 64) take the staged rows' place. Shared memory past the
// staging: the block's Gram (P,).
template <int LOAD, int MB>
__global__ void __launch_bounds__(TILE, 3) pair_gram_smem(Src a, NormArgs k) {
  using L = GramTiles<MB>;
  const bool bucketed = k.w_mat != nullptr;
  const StageWords gw = stage_words(a.n, MB, bucketed, LOAD == LOAD_SPARSE,
                                    (size_t)L::TP * L::S * 64, L::P);
  extern __shared__ float4 smem4[];
  const Stage s =
      stage_carve(reinterpret_cast<float*>(smem4), gw, a.n, MB, bucketed);
  float* s_part = s.extra;
  const int tid = threadIdx.x, m = k.m;
  const long long groups = (a.d + TILE - 1) / TILE;
  const long long g0 = groups * blockIdx.x / gridDim.x;
  const long long g1 = groups * (blockIdx.x + 1) / gridDim.x;
  const int n_terms = stage_consts_smem<MB>(a, k.w_mat, m, s);
  __syncthreads();
  if (LOAD == LOAD_SPARSE) sparse_starts(a, g0 * TILE, s.valid, s.pos);
  const bool active = tid < L::TP * L::S;
  const int tp = active ? tid / L::S : 0, slice = tid % L::S;
  int ti, tj;
  pair_of(tp, L::MT, &ti, &tj);
  const float* ri0 = s.xb + 8 * ti * RS;
  const float* rj0 = s.xb + 8 * tj * RS;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  constexpr bool RANGE = LOAD == LOAD_SPARSE;   // as in pair_gram_regs
  const long long step = RANGE ? 1 : gridDim.x;
  for (long long g = RANGE ? g0 : blockIdx.x; g < (RANGE ? g1 : groups);
       g += step) {
    stage_group<LOAD>(a, g, k.aligned, k.w_mat, m, n_terms, s);
    if (active)
      for (int cc = slice; cc < TILE; cc += L::S) {
        float ri[8], rj[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          ri[r] = ri0[r * RS + cc];
          rj[r] = rj0[r * RS + cc];
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] = __fmaf_rn(ri[r], rj[c], acc[r][c]);
      }
  }
  __syncthreads();
  float* s_red = s.x;                  // the staged rows are done with
  if (active) {
    float* mine = s_red + tid * 64;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) mine[r * 8 + c] = acc[r][c];
  }
  __syncthreads();
  // the block's entry (i, j): its tile's slices added in slice order
  for (int q = tid; q < m * (m + 1) / 2; q += TILE) {
    int i, j;
    pair_of(q, m, &i, &j);
    const int t = pair_index(i >> 3, j >> 3, L::MT);
    const float* e = s_red + t * L::S * 64 + (i & 7) * 8 + (j & 7);
    float v = e[0];
    for (int sl = 1; sl < L::S; ++sl) v = __fadd_rn(v, e[sl * 64]);
    s_part[q] = v;
  }
  __syncthreads();
  float* out = k.out;
  blocks_finish(s_part, m * (m + 1) / 2, k.part, k.tickets,
                blockIdx.x, gridDim.x, [=](int q, float v) {
                  int i, j;
                  pair_of(q, m, &i, &j);
                  out[i * m + j] = v;
                  out[j * m + i] = v;
                });
}

// 8 < m <= MB <= 64 bucketed rows, a group at a time (stage_group); a
// thread a column takes z_c (weighted_col's order over the m bucket sums)
// and writes it where the caller reads z; then thread (slice, row) adds
// (xb_bc - z_c)^2 of one row over a slice of MB consecutive columns (TILE /
// MB slices: a warp's rows fall in 32 banks, z_c is a broadcast). Shared
// memory past the staging: the Weiszfeld weights (MB,) zero past m, the
// group's z (TILE,), which the threads' sums take after the loop, and the
// block's sums (MB,).
template <int LOAD, int MB>
__global__ void __launch_bounds__(TILE, 3) rfa_iter_smem(Src a, NormArgs k) {
  constexpr int S = TILE / MB;
  const bool bucketed = k.w_mat != nullptr;
  const StageWords gw = stage_words(a.n, MB, bucketed, LOAD == LOAD_SPARSE,
                                    0, 2 * MB + TILE);
  extern __shared__ float4 smem4[];
  const Stage s =
      stage_carve(reinterpret_cast<float*>(smem4), gw, a.n, MB, bucketed);
  float* s_wr = s.extra;
  float* s_z = s_wr + MB;
  float* s_part = s_z + TILE;
  const int tid = threadIdx.x, m = k.m;
  const long long groups = (a.d + TILE - 1) / TILE;
  const long long g0 = groups * blockIdx.x / gridDim.x;
  const long long g1 = groups * (blockIdx.x + 1) / gridDim.x;
  const int n_terms = stage_consts_smem<MB>(a, k.w_mat, m, s);
  for (int q = tid; q < MB; q += TILE) s_wr[q] = q < m ? k.w[q] : 0.f;
  __syncthreads();
  if (LOAD == LOAD_SPARSE) sparse_starts(a, g0 * TILE, s.valid, s.pos);
  const int row = tid % MB, slice = tid / MB;
  const float* xr = s.xb + row * RS + slice * MB;
  const float* zr = s_z + slice * MB;
  float acc = 0.f;

  constexpr bool RANGE = LOAD == LOAD_SPARSE;   // as in pair_gram_regs
  const long long step = RANGE ? 1 : gridDim.x;
  for (long long g = RANGE ? g0 : blockIdx.x; g < (RANGE ? g1 : groups);
       g += step) {
    stage_group<LOAD>(a, g, k.aligned, k.w_mat, m, n_terms, s);
    const float zc = weighted_col(s.xb + tid, RS, s_wr, m);
    s_z[tid] = zc;
    const long long c = g * TILE + tid;
    if (k.z && c < a.d) k.z[c] = zc;
    __syncthreads();
    if (row < m)
#pragma unroll 8
      for (int cc = 0; cc < MB; ++cc) {
        const float e = __fsub_rn(xr[cc], zr[cc]);
        acc = __fmaf_rn(e, e, acc);
      }
  }
  __syncthreads();
  s_z[tid] = acc;                      // (S, MB), a slice's rows together
  __syncthreads();
  for (int q = tid; q < m; q += TILE) {
    float v = s_z[q];
    for (int sl = 1; sl < S; ++sl) v = __fadd_rn(v, s_z[sl * MB + q]);
    s_part[q] = v;
  }
  __syncthreads();
  float* sq = k.out;
  blocks_finish(s_part, m, k.part, k.tickets,
                blockIdx.x, gridDim.x, [=](int q, float v) { sq[q] = v; });
}

// Sum_i w_i sent_i over the n <= 64 attacked rows: a looping grid (a
// contiguous range a block on the sparse wire, the grid strided on the
// other loads), V columns a thread read with loads of up to 16 bytes, the
// rows streamed through registers into the weighted_col order (one fused
// multiply-add a row up to 32 rows; above, rounded products in XLA's two
// windows). Shared memory: the sparse tile (n, TILE * V), then the
// weights, the byzantine mask and the validity (n,) each, and the sparse
// walk's positions (n,).
template <int LOAD, int V>
__global__ void __launch_bounds__(TILE, V <= 4 ? 8 : 1) weighted_sum_kernel(
    Src a, const float* w, int aligned, float* out) {
  constexpr int GROUP = TILE * V;
  extern __shared__ float4 smem4[];
  float* s_tile = reinterpret_cast<float*>(smem4);
  float* s_wr = s_tile + (LOAD == LOAD_SPARSE ? a.n * GROUP : 0);
  float* s_mask = s_wr + a.n;
  float* s_valid = s_mask + a.n;
  int* s_pos = reinterpret_cast<int*>(s_valid + a.n);
  const int tid = threadIdx.x;
  const long long groups = (a.d + GROUP - 1) / GROUP;
  const long long g0 = groups * blockIdx.x / gridDim.x;
  const long long g1 = groups * (blockIdx.x + 1) / gridDim.x;
  for (int q = tid; q < a.n; q += TILE) {
    s_wr[q] = w[q];
    s_mask[q] = a.mask ? mask_at(a.mask, q, a.u8_masks & MASK_U8) : 0.f;
    s_valid[q] = a.valid ? mask_at(a.valid, q, a.u8_masks & VALID_U8) : 1.f;
  }
  __syncthreads();
  if (LOAD == LOAD_SPARSE) sparse_starts(a, g0 * GROUP, s_valid, s_pos);
  const int cut = a.n <= XLA_WINDOW
                      ? a.n : XLA_WINDOW - (2 * XLA_WINDOW - a.n) / 2;

  // as in robust_agg_regs: a contiguous range for the sparse walk, the grid
  // strided on the other loads
  constexpr bool RANGE = LOAD == LOAD_SPARSE;
  constexpr int UNROLL = V <= 4 ? 4 : 2;
  const long long step = RANGE ? 1 : gridDim.x;
  for (long long g = RANGE ? g0 : blockIdx.x; g < (RANGE ? g1 : groups);
       g += step) {
    const long long c0 = g * GROUP + (long long)tid * V;
    const bool full = aligned && c0 + V <= a.d;
    float mu[V], sd[V], f[V], base1[V], lo[V], hi[V];
#pragma unroll
    for (int v = 0; v < V; ++v) mu[v] = sd[v] = base1[v] = lo[v] = hi[v] = 0.f;
    if (c0 < a.d) {        // issued before the walk, which hides them
      forged_load<V>(a, c0, full, mu, sd);
      if (a.base && a.base_rows == 1)
        load_row<float, V>(a.base + c0, full, a.d - c0, base1);
    }
    if (LOAD == LOAD_SPARSE)
      scatter_group(a, g * GROUP, GROUP, s_valid, s_pos, s_tile);
    if (c0 < a.d) {
      forged_finish<V>(a, mu, sd, f);
#pragma unroll UNROLL
      for (int j = 0; j < a.n; ++j) {
        float q[V];
        row_values<LOAD, V>(a, j, c0, full, s_tile, GROUP, tid * V, base1, q);
        attack_row<V>(a, s_mask[j], s_valid[j], f, q);
        const float wj = s_wr[j];
        if (a.n <= XLA_WINDOW) {
#pragma unroll
          for (int v = 0; v < V; ++v) lo[v] = __fmaf_rn(q[v], wj, lo[v]);
        } else if (j < cut) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            lo[v] = __fadd_rn(lo[v], __fmul_rn(q[v], wj));
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v)
            hi[v] = __fadd_rn(hi[v], __fmul_rn(q[v], wj));
        }
      }
      if (a.n > XLA_WINDOW)
#pragma unroll
        for (int v = 0; v < V; ++v) lo[v] = __fadd_rn(lo[v], hi[v]);
      store_row<V>(out + c0, full, a.d - c0, lo);
    }
  }
}

enum { KERNEL_GRAM = 0, KERNEL_RFA = 1 };

// One pair_gram or rfa_iter call: with `launch`, its launch (returns the
// CUDA error); without, the query of its shape (returns the blocks
// resident at once, or -(CUDA error), and sets *group to the columns a
// block takes a step).
struct NormCall {
  int kernel;
  const Src* a;
  NormArgs k;
  int blocks;
  cudaStream_t st;
  bool bucketed, launch;
  int* group;
};

template <typename Kernel>
static int launch_or_query(Kernel kernel, size_t smem, int group,
                           const NormCall& c, const NormArgs& k) {
  const int resident = resident_grid(kernel, TILE, smem);
  if (!c.launch) {
    *c.group = group;
    return resident;
  }
  if (resident < 0) return -resident;
  kernel<<<c.blocks, TILE, smem, c.st>>>(*c.a, k);
  return (int)cudaGetLastError();
}

template <int LOAD, int MB, int V>
static int norm_regs(const NormCall& c) {
  constexpr int WARPS = TILE / 32;
  constexpr int P = MB * (MB + 1) / 2;
  constexpr bool SPARSE = LOAD == LOAD_SPARSE;
  NormArgs k = c.k;
  if (c.kernel == KERNEL_GRAM) {
    k.aligned = c.launch && vec_aligned(*c.a, V, nullptr);
    return launch_or_query(
        pair_gram_regs<LOAD, MB, V>,
        regs_words(c.a->n, MB, V, c.bucketed, SPARSE, (WARPS + 1) * P) *
            sizeof(float),
        TILE * V, c, k);
  }
  k.aligned = c.launch && vec_aligned(*c.a, V, k.z);
  return launch_or_query(
      rfa_iter_regs<LOAD, MB, V>,
      regs_words(c.a->n, MB, V, c.bucketed, SPARSE, (WARPS + 2) * MB) *
          sizeof(float),
      TILE * V, c, k);
}

template <int LOAD, int MB>
static int norm_tiles(const NormCall& c) {
  constexpr bool SPARSE = LOAD == LOAD_SPARSE;
  NormArgs k = c.k;
  k.aligned = c.launch && vec_aligned(*c.a, 4, nullptr);
  if (c.kernel == KERNEL_GRAM) {
    using L = GramTiles<MB>;
    return launch_or_query(
        pair_gram_smem<LOAD, MB>,
        stage_words(c.a->n, MB, c.bucketed, SPARSE,
                    (size_t)L::TP * L::S * 64, L::P).total * sizeof(float),
        TILE, c, k);
  }
  return launch_or_query(
      rfa_iter_smem<LOAD, MB>,
      stage_words(c.a->n, MB, c.bucketed, SPARSE, 0, 2 * MB + TILE).total *
          sizeof(float),
      TILE, c, k);
}

// The path by m, the same for both kernels: registers up to 8 bucketed
// rows (a sparse tile of more than 16 rows one column a thread, within 32
// KB of shared memory), the staged rows above.
template <int LOAD>
struct NormPath {
  static int run(NormCall c) {
    const int m = c.k.m;
    if (m <= 8) {
      if constexpr (LOAD == LOAD_SPARSE)
        if (c.a->n > 16)
          return m <= 4 ? norm_regs<LOAD, 4, 1>(c) : norm_regs<LOAD, 8, 1>(c);
      return m <= 4 ? norm_regs<LOAD, 4, vec_width(LOAD, 4)>(c)
                    : norm_regs<LOAD, 8, vec_width(LOAD, 8)>(c);
    }
    if (m <= 16) return norm_tiles<LOAD, 16>(c);
    if (m <= 32) return norm_tiles<LOAD, 32>(c);
    return norm_tiles<LOAD, 64>(c);
  }
};

template <int LOAD, int V>
static int launch_weighted_sum(const Src& a, const float* w, float* out,
                               cudaStream_t st) {
  const auto kernel = weighted_sum_kernel<LOAD, V>;
  const size_t smem =
      ((LOAD == LOAD_SPARSE ? (size_t)a.n * TILE * V : 0) +
       4 * (size_t)a.n) * sizeof(float);
  const int resident = resident_grid(kernel, TILE, smem);
  if (resident < 0) return -resident;
  const long long groups = (a.d + TILE * V - 1) / (TILE * V);
  const int blocks = (int)(groups < resident ? groups : resident);
  kernel<<<blocks, TILE, smem, st>>>(a, w, vec_aligned(a, V, out), out);
  return (int)cudaGetLastError();
}

template <int LOAD>
struct WeightedSum {
  static int run(Src a, const float* w, float* out, cudaStream_t st) {
    // a sparse tile of more than 16 rows takes one column a thread, so
    // that it stays within 32 KB of shared memory
    if (LOAD == LOAD_SPARSE && a.n > 16)
      return launch_weighted_sum<LOAD, 1>(a, w, out, st);
    return launch_weighted_sum<LOAD, vec_width(LOAD, 4)>(a, w, out, st);
  }
};

// The grid of pair_gram (kernel 0) or rfa_iter (kernel 1) on the source
// `load`: the blocks resident on the current device at once (negative:
// -(CUDA error)), and in *group the columns a block takes a step (set by
// the path by m); the wrapper launches min(resident, column groups) blocks
// and sizes the workspace for them: (blocks + ceil(blocks / 16), m (m + 1)
// / 2) for pair_gram, (blocks + ceil(blocks / 16), m) for rfa_iter.
extern "C" int norm_agg_grid(int kernel, int load, int n, int m,
                             int bucketed, int* group) {
  if (!bucketed) m = n;
  if ((kernel != KERNEL_GRAM && kernel != KERNEL_RFA) || load < 0 ||
      load > LOAD_BF16_WIRE || n < 1 || n > 64 || m < 1 || m > 64)
    return -(int)cudaErrorInvalidValue;
  Src a{};
  a.n = n;
  a.load = load;
  NormArgs k{};
  k.m = m;
  return with_load<NormPath>(load, NormCall{kernel, &a, k, 0, nullptr,
                                            bucketed != 0, false, group});
}

static int norm_launch(int kernel, const Src& a, const NormArgs& k,
                       int blocks, void* stream) {
  if (a.n > 64 || k.m < 1 || k.m > 64 || blocks < 1 ||
      blocks > FINISH_GROUP * FINISH_MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  return with_load<NormPath>(
      a.load, NormCall{kernel, &a, k, blocks, (cudaStream_t)stream,
                       k.w_mat != nullptr, true, nullptr});
}

// The launch entry points enqueue on `stream` and return cudaGetLastError()
// (0 on success), for the source `load` (a LOAD_* code). `m` is W's row
// count (ignored without W). The sparse wire needs no row pointers.

// One launch: the blocks' partial Grams and their groups' sums in `part`
// (blocks + ceil(blocks / 16), m (m + 1) / 2), G in out (m, m).
// `tickets` (finish_tickets(),) uint32 starts at zero and is left at
// zero; no two launches in flight at once may share it.
extern "C" int pair_gram_launch(SRC_PARAMS, const float* w_mat, int m,
                                int blocks, float* part, float* out,
                                unsigned* tickets, void* stream) {
  const Src a = make_src(SRC_ARGS);
  return norm_launch(KERNEL_GRAM, a,
                     NormArgs{w_mat, w_mat ? m : n, nullptr, nullptr, 0,
                              part, out, tickets},
                     blocks, stream);
}

// One launch: z (d,) where `z` is not null, sq (m,); `part` (blocks +
// ceil(blocks / 16), m) and `tickets` as pair_gram_launch's.
extern "C" int rfa_iter_launch(SRC_PARAMS, const float* w_mat, int m,
                               const float* w, int blocks, float* part,
                               float* z, float* sq, unsigned* tickets,
                               void* stream) {
  const Src a = make_src(SRC_ARGS);
  return norm_launch(KERNEL_RFA, a,
                     NormArgs{w_mat, w_mat ? m : n, w, z, 0, part, sq,
                              tickets},
                     blocks, stream);
}

extern "C" int weighted_sum_launch(SRC_PARAMS, const float* w, float* out,
                                   void* stream) {
  const Src a = make_src(SRC_ARGS);
  return with_load<WeightedSum>(load, a, w, out, (cudaStream_t)stream);
}
