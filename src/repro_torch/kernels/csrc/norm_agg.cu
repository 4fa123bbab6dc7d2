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
// participation, the (n,) validity select, through the block load of
// agg_prologue.cuh, so neither the attacked nor the bucketed stack is
// written to device memory. The masked cases change the load alone: the
// drivers apply the bucket validity to the weights and the scores.
//
// Bound: device-memory bytes. Each pass reads the stack (or the wire
// payload) and mean / std once; the Gram adds m(m+1) flops per column, and
// W x 2 m n, which stay below the float32 rate up to m = n = 64.
//
// Design. On the TPU, pair_gram and rfa_iter accumulate over d into a
// revisited output block along a sequential grid. Blocks on the card run in
// any order, so a fixed grid of blocks (as many as are resident at once)
// loops over the columns; each block keeps its partial Gram, or its per-row
// partial sums of squares, on chip and writes them once to a (blocks, ...)
// workspace. No floating-point atomics: every sum is taken in a fixed
// order, so a call repeats bit for bit, and Krum's argmin and RFA's
// trajectory with it.
//   pair_gram: one launch on the register load of agg_prologue.cuh (the
//     looping grid of robust_agg.cu's register path: V columns a thread
//     read with loads of up to 16 bytes, the rows streamed through
//     registers into the bucket sums, the sparse wire's bounds found on the
//     card). Up to 8 bucketed rows each thread keeps the m(m+1)/2 pair
//     products in registers across every column it visits; above, the
//     attacked and the bucketed tile are staged in shared memory (W x
//     skips the workers of zero weight where a column is finite) and each
//     thread adds an 8 x 8 tile of the upper triangle over a slice of its
//     columns (16 shared loads for 64 fused multiply-adds). The last blocks to
//     finish (tickets after a __threadfence) sum the partials, a group of
//     16 blocks and then the groups, each in a fixed order, and write G
//     mirrored, so G is symmetric bit for bit, as Krum's tied nearest
//     neighbours need. No TF32: its rounding would break the Gram's
//     tolerance and those ties.
//   rfa_iter: one thread per column of a 128-column tile (the tile load
//     of agg_prologue.cuh, the sparse wire through row pointers) computes
//     z_c (in the reference's compiled order, weighted_col) and writes it,
//     then adds (xb_bc - z_c)^2 into its own column of an (m, TILE)
//     accumulator; at the end each row of it is summed by one warp, and a
//     second launch sums the blocks' rows in block order.
//   weighted_sum: a looping grid with the register load of
//     agg_prologue.cuh (several columns a thread, the rows streamed
//     through registers, the sparse wire found on the card, as
//     robust_agg.cu's register path); no W and no reduction across
//     blocks.

#include "agg_prologue.cuh"

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

// --- pair_gram: one launch ------------------------------------------------

// A pair_gram launch's tickets, `tickets` (GRAM_TICKETS,): the blocks that
// have written their partial Gram, a count for each group of GRAM_GROUP
// blocks, then the groups that have summed theirs; the last to count itself
// sets the count back to 0. The wrapper keeps one zeroed buffer for each
// stream (launches on one stream run one after another; launches on two
// streams never share one).
constexpr int GRAM_GROUP = 16;
constexpr int GRAM_MAX_GROUPS = 1024;
constexpr int GRAM_TICKETS = GRAM_MAX_GROUPS + 1;

// q of the pair (i, j), i <= j, in the row-major upper triangle of m x m.
__host__ __device__ inline int pair_index(int i, int j, int m) {
  return i * m - i * (i - 1) / 2 + (j - i);
}

// This block's partial upper triangle s_part (pairs,) into part[blockIdx.x]
// of part (blocks + groups, pairs). The last block of each group of
// GRAM_GROUP to finish (a ticket of `tickets` after a __threadfence) sums
// the group's partials in block order into part[blocks + group]; the last
// group to finish sums the groups' in group order and writes G mirrored.
// Each entry is one fixed-order sum, a thread an entry, with no
// floating-point atomics: a call repeats bit for bit, and G is symmetric
// bit for bit. A grid of one block (the main path's narrow leaves) writes
// G at once.
// (Two levels, so that no one block reads every block's partials: at
// m = 64 those are 2080 floats from each of some 260 blocks.)
__device__ __forceinline__ void gram_finish(const float* s_part, int m,
                                            float* part, float* out,
                                            unsigned* tickets) {
  __shared__ bool s_last;
  const int pairs = m * (m + 1) / 2, tid = threadIdx.x;
  const int blocks = gridDim.x;
  const int groups = (blocks + GRAM_GROUP - 1) / GRAM_GROUP;
  const int grp = blockIdx.x / GRAM_GROUP, first = grp * GRAM_GROUP;
  const int in_grp = min(GRAM_GROUP, blocks - first);
  if (blocks == 1) {                   // a narrow call: G is this block's
    for (int q = tid; q < pairs; q += blockDim.x) {
      int i, j;
      pair_of(q, m, &i, &j);
      out[i * m + j] = s_part[q];
      out[j * m + i] = s_part[q];
    }
    return;
  }
  for (int q = tid; q < pairs; q += blockDim.x)
    part[(long long)blockIdx.x * pairs + q] = s_part[q];
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[grp], 1u) == in_grp - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* gpart = part + (long long)blocks * pairs;
  for (int q = tid; q < pairs; q += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < GRAM_GROUP; ++b)
      if (b < in_grp)
        acc = __fadd_rn(acc, __ldcg(part + (long long)(first + b) * pairs + q));
    gpart[(long long)grp * pairs + q] = acc;
  }
  if (tid == 0) tickets[grp] = 0;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[GRAM_MAX_GROUPS], 1u) == groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int q = tid; q < pairs; q += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int g = 0; g < groups; ++g)
      acc = __fadd_rn(acc, __ldcg(gpart + (long long)g * pairs + q));
    int i, j;
    pair_of(q, m, &i, &j);
    out[i * m + j] = acc;
    out[j * m + i] = acc;
  }
  if (tid == 0) tickets[GRAM_MAX_GROUPS] = 0;
}

// Blocks an SM must hold where the register path's accumulators are few
// (four bucket sums of at most four columns, 73 registers a thread).
#define GRAM_MIN_BLOCKS(mb, v) ((mb) == 4 && (v) <= 4 ? 7 : 1)

// m <= MB <= 8 bucketed rows: the register load (V columns a thread, the
// rows streamed into the MB bucket sums, one fused multiply-add a term in
// worker order), then each of the MB (MB + 1) / 2 pair products added into
// its register, column by column. Shared memory: the sparse tile
// (n, TILE * V), W (MB, n) zero-padded past m, the byzantine mask and the
// validity (n,), the warps' sums (TILE / 32, P), the block's Gram (P,) and
// the sparse walk's positions (n,).
template <int LOAD, int MB, int V>
__global__ void __launch_bounds__(TILE, GRAM_MIN_BLOCKS(MB, V))
    pair_gram_regs(Src a, const float* w_mat, int m, int aligned,
                   float* part, float* out, unsigned* tickets) {
  constexpr int GROUP = TILE * V;
  constexpr int P = MB * (MB + 1) / 2;
  constexpr int WARPS = TILE / 32;
  extern __shared__ float4 smem4[];
  float* s_tile = reinterpret_cast<float*>(smem4);
  float* s_w = s_tile + (LOAD == LOAD_SPARSE ? a.n * GROUP : 0);
  float* s_mask = s_w + (w_mat ? MB * a.n : 0);
  float* s_valid = s_mask + a.n;
  float* s_red = s_valid + a.n;
  float* s_part = s_red + WARPS * P;
  int* s_pos = reinterpret_cast<int*>(s_part + P);
  const int tid = threadIdx.x;
  const long long groups = (a.d + GROUP - 1) / GROUP;
  const long long g0 = groups * blockIdx.x / gridDim.x;
  const long long g1 = groups * (blockIdx.x + 1) / gridDim.x;
  if (w_mat)
    for (int q = tid; q < MB * a.n; q += TILE)
      s_w[q] = q < m * a.n ? w_mat[q] : 0.f;
  for (int q = tid; q < a.n; q += TILE) {
    s_mask[q] = a.mask ? mask_at(a.mask, q, a.u8_masks & MASK_U8) : 0.f;
    s_valid[q] = a.valid ? mask_at(a.valid, q, a.u8_masks & VALID_U8) : 1.f;
  }
  __syncthreads();
  if (LOAD == LOAD_SPARSE) sparse_starts(a, g0 * GROUP, s_valid, s_pos);
  float gp[P];
#pragma unroll
  for (int p = 0; p < P; ++p) gp[p] = 0.f;

  // as in robust_agg_regs: a contiguous range for the sparse walk, the grid
  // strided on the other loads
  constexpr bool RANGE = LOAD == LOAD_SPARSE;
  constexpr int UNROLL = V <= 4 ? 4 : 2;
  const long long step = RANGE ? 1 : gridDim.x;
  for (long long g = RANGE ? g0 : blockIdx.x; g < (RANGE ? g1 : groups);
       g += step) {
    const long long c0 = g * GROUP + (long long)tid * V;
    const bool full = aligned && c0 + V <= a.d;
    float mu[V], sd[V], f[V], base1[V], xb[MB][V];
#pragma unroll
    for (int v = 0; v < V; ++v) mu[v] = sd[v] = base1[v] = 0.f;
    if (c0 < a.d) {        // issued before the walk, which hides them
      forged_load<V>(a, c0, full, mu, sd);
      if (a.base && a.base_rows == 1)
        load_row<float, V>(a.base + c0, full, a.d - c0, base1);
    }
    if (LOAD == LOAD_SPARSE)
      scatter_group(a, g * GROUP, GROUP, s_valid, s_pos, s_tile);
    if (c0 < a.d) {
      forged_finish<V>(a, mu, sd, f);
#pragma unroll
      for (int b = 0; b < MB; ++b)
#pragma unroll
        for (int v = 0; v < V; ++v) xb[b][v] = 0.f;
      if (w_mat) {
#pragma unroll UNROLL
        for (int j = 0; j < a.n; ++j) {
          float q[V];
          row_values<LOAD, V>(a, j, c0, full, s_tile, GROUP, tid * V, base1,
                              q);
          attack_row<V>(a, s_mask[j], s_valid[j], f, q);
#pragma unroll
          for (int b = 0; b < MB; ++b) {
            const float wb = s_w[b * a.n + j];
#pragma unroll
            for (int v = 0; v < V; ++v)
              xb[b][v] = __fmaf_rn(wb, q[v], xb[b][v]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < MB; ++j) {
          if (j >= a.n) break;
          float q[V];
          row_values<LOAD, V>(a, j, c0, full, s_tile, GROUP, tid * V, base1,
                              q);
          attack_row<V>(a, s_mask[j], s_valid[j], f, q);
#pragma unroll
          for (int v = 0; v < V; ++v) xb[j][v] = q[v];
        }
      }
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
  const int warp = tid >> 5, lane = tid & 31;
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
  gram_finish(s_part, m, part, out, tickets);
}

// The shared-memory path's layout: 8 x 8 tiles of the upper triangle, TP of
// them, each split over S column slices, one (tile, slice) a thread; rows
// staged RS floats apart (RS = TILE + 1, so that the rows of a tile fall in
// other banks).
template <int MB>
struct GramTiles {
  static constexpr int MT = MB / 8;              // 8-row blocks
  static constexpr int TP = MT * (MT + 1) / 2;   // tiles I <= J
  static constexpr int S = TILE / TP;            // column slices a tile
  static constexpr int RS = TILE + 1;            // floats a staged row
  static constexpr int P = MB * (MB + 1) / 2;
};

// Shared-memory words of pair_gram_smem: the sparse tile (n, TILE); the
// staged rows: without W the attacked rows (MB, RS), zero past n; with W
// the attacked rows (n, RS) and the bucket sums (MB, RS); the threads'
// tiles (TP * S, 64) take their place at the end; with W, the terms of
// W x (MB * n, two words each: the worker's row offset, the bucket and
// whether the term ends its bucket; the weight); the mask and validity
// (n,); the block's Gram (P,); the columns' non-finite flags (TILE,); the
// walk's positions (n,); the buckets' first terms (MB + 1,).
struct GramWords {
  size_t tile, rows, terms, total;
};

template <int MB>
__host__ __device__ inline GramWords gram_words(int n, bool bucketed,
                                                bool sparse) {
  using L = GramTiles<MB>;
  GramWords g;
  g.tile = sparse ? (size_t)n * TILE : 0;
  const size_t rows = (size_t)(bucketed ? n + MB : MB) * L::RS;
  const size_t tiles = (size_t)L::TP * L::S * 64;
  g.rows = ((rows > tiles ? rows : tiles) + 3) / 4 * 4;
  g.terms = bucketed ? 2 * (size_t)MB * n : 0;
  g.total = g.tile + g.rows + g.terms + 2 * (size_t)n + L::P + TILE + n +
            MB + 1;
  return g;
}

// 8 < m <= MB <= 64 bucketed rows, a group of TILE columns at a time:
// the attacked rows into shared memory (each warp every fourth row, a lane
// four columns with one load of up to 16 bytes, all of a thread's n / 4
// loads issued before the first is used); with W, a thread a column: each
// bucket's sum over the workers of nonzero weight, one fused multiply-add
// a term in worker order, from a list of W's nonzero terms built once a
// block (a term of weight zero adds exactly nothing where the column is
// finite, but 0 * inf or 0 * NaN is NaN: a column with a value that is not
// finite, flagged in the load, takes every worker, W read from device
// memory); then each thread adds its tile's 8 x 8 products over its column
// slice, 16 shared loads for 64 fused multiply-adds.
constexpr int ROWS_A_WARP = 64 / (TILE / 32);   // MAX_FUSED_WORKERS rows

template <int LOAD, int MB>
__global__ void __launch_bounds__(TILE, 3)
    pair_gram_smem(Src a, const float* w_mat, int m, int aligned,
                   float* part, float* out, unsigned* tickets) {
  using L = GramTiles<MB>;
  constexpr int WARPS = TILE / 32;
  const bool bucketed = w_mat != nullptr;
  const GramWords gw = gram_words<MB>(a.n, bucketed, LOAD == LOAD_SPARSE);
  extern __shared__ float4 smem4[];
  float* s_tile = reinterpret_cast<float*>(smem4);
  float* s_x = s_tile + gw.tile;
  float* s_xb = bucketed ? s_x + (size_t)a.n * L::RS : s_x;
  int2* s_terms = reinterpret_cast<int2*>(s_x + gw.rows);
  float* s_mask = s_x + gw.rows + gw.terms;
  float* s_valid = s_mask + a.n;
  float* s_part = s_valid + a.n;
  int* s_bad = reinterpret_cast<int*>(s_part + L::P);
  int* s_pos = s_bad + TILE;
  int* s_first = s_pos + a.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long groups = (a.d + TILE - 1) / TILE;
  const long long g0 = groups * blockIdx.x / gridDim.x;
  const long long g1 = groups * (blockIdx.x + 1) / gridDim.x;
  int n_terms = 0;
  if (bucketed) {          // W's nonzero terms, by bucket, in worker order
    for (int b = tid; b < m; b += TILE) {
      int cnt = 0;
      for (int j = 0; j < a.n; ++j) cnt += w_mat[b * a.n + j] != 0.f;
      s_first[b + 1] = cnt;
    }
    __syncthreads();
    if (tid == 0) {
      s_first[0] = 0;
      for (int b = 0; b < m; ++b) s_first[b + 1] += s_first[b];
    }
    __syncthreads();
    for (int b = tid; b < m; b += TILE) {
      int t = s_first[b];
      for (int j = 0; j < a.n; ++j) {
        const float wv = w_mat[b * a.n + j];
        if (wv != 0.f) {
          const bool last = t + 1 == s_first[b + 1];
          s_terms[t++] = make_int2(j * L::RS | b << 16 | (last ? 1 << 30 : 0),
                                   __float_as_int(wv));
        }
      }
    }
    n_terms = s_first[m];
  }
  // the bucket sums of a bucket without terms, and rows past m (past n
  // without W), stay zero
  for (int q = (bucketed ? 0 : a.n) * L::RS + tid; q < MB * L::RS; q += TILE)
    s_xb[q] = 0.f;
  for (int q = tid; q < TILE; q += TILE) s_bad[q] = 0;
  for (int q = tid; q < a.n; q += TILE) {
    s_mask[q] = a.mask ? mask_at(a.mask, q, a.u8_masks & MASK_U8) : 0.f;
    s_valid[q] = a.valid ? mask_at(a.valid, q, a.u8_masks & VALID_U8) : 1.f;
  }
  __syncthreads();
  if (LOAD == LOAD_SPARSE) sparse_starts(a, g0 * TILE, s_valid, s_pos);
  const bool active = tid < L::TP * L::S;
  const int tp = active ? tid / L::S : 0, slice = tid % L::S;
  int ti, tj;
  pair_of(tp, L::MT, &ti, &tj);
  const float* ri0 = s_xb + 8 * ti * L::RS;
  const float* rj0 = s_xb + 8 * tj * L::RS;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;

  constexpr bool RANGE = LOAD == LOAD_SPARSE;   // as in pair_gram_regs
  const long long step = RANGE ? 1 : gridDim.x;
  for (long long g = RANGE ? g0 : blockIdx.x; g < (RANGE ? g1 : groups);
       g += step) {
    const long long c0 = g * TILE + 4 * lane;   // this lane's 4 columns
    const bool in = c0 < a.d, full = aligned && c0 + 4 <= a.d;
    float mu[4], sd[4], f[4], base1[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) mu[v] = sd[v] = base1[v] = 0.f;
    if (in) {
      forged_load<4>(a, c0, full, mu, sd);
      if (a.base && a.base_rows == 1)
        load_row<float, 4>(a.base + c0, full, a.d - c0, base1);
    }
    // the last group's readers of the staged rows are done (the walk's
    // first barrier, on the sparse wire)
    if (LOAD == LOAD_SPARSE)
      scatter_group(a, g * TILE, TILE, s_valid, s_pos, s_tile);
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
        row_values<LOAD, 4>(a, j, c0, full, s_tile, TILE, 4 * lane, base1,
                            q[r]);
    }
    forged_finish<4>(a, mu, sd, f);
#pragma unroll
    for (int r = 0; r < ROWS_A_WARP; ++r) {
      const int j = warp + r * WARPS;
      if (j >= a.n) break;
      if (in) attack_row<4>(a, s_mask[j], s_valid[j], f, q[r]);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        s_x[j * L::RS + 4 * lane + v] = q[r][v];
        if (bucketed && !(fabsf(q[r][v]) <= 3.402823466e38f))
          atomicOr(&s_bad[4 * lane + v], 1);
      }
    }
    __syncthreads();
    if (bucketed) {
      const float* xc = s_x + tid;
      if (!s_bad[tid]) {
        float acc_b = 0.f;
#pragma unroll 4
        for (int t = 0; t < n_terms; ++t) {
          const int2 tm = s_terms[t];
          acc_b = __fmaf_rn(__int_as_float(tm.y), xc[tm.x & 0xFFFF], acc_b);
          if (tm.x & 1 << 30) {
            s_xb[(tm.x >> 16 & 63) * L::RS + tid] = acc_b;
            acc_b = 0.f;
          }
        }
      } else {
        for (int b = 0; b < m; ++b) {
          float acc_b = 0.f;
          for (int j = 0; j < a.n; ++j)
            acc_b = __fmaf_rn(__ldg(w_mat + b * a.n + j), xc[j * L::RS],
                              acc_b);
          s_xb[b * L::RS + tid] = acc_b;
        }
        s_bad[tid] = 0;
      }
      __syncthreads();
    }
    if (active)
      for (int cc = slice; cc < TILE; cc += L::S) {
        float ri[8], rj[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          ri[r] = ri0[r * L::RS + cc];
          rj[r] = rj0[r * L::RS + cc];
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s = 0; s < 8; ++s)
            acc[r][s] = __fmaf_rn(ri[r], rj[s], acc[r][s]);
      }
  }
  __syncthreads();
  float* s_red = s_x;                  // the staged rows are done with
  if (active) {
    float* mine = s_red + tid * 64;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) mine[r * 8 + s] = acc[r][s];
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
  gram_finish(s_part, m, part, out, tickets);
}

template <int LOAD>
__global__ void __launch_bounds__(TILE) rfa_iter_partial(
    Src a, const float* w_mat, int m, const float* w, float* z,
    float* part) {
  extern __shared__ float smem[];
  const bool bucketed = w_mat != nullptr;
  const Smem s = carve(smem, a.n, m, bucketed);
  float* s_acc = s.rest;                    // (m, TILE) column sums
  float* s_wr = s_acc + m * TILE;           // (m,) Weiszfeld weights
  const int tid = threadIdx.x;
  stage_consts(a, w_mat, m, s);
  for (int q = tid; q < m; q += TILE) s_wr[q] = w[q];
  for (int b = 0; b < m; ++b) s_acc[b * TILE + tid] = 0.f;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const float* rows = load_tile<LOAD>(a, s, bucketed, m, tile);
    const long long c = (long long)tile * TILE + tid;
    if (c >= a.d) continue;
    const float zc = weighted_col(rows + tid, s_wr, m);
    z[c] = zc;
    for (int b = 0; b < m; ++b) {
      const float e = __fsub_rn(rows[b * TILE + tid], zc);
      s_acc[b * TILE + tid] = __fmaf_rn(e, e, s_acc[b * TILE + tid]);
    }
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int b = warp; b < m; b += TILE / 32) {
    const float* r = s_acc + b * TILE;
    float v = __fadd_rn(__fadd_rn(r[lane], r[lane + 32]),
                        __fadd_rn(r[lane + 64], r[lane + 96]));
    v = warp_sum(v, 32);
    if (lane == 0) part[(long long)blockIdx.x * m + b] = v;
  }
}

// sq = sum of the blocks' (m,) partials, in block order.
__global__ void rows_finish(const float* part, int blocks, int m,
                            float* sq) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= m) return;
  float acc = 0.f;
  for (int k = 0; k < blocks; ++k)
    acc = __fadd_rn(acc, part[(long long)k * m + b]);
  sq[b] = acc;
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

static size_t rfa_smem(int n, int m, bool bucketed) {
  return (prologue_words(n, m, bucketed) + (size_t)m * TILE + m) *
         sizeof(float);
}

template <int LOAD>
struct RfaBlocks {
  static int run(size_t smem) {
    return resident_grid(rfa_iter_partial<LOAD>, TILE, smem);
  }
};

// One pair_gram call: with `launch`, its launch (returns the CUDA error);
// without, the query of its shape (returns the blocks resident at once, or
// -(CUDA error), and sets *group to the columns a block takes a step).
struct GramCall {
  const Src* a;
  const float* w_mat;
  int m, blocks;
  float *part, *out;
  unsigned* tickets;
  cudaStream_t st;
  bool bucketed, launch;
  int* group;
};

template <int LOAD, int MB, int V>
static int gram_regs(const GramCall& c) {
  const auto kernel = pair_gram_regs<LOAD, MB, V>;
  constexpr int P = MB * (MB + 1) / 2;
  const size_t n = c.a->n;
  const size_t smem = ((LOAD == LOAD_SPARSE ? n * TILE * V : 0) +
                       (c.bucketed ? MB * n : 0) + 3 * n +
                       (TILE / 32 + 1) * (size_t)P) * sizeof(float);
  const int resident = resident_grid(kernel, TILE, smem);
  if (!c.launch) {
    *c.group = TILE * V;
    return resident;
  }
  if (resident < 0) return -resident;
  kernel<<<c.blocks, TILE, smem, c.st>>>(
      *c.a, c.w_mat, c.m, vec_aligned(*c.a, V, nullptr), c.part, c.out,
      c.tickets);
  return (int)cudaGetLastError();
}

template <int LOAD, int MB>
static int gram_tiles(const GramCall& c) {
  const auto kernel = pair_gram_smem<LOAD, MB>;
  const size_t smem =
      gram_words<MB>(c.a->n, c.bucketed, LOAD == LOAD_SPARSE).total *
      sizeof(float);
  const int resident = resident_grid(kernel, TILE, smem);
  if (!c.launch) {
    *c.group = TILE;
    return resident;
  }
  if (resident < 0) return -resident;
  kernel<<<c.blocks, TILE, smem, c.st>>>(
      *c.a, c.w_mat, c.m, vec_aligned(*c.a, 4, nullptr), c.part, c.out,
      c.tickets);
  return (int)cudaGetLastError();
}

// The path by m: pair products in registers up to 8 rows (a sparse tile of
// more than 16 rows one column a thread, within 32 KB of shared memory),
// 8 x 8 tiles from shared memory above.
template <int LOAD>
struct PairGram {
  static int run(GramCall c) {
    if (c.m <= 8) {
      if constexpr (LOAD == LOAD_SPARSE)
        if (c.a->n > 16)
          return c.m <= 4 ? gram_regs<LOAD, 4, 1>(c) : gram_regs<LOAD, 8, 1>(c);
      return c.m <= 4 ? gram_regs<LOAD, 4, vec_width(LOAD, 4)>(c)
                      : gram_regs<LOAD, 8, vec_width(LOAD, 8)>(c);
    }
    if (c.m <= 16) return gram_tiles<LOAD, 16>(c);
    if (c.m <= 32) return gram_tiles<LOAD, 32>(c);
    return gram_tiles<LOAD, 64>(c);
  }
};

template <int LOAD>
struct RfaIter {
  static int run(Src a, const float* w_mat, int m, const float* w,
                 int blocks, float* part, float* z, float* sq, size_t smem,
                 cudaStream_t st) {
    const int got = resident_grid(rfa_iter_partial<LOAD>, TILE, smem);
    if (got < 0) return -got;
    cudaError_t err;
    rfa_iter_partial<LOAD><<<blocks, TILE, smem, st>>>(a, w_mat, m, w, z,
                                                       part);
    if ((err = cudaGetLastError())) return (int)err;
    rows_finish<<<(m + 63) / 64, 64, 0, st>>>(part, blocks, m, sq);
    return (int)cudaGetLastError();
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

extern "C" int norm_agg_tile() { return TILE; }

enum { KERNEL_GRAM = 0, KERNEL_RFA = 1 };

// The grid of pair_gram (kernel 0) or rfa_iter (kernel 1) on the source
// `load`: the blocks resident on the current device at once (negative:
// -(CUDA error)), and in *group the columns a block takes a step (pair_gram
// sets it by its path by m); the wrapper launches min(resident, column
// groups) blocks and sizes the workspace for them: (blocks + ceil(blocks /
// 16), m (m + 1) / 2) for pair_gram, (blocks, m) for rfa_iter.
extern "C" int norm_agg_grid(int kernel, int load, int n, int m,
                             int bucketed, int* group) {
  if (!bucketed) m = n;
  if (load < 0 || load > LOAD_BF16_WIRE || n < 1 || n > 64 || m < 1 ||
      m > 64)
    return -(int)cudaErrorInvalidValue;
  if (kernel == KERNEL_RFA) {
    *group = TILE;
    return with_load<RfaBlocks>(load, rfa_smem(n, m, bucketed));
  }
  Src a{};
  a.n = n;
  a.load = load;
  return with_load<PairGram>(load, GramCall{&a, nullptr, m, 0, nullptr,
                                            nullptr, nullptr, nullptr,
                                            bucketed != 0, false, group});
}

// The launch entry points enqueue on `stream` and return cudaGetLastError()
// (0 on success), for the source `load` (a LOAD_* code). `m` is W's row
// count (ignored without W); `part` is a (blocks, ...) workspace.

// Words of the tickets buffer that pair_gram_launch takes.
extern "C" int pair_gram_tickets() { return GRAM_TICKETS; }

// One launch: the blocks' partial Grams and their groups' sums in `part`
// (blocks + ceil(blocks / 16), m (m + 1) / 2), G in out (m, m).
// `tickets` (pair_gram_tickets(),) uint32 starts at zero and is left at
// zero; no two launches in flight at once may share it. The sparse wire
// needs no row pointers (`starts` is ignored).
extern "C" int pair_gram_launch(SRC_PARAMS, const float* w_mat, int m,
                                int blocks, float* part, float* out,
                                unsigned* tickets, void* stream) {
  const Src a = make_src(SRC_ARGS);
  if (!w_mat) m = n;
  if (n > 64 || m < 1 || m > 64 || blocks < 1 ||
      blocks > GRAM_GROUP * GRAM_MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  return with_load<PairGram>(
      load, GramCall{&a, w_mat, m, blocks, part, out, tickets,
                     (cudaStream_t)stream, w_mat != nullptr, true, nullptr});
}

extern "C" int rfa_iter_launch(SRC_PARAMS, const float* w_mat, int m,
                               const float* w, int blocks, float* part,
                               float* z, float* sq, void* stream) {
  const Src a = make_src(SRC_ARGS);
  if (!w_mat) m = n;
  return with_load<RfaIter>(load, a, w_mat, m, w, blocks, part, z, sq,
                            rfa_smem(n, m, w_mat != nullptr),
                            (cudaStream_t)stream);
}

// The sparse wire needs no row pointers here (`starts` is ignored).
extern "C" int weighted_sum_launch(SRC_PARAMS, const float* w, float* out,
                                   void* stream) {
  const Src a = make_src(SRC_ARGS);
  return with_load<WeightedSum>(load, a, w, out, (cudaStream_t)stream);
}
