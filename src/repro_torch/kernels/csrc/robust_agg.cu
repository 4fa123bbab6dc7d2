// Coordinate-wise robust aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/robust_agg.py::robust_agg together
// with its input prologue repro/kernels/norm_agg.py::_prologue and every
// branch of repro/kernels/quantize.py::recon_block (_recon_sparse_block,
// int8, sign, bf16). One launch turns n <= 64 worker rows into one
// aggregate row:
//
//   load      dense (n, d) float32 or bfloat16 stack, or a wire payload
//             plus a base of 0, 1 or n rows: sparse (vals/idx (n, k), each
//             idx row ascending), int8 levels with a norm per 256
//             coordinates, int8 signs with a scale per row, or bfloat16
//             values; each wire value rounds through the candidate dtype
//             before and after the base add;
//   attack    the omniscient BF / ALIE / IPM attack replaces the byzantine
//             rows, from the good workers' per-coordinate mean / std;
//   guard     under the fault guard or partial participation, rows whose
//             (n,) `valid` entry is not > 0 become zeros;
//   bucket    xb = W x with the (m, n) Alg. 2 bucket operator (the masked
//             operator renormalizes each bucket over its valid members);
//   rule      mean, median or trimmed mean over the m rows of each column,
//             or, given the (m,) bucket validity `bvalid`, the masked rule
//             (the twin of robust_agg.py::_masked_coord_rule_block): with
//             c = the valid rows, counted in the block from `bvalid`, the
//             mean divides the sum of all m rows (invalid ones are zero) by
//             max(c, 1), a true division by a count known at run time; the
//             median and the trimmed mean fill invalid rows with +inf, sort,
//             and take ranks (c-1)/2 and c/2, or sum ranks [t, c - t) with
//             t = min(trim, (c-1)/2), the others as zeros, in XLA's order,
//             divided by max(c - 2t, 1). A rank is read as the reference's
//             where-sum reads it, 0 + v, so -0.0 comes out +0.0.
//
// Bound: device-memory bytes. Each column's work is O(m^2) compares on
// values already on chip, so the least time is the bytes moved (the stack
// or the wire payload: 4, 2, 1 or about 1 + 4/256 bytes a value, or 8 a
// kept sparse entry; the base rows, mean and std, and the output) over the
// memory rate. Neither the attacked nor the bucketed stack (nor, on the
// wire, the dense candidates) is ever written to device memory.
//
// Design. A looping grid: as many blocks as are resident, with W and the
// masks staged in shared memory once a block; a block walks a contiguous
// range of column groups on the sparse wire (its search runs once), and
// strides the grid on the other loads (the blocks resident at once then
// read neighbouring groups). Masks come as bool bytes or float32. Two
// paths:
//   registers (m <= 16; a sparse wire of n <= 16 rows): a thread owns V
//     consecutive columns (4 float32, 8 bfloat16 or int8: one load of up
//     to 16 bytes a row, neighbouring threads on neighbouring addresses;
//     4 when the bound MB in {4, 8, 16} on m passes 4, so that MB x V <=
//     64 accumulators, without spills; where MB x V <= 16 at most 64
//     registers a thread, so that 8 blocks fit an SM, or 72 on the sparse
//     wire, 7 blocks, which its walk needs to stay free of spills) and
//     streams the n rows through registers: the load,
//     the attack select and the validity elementwise, then one fused
//     multiply-add a term into each of the MB bucket sums, in worker order
//     (without W the rows are the sums). The sort is sort_column's
//     insertion sort unrolled into compare-exchanges, the ranks picked
//     without a dynamic index.
//   shared memory (m > 16): a thread per column of a 128-column group, the
//     attacked (n, TILE) and bucketed (m, TILE) stacks in shared memory, the
//     rule over the column there.
// The sparse wire has no row pointers: each block finds where its range
// starts in every worker's idx row with one warp-wide 32-ary search
// (warp_lower_bound2), then scatters each group's entries into a
// zero-filled shared tile, each warp walking two workers' rows forward 128
// entries a step (RandK and TopK indices of a worker are distinct: no
// atomics); the group's mean, std and shared base are loaded before the
// walk, so their latency hides behind it.
//
// Arithmetic follows the reference's compiled float32 code with explicitly
// rounded intrinsics, so the compiler can neither fuse nor reorder it: the
// ALIE value mean - z*std is one fused multiply-add, W x one fused
// multiply-add a term in worker order, a mean a sum in XLA's order
// (row_sum) times the rounded reciprocal of the count; both paths take the
// same roundings, so neither the path nor V changes a bit of the result.

#include "agg_prologue.cuh"

enum { RULE_MEAN = 0, RULE_MEDIAN = 1, RULE_TRIMMED = 2 };

// Sum of the `cnt` rows v[0], v[TILE], ... of one column (cnt <= 64) in the
// order the reference's compiled float32 code sums rows on the CPU
// (aggregators.xla_sum_rows): in order up to 32 rows; above, two windows
// cut at 32 - (64 - cnt) / 2 (the zero rows XLA pads with on both sides
// add nothing), each summed in order, then the two window sums added.
// Rows outside [keep_lo, keep_hi) add as zeros (the masked trimmed mean's
// where-sum).
__device__ __forceinline__ float row_sum(const float* v, int cnt,
                                         int keep_lo = 0,
                                         int keep_hi = 1 << 30) {
  const int cut = cnt <= XLA_WINDOW ? cnt
                                    : XLA_WINDOW - (2 * XLA_WINDOW - cnt) / 2;
  float lo = 0.f, hi = 0.f;
  for (int i = 0; i < cut; ++i)
    lo = __fadd_rn(lo, i >= keep_lo && i < keep_hi ? v[i * TILE] : 0.f);
  if (cut == cnt) return lo;
  for (int i = cut; i < cnt; ++i)
    hi = __fadd_rn(hi, i >= keep_lo && i < keep_hi ? v[i * TILE] : 0.f);
  return __fadd_rn(lo, hi);
}

// Rank r of a sorted column as the reference's where-sum gathers it: 0 + v
// where 0 <= r < m (so -0.0 reads +0.0), else 0.
__device__ __forceinline__ float rank_at(const float* col, int r, int m) {
  return r >= 0 && r < m ? __fadd_rn(0.f, col[r * TILE]) : 0.f;
}

// floor(a / 2) for a >= -1 (C division truncates toward zero).
__device__ __forceinline__ int half_floor(int a) {
  return a < 0 ? -1 : a / 2;
}

// Insertion sort of one column of `m` rows.
__device__ __forceinline__ void sort_column(float* col, int m) {
  for (int i = 1; i < m; ++i) {
    const float v = col[i * TILE];
    int j = i - 1;
    while (j >= 0 && col[j * TILE] > v) {
      col[(j + 1) * TILE] = col[j * TILE];
      --j;
    }
    col[(j + 1) * TILE] = v;
  }
}

// The masked rule over the m rows of one column (`col` = rows + tid), with
// c valid rows marked in s_bv.
__device__ __forceinline__ float masked_rule(float* col, const float* s_bv,
                                             int m, int c, int rule,
                                             int trim) {
  if (rule == RULE_MEAN)
    return __fdiv_rn(row_sum(col, m), (float)max(c, 1));
  for (int b = 0; b < m; ++b)
    if (!(s_bv[b] > 0.f)) col[b * TILE] = __int_as_float(0x7f800000);
  sort_column(col, m);
  if (rule == RULE_MEDIAN)
    return __fmul_rn(0.5f, __fadd_rn(rank_at(col, half_floor(c - 1), m),
                                     rank_at(col, c / 2, m)));
  const int t = min(trim, half_floor(c - 1));
  return __fdiv_rn(row_sum(col, m, t, c - t), (float)max(c - 2 * t, 1));
}

// --- the register path (m <= 16) ---------------------------------------

// Row r of a register column (r < MB), read without a dynamic index.
template <int MB>
__device__ __forceinline__ float pick(const float (&col)[MB], int r) {
  float v = col[0];
#pragma unroll
  for (int i = 1; i < MB; ++i) v = i == r ? col[i] : v;
  return v;
}

// sort_column in registers: the same insertion sort as unrolled
// compare-exchanges. Row i sinks past row j while row j > row i and stops
// at the first row that is not, so NaN and +-0 land where the shifting
// sort puts them (no fminf / fmaxf, which drop NaN and pick either zero).
template <int MB>
__device__ __forceinline__ void sort_regs(float (&col)[MB], int m) {
#pragma unroll
  for (int i = 1; i < MB; ++i) {
    if (i >= m) break;
    bool moving = true;
#pragma unroll
    for (int j = i - 1; j >= 0; --j) {
      const float lo = col[j], hi = col[j + 1];
      const bool sw = moving && lo > hi;
      col[j] = sw ? hi : lo;
      col[j + 1] = sw ? lo : hi;
      moving = sw;
    }
  }
}

// rank_at in registers.
template <int MB>
__device__ __forceinline__ float rank_regs(const float (&col)[MB], int r,
                                           int m) {
  return r >= 0 && r < m ? __fadd_rn(0.f, pick(col, r)) : 0.f;
}

// The rule over the m <= MB <= 32 rows of one register column, with the
// shared-memory path's arithmetic (row_sum in one window, sort_column,
// rank_at, masked_rule). `c` counts the valid buckets when `masked`.
template <int MB>
__device__ __forceinline__ float rule_regs(float (&col)[MB], int m, int rule,
                                           int trim, bool masked, int c,
                                           const float* s_bv) {
  float lo = 0.f;
  if (masked) {
    if (rule == RULE_MEAN) {
#pragma unroll
      for (int i = 0; i < MB; ++i)
        if (i < m) lo = __fadd_rn(lo, col[i]);
      return __fdiv_rn(lo, (float)max(c, 1));
    }
#pragma unroll
    for (int i = 0; i < MB; ++i)
      if (i < m && !(s_bv[i] > 0.f)) col[i] = __int_as_float(0x7f800000);
    sort_regs(col, m);
    if (rule == RULE_MEDIAN)
      return __fmul_rn(0.5f, __fadd_rn(rank_regs(col, half_floor(c - 1), m),
                                       rank_regs(col, c / 2, m)));
    const int t = min(trim, half_floor(c - 1));
#pragma unroll
    for (int i = 0; i < MB; ++i)
      if (i < m) lo = __fadd_rn(lo, i >= t && i < c - t ? col[i] : 0.f);
    return __fdiv_rn(lo, (float)max(c - 2 * t, 1));
  }
  if (rule == RULE_MEAN) {
#pragma unroll
    for (int i = 0; i < MB; ++i)
      if (i < m) lo = __fadd_rn(lo, col[i]);
    return __fmul_rn(lo, __frcp_rn((float)m));
  }
  sort_regs(col, m);
  if (rule == RULE_MEDIAN) {
    const int h = m / 2;
    return (m & 1) ? pick(col, h)
                   : __fmul_rn(0.5f, __fadd_rn(pick(col, h - 1),
                                               pick(col, h)));
  }
  const int t = min(trim, (m - 1) / 2);
#pragma unroll
  for (int i = 0; i < MB; ++i)
    if (i >= t && i < m - t) lo = __fadd_rn(lo, col[i]);
  return __fmul_rn(lo, __frcp_rn((float)(m - 2 * t)));
}

// Blocks an SM must hold (registers a thread capped to fit them) where the
// register path's accumulators are few: 8, or 7 on the sparse wire.
#define MIN_BLOCKS(load) ((load) == LOAD_SPARSE ? 7 : 8)

// The looping kernel of the register path: m <= MB rows reach the rule
// (n <= MB without W; any n <= 64 with W, streamed row by row into the MB
// bucket sums, one fused multiply-add a term in worker order). Shared
// memory: the sparse tile (n, TILE * V), then W (MB, n) zero-padded past m,
// the byzantine mask and validity (n,), the bucket validity (MB,) and the
// sparse walk's positions (n,).
template <int LOAD, int MB, int V>
__global__ void __launch_bounds__(TILE, MB * V <= 16 ? MIN_BLOCKS(LOAD) : 1)
    robust_agg_regs(
    Src a, const float* w_mat, int m, const void* bvalid, int rule,
    int trim, int aligned, float* out) {
  constexpr int GROUP = TILE * V;
  extern __shared__ float4 smem4[];
  float* s_tile = reinterpret_cast<float*>(smem4);
  float* s_w = s_tile + (LOAD == LOAD_SPARSE ? a.n * GROUP : 0);
  float* s_mask = s_w + (w_mat ? MB * a.n : 0);
  float* s_valid = s_mask + a.n;
  float* s_bv = s_valid + a.n;
  int* s_pos = reinterpret_cast<int*>(s_bv + MB);
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
  for (int q = tid; q < MB; q += TILE)
    s_bv[q] = bvalid && q < m ? mask_at(bvalid, q, a.u8_masks & BVALID_U8)
                              : 0.f;
  __syncthreads();
  if (LOAD == LOAD_SPARSE) sparse_starts(a, g0 * GROUP, s_valid, s_pos);
  int c = 0;                               // valid buckets (masked rule)
  for (int b = 0; b < m; ++b) c += s_bv[b] > 0.f;

  // the sparse walk needs a contiguous range; the other loads stride the
  // grid, so that the blocks resident at once read neighbouring groups
  constexpr bool RANGE = LOAD == LOAD_SPARSE;
  constexpr int UNROLL = V <= 4 ? 4 : 2;
  const long long step = RANGE ? 1 : gridDim.x;
  for (long long g = RANGE ? g0 : blockIdx.x; g < (RANGE ? g1 : groups);
       g += step) {
    const long long c0 = g * GROUP + (long long)tid * V;
    const bool full = aligned && c0 + V <= a.d;
    float mu[V], sd[V], f[V], base1[V], acc[MB][V];
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
        for (int v = 0; v < V; ++v) acc[b][v] = 0.f;
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
              acc[b][v] = __fmaf_rn(wb, q[v], acc[b][v]);
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
          for (int v = 0; v < V; ++v) acc[j][v] = q[v];
        }
      }
      float r[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float col[MB];
#pragma unroll
        for (int b = 0; b < MB; ++b) col[b] = acc[b][v];
        r[v] = rule_regs<MB>(col, m, rule, trim, bvalid != nullptr, c, s_bv);
      }
      store_row<V>(out + c0, full, a.d - c0, r);
    }
  }
}

// --- the shared-memory path (m > 16, or a sparse wire of n > 16 rows) ----

// The looping kernel of the shared-memory path: a thread per column of a
// 128-column group, the attacked (n, TILE) and bucketed (m, TILE) stacks in
// shared memory (the sparse tile scattered into the first), the rule over
// the column there.
template <int LOAD>
__global__ void __launch_bounds__(TILE) robust_agg_smem(
    Src a, const float* w_mat, int m, const void* bvalid, int rule,
    int trim, float* out) {
  extern __shared__ float4 smem4[];
  const bool bucketed = w_mat != nullptr;
  const Smem s = carve(reinterpret_cast<float*>(smem4), a.n, m, bucketed);
  float* s_bv = s.rest;                     // (m,) bucket validity
  int* s_pos = reinterpret_cast<int*>(s_bv + m);
  const int tid = threadIdx.x;
  const long long g0 = (long long)a.n_tiles * blockIdx.x / gridDim.x;
  const long long g1 = (long long)a.n_tiles * (blockIdx.x + 1) / gridDim.x;

  stage_consts(a, w_mat, m, s);
  if (bvalid)
    for (int q = tid; q < m; q += TILE)
      s_bv[q] = mask_at(bvalid, q, a.u8_masks & BVALID_U8);
  __syncthreads();
  if (LOAD == LOAD_SPARSE) sparse_starts(a, g0 * TILE, s.valid, s_pos);
  int valid_rows = 0;
  if (bvalid)
    for (int b = 0; b < m; ++b) valid_rows += s_bv[b] > 0.f;

  constexpr bool RANGE = LOAD == LOAD_SPARSE;   // as in robust_agg_regs
  const long long step = RANGE ? 1 : gridDim.x;
  for (long long g = RANGE ? g0 : blockIdx.x; g < (RANGE ? g1 : a.n_tiles);
       g += step) {
    const long long c = g * TILE + tid;
    if (LOAD == LOAD_SPARSE)   // else a thread reads its own column alone
      scatter_group(a, g * TILE, TILE, s.valid, s_pos, s.x);
    if (c >= a.d) continue;
    load_column<LOAD>(a, c, s);
    float* rows = s.x;
    if (bucketed) {
      bucket_column(s.w, s.x, a.n, m, s.b);
      rows = s.b;
    }
    float r;
    if (bvalid) {
      r = masked_rule(rows + tid, s_bv, m, valid_rows, rule, trim);
    } else if (rule == RULE_MEAN) {
      r = __fmul_rn(row_sum(rows + tid, m), __frcp_rn((float)m));
    } else {
      sort_column(rows + tid, m);
      if (rule == RULE_MEDIAN) {
        const int h = m / 2;
        r = (m & 1) ? rows[h * TILE + tid]
                    : __fmul_rn(0.5f, __fadd_rn(rows[(h - 1) * TILE + tid],
                                                rows[h * TILE + tid]));
      } else {
        const int t = min(trim, (m - 1) / 2);
        r = __fmul_rn(row_sum(rows + t * TILE + tid, m - 2 * t),
                      __frcp_rn((float)(m - 2 * t)));
      }
    }
    out[c] = r;
  }
}

// The register path's bound on the rows reaching the rule: 4, 8 or 16, or
// 0 for the shared-memory path.
static int rows_bound(int load, int n, int m) {
  if (m > 16 || (load == LOAD_SPARSE && n > 16)) return 0;
  return m <= 4 ? 4 : m <= 8 ? 8 : 16;
}

struct Launch {
  const float* w_mat;
  int m;
  const void* bvalid;
  int rule, trim;
  float* out;
  cudaStream_t stream;
};

template <int LOAD, int MB>
static int launch_regs(const Src& a, const Launch& l) {
  constexpr int V = vec_width(LOAD, MB);
  const auto kernel = robust_agg_regs<LOAD, MB, V>;
  const size_t smem =
      ((LOAD == LOAD_SPARSE ? (size_t)a.n * TILE * V : 0) +
       (l.w_mat ? (size_t)MB * a.n : 0) + 2 * (size_t)a.n + MB + a.n) *
      sizeof(float);
  const int resident = resident_grid(kernel, TILE, smem);
  if (resident < 0) return -resident;
  const long long groups = (a.d + TILE * V - 1) / (TILE * V);
  const int blocks = (int)(groups < resident ? groups : resident);
  kernel<<<blocks, TILE, smem, l.stream>>>(a, l.w_mat, l.m, l.bvalid,
                                           l.rule, l.trim,
                                           vec_aligned(a, V, l.out), l.out);
  return (int)cudaGetLastError();
}

template <int LOAD>
struct RobustAgg {
  static int run(Src a, Launch l) {
    switch (rows_bound(LOAD, a.n, l.m)) {
      case 4: return launch_regs<LOAD, 4>(a, l);
      case 8: return launch_regs<LOAD, 8>(a, l);
      case 16: return launch_regs<LOAD, 16>(a, l);
    }
    const auto kernel = robust_agg_smem<LOAD>;
    const size_t smem =
        (prologue_words(a.n, l.m, l.w_mat != nullptr) + l.m + a.n) *
        sizeof(float);
    const int resident = resident_grid(kernel, TILE, smem);
    if (resident < 0) return -resident;
    const int blocks = a.n_tiles < resident ? a.n_tiles : resident;
    kernel<<<blocks, TILE, smem, l.stream>>>(a, l.w_mat, l.m, l.bvalid,
                                             l.rule, l.trim, l.out);
    return (int)cudaGetLastError();
  }
};

// Launches on `stream` and returns cudaGetLastError() (0 on success), for
// the source `load` (a LOAD_* code). `m` is W's row count (ignored without
// W); `bvalid` the (m,) bucket validity of the masked rule (bool bytes when
// u8_masks has BVALID_U8), or null for the plain rule. The sparse wire
// needs no row pointers (`starts` is ignored).
extern "C" int robust_agg_launch(SRC_PARAMS, const float* w_mat, int m,
                                 const void* bvalid, int rule, int trim,
                                 float* out, void* stream) {
  const Src a = make_src(SRC_ARGS);
  if (!w_mat) m = n;
  return with_load<RobustAgg>(load, a, Launch{w_mat, m, bvalid, rule, trim,
                                              out, (cudaStream_t)stream});
}

// The sparse range search alone, to hold it against its plain twin
// (quantize.sparse_range_start): for each of `blocks` blocks splitting
// ceil(d / group) column groups as the looping kernels split them, and each
// row i, the first entry of row i at a column >= the block's first column,
// into out (blocks, n).
__global__ void __launch_bounds__(TILE) sparse_bounds_kernel(
    const int* idx, int n, int k, long long d, int group, int* out) {
  const long long groups = (d + group - 1) / group;
  const long long lo = groups * blockIdx.x / gridDim.x * group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += TILE / 32) {
    const int* ix = idx + (long long)i * k;
    int p, q;
    warp_lower_bound2(ix, ix, k, lo, &p, &q);
    if (lane == 0) out[(long long)blockIdx.x * n + i] = p;
  }
}

extern "C" int sparse_bounds_launch(const int* idx, int n, int k,
                                    long long d, int group, int blocks,
                                    int* out, void* stream) {
  sparse_bounds_kernel<<<blocks, TILE, 0, (cudaStream_t)stream>>>(
      idx, n, k, d, group, out);
  return (int)cudaGetLastError();
}
