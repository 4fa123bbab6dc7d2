// Coordinate-wise robust aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/robust_agg.py::robust_agg together
// with its input prologue repro/kernels/norm_agg.py::_prologue and every
// branch of repro/kernels/quantize.py::recon_block (_recon_sparse_block,
// int8, sign, bf16). One launch turns n <= 64 worker rows into one
// aggregate row:
//
//   load      dense (n, d) float32 or bfloat16 stack, or a wire payload
//             plus a base of 0, 1 or n rows: sparse (vals/idx (n, k), CSR
//             row pointers per tile), int8 levels with a norm per 256
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
// memory rate. The design keeps every intermediate on chip: a block
// owns TILE consecutive columns, one thread per column; its (n, TILE)
// attacked stack and (m, TILE) bucketed stack live in shared memory, so
// neither the attacked nor the bucketed stack (nor, on the wire, the
// dense candidates) is ever written to device memory. Loads of a worker
// row are coalesced across the block's threads; the sparse payload of a
// tile is scattered into the zero-filled shared stack by one warp per
// worker, with no atomics since RandK indices of a worker are distinct.
//
// The load (dense or wire tile, base add, attack select, W x) is the shared
// block load of agg_prologue.cuh. Arithmetic follows the reference's
// compiled float32 code with explicitly rounded intrinsics, so the compiler
// can neither fuse nor reorder it: the ALIE value mean - z*std is one fused
// multiply-add, a mean is a sum in XLA's order (row_sum) times the rounded
// reciprocal of the count.

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

template <int LOAD>
__global__ void __launch_bounds__(TILE) robust_agg_kernel(
    Src a, const float* w_mat, int m, const float* bvalid, int rule,
    int trim, float* out) {
  extern __shared__ float smem[];
  const bool bucketed = w_mat != nullptr;
  const Smem s = carve(smem, a.n, m, bucketed);
  float* s_bv = s.rest;                     // (m,) bucket validity
  const int tid = threadIdx.x;
  const long long c = (long long)blockIdx.x * TILE + tid;

  stage_consts(a, w_mat, m, s);
  if (bvalid)
    for (int q = tid; q < m; q += TILE) s_bv[q] = bvalid[q];
  if (LOAD == LOAD_SPARSE) scatter_tile(a, blockIdx.x, s.valid, s.x);
  __syncthreads();
  if (c >= a.d) return;   // no barrier below: the rest is per column

  load_column<LOAD>(a, c, s);
  float* rows = s.x;
  if (bucketed) {
    bucket_column(s.w, s.x, a.n, m, s.b);
    rows = s.b;
  }

  float r;
  if (bvalid) {
    int valid_rows = 0;
    for (int b = 0; b < m; ++b) valid_rows += s_bv[b] > 0.f;
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

template <int LOAD>
struct RobustAgg {
  static int run(Src a, const float* w_mat, int m, const float* bvalid,
                 int rule, int trim, float* out, size_t smem,
                 cudaStream_t st) {
    cudaError_t err = allow_smem(robust_agg_kernel<LOAD>, smem);
    if (err) return (int)err;
    robust_agg_kernel<LOAD><<<a.n_tiles, TILE, smem, st>>>(a, w_mat, m,
                                                           bvalid, rule,
                                                           trim, out);
    return (int)cudaGetLastError();
  }
};

extern "C" int robust_agg_tile() { return TILE; }

// Launches on `stream` and returns cudaGetLastError() (0 on success), for
// the source `load` (a LOAD_* code). `m` is W's row count (ignored without
// W); `bvalid` the (m,) bucket validity of the masked rule, or null for the
// plain rule.
extern "C" int robust_agg_launch(SRC_PARAMS, const float* w_mat, int m,
                                 const float* bvalid, int rule, int trim,
                                 float* out, void* stream) {
  const Src a = make_src(SRC_ARGS);
  if (!w_mat) m = n;
  const size_t smem =
      (prologue_words(n, m, w_mat != nullptr) + m) * sizeof(float);
  return with_load<RobustAgg>(load, a, w_mat, m, bvalid, rule, trim, out,
                              smem, (cudaStream_t)stream);
}
