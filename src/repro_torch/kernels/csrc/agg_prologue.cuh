// Block load shared by the aggregation kernels for Hopper (robust_agg.cu,
// norm_agg.cu): the port of repro/kernels/norm_agg.py::_prologue with every
// branch of repro/kernels/quantize.py::recon_block.
//
// A block owns TILE consecutive columns of the (n, d) worker stack, one
// thread per column (blockDim.x == TILE). The load rebuilds the tile of the
// n worker rows in shared memory from one of six sources (Load below): the
// dense float32 or bfloat16 stack, or a wire payload plus a base of 0, 1 or
// n rows: the sparse RandK / TopK wire, the int8 levels with one float32
// norm per 256 coordinates, the int8 signs with one float32 scale per row,
// or bfloat16 values. It replaces the byzantine rows with the omniscient BF
// / ALIE / IPM value computed from the good workers' per-coordinate mean /
// std; under the fault guard (or partial participation) zeroes the rows
// whose `valid` entry is not > 0, with a select (0 * NaN would be NaN),
// after the attack and before W, as the reference's _prologue orders them,
// so an attacked row that is invalid stays zero; and, when a bucket
// operator is given, forms xb = W x with the (m, n) Alg. 2 operator.
// Neither the attacked stack nor the bucketed one (nor, on a wire, the
// dense candidates) is ever written to device memory.
//
// A wire value is rebuilt as recon_block does: decode, round through the
// candidate dtype, add the base, round again. The sparse wire is scattered
// into the tile first; int8, sign and bf16 decode elementwise (the reference
// rounds an int8 tile up to whole 256-blocks so that it sees whole norm
// blocks; here column c reads its norm at c >> 8 directly, so the 128-wide
// tile needs no rounding). Under a bfloat16 candidate dtype the forged value
// also rounds through bfloat16 before the select, as _prologue's
// attack_fn(...).astype(cand_dtype).
//
// Arithmetic follows the reference's compiled float32 code with explicitly
// rounded intrinsics, so the compiler can neither fuse nor reorder it: the
// ALIE value mean - z*std is one fused multiply-add, W x one fused
// multiply-add per term in worker order; the int8 division by 127 is a
// product with its rounded reciprocal, and, on a float32 candidate with a
// base, fused with the base add into one multiply-add, as XLA fuses it;
// bfloat16 rounds to nearest even (__float2bfloat16_rn, as astype).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TILE 128

enum { ATTACK_NONE = 0, ATTACK_BF = 1, ATTACK_ALIE = 2, ATTACK_IPM = 3 };

// Where the worker stack comes from; the Python wrappers pass the same codes
// (kernels/_launch.py, LOADS).
enum {
  LOAD_DENSE_F32 = 0,   // x: (n, d) float32
  LOAD_DENSE_BF16 = 1,  // x: (n, d) bfloat16, candidates in bfloat16
  LOAD_SPARSE = 2,      // vals / idx (n, k), starts (n, n_tiles + 1)
  LOAD_INT8 = 3,        // q8: (n, q8_ld) levels, qs: (n, qs_ld) norms
  LOAD_SIGN = 4,        // q8: (n, d) signs, qs: (n, 1) scale
  LOAD_BF16_WIRE = 5,   // x: (n, d) bfloat16 values
};

constexpr int INT8_BLOCK_SHIFT = 8;    // 256 coordinates share one norm
#define RCP127 0x1.020408p-7f          // float32 1/127, correctly rounded

// The worker stack and the attack inputs of one launch.
struct Src {
  const void* x;          // dense (n, d) float32 / bfloat16, bf16 wire
  const float* vals;      // sparse (n, k)
  const int* idx;         // sparse (n, k), ascending within each row
  const int* starts;      // sparse (n, n_tiles + 1) row pointers per tile
  const signed char* q8;  // int8 levels or signs, rows q8_ld apart
  const float* qs;        // int8 norms or sign scale, rows qs_ld apart
  const float* base;      // (base_rows, d) or null
  const float* mask;      // (n,) byzantine rows > 0, or null
  const float* valid;     // (n,) rows > 0 are valid (fault guard), or null
  const float* mean;      // (d,) or null
  const float* stdv;      // (d,) or null
  long long d, q8_ld;
  int n, k, n_tiles, qs_ld, base_rows, attack, load, cand_bf16;
  float attack_param;
};

// The leading parameters of every launch entry point, and make_src(SRC_ARGS)
// to gather them: the Python wrappers pass them in this order.
#define SRC_PARAMS                                                           \
  const void *x, const float *vals, const int *idx, const int *starts,       \
      int k, const signed char *q8, long long q8_ld, const float *qs,        \
      int qs_ld, const float *base, int base_rows, const float *mask,        \
      const float *valid, const float *mean, const float *stdv, int attack,  \
      float attack_param, int load, int cand_bf16, int n, long long d
#define SRC_ARGS                                                            \
  x, vals, idx, starts, k, q8, q8_ld, qs, qs_ld, base, base_rows, mask,     \
      valid, mean, stdv, attack, attack_param, load, cand_bf16, n, d

inline Src make_src(SRC_PARAMS) {
  Src a;
  a.x = x; a.vals = vals; a.idx = idx; a.starts = starts; a.q8 = q8;
  a.qs = qs; a.base = base; a.mask = mask; a.valid = valid; a.mean = mean;
  a.stdv = stdv; a.d = d; a.q8_ld = q8_ld; a.n = n; a.k = k;
  a.n_tiles = (int)((d + TILE - 1) / TILE); a.qs_ld = qs_ld;
  a.base_rows = base_rows; a.attack = attack; a.load = load;
  a.cand_bf16 = cand_bf16; a.attack_param = attack_param;
  return a;
}

// Calls F<load>::run(args...) with the load as a compile-time constant;
// cudaErrorInvalidValue for an unknown load.
template <template <int> class F, typename... Args>
inline int with_load(int load, Args... args) {
  switch (load) {
    case LOAD_DENSE_F32: return F<LOAD_DENSE_F32>::run(args...);
    case LOAD_DENSE_BF16: return F<LOAD_DENSE_BF16>::run(args...);
    case LOAD_SPARSE: return F<LOAD_SPARSE>::run(args...);
    case LOAD_INT8: return F<LOAD_INT8>::run(args...);
    case LOAD_SIGN: return F<LOAD_SIGN>::run(args...);
    case LOAD_BF16_WIRE: return F<LOAD_BF16_WIRE>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

// Shared-memory carve of the load: the attacked stack x (n, TILE), the
// bucketed stack b (m, TILE) and W (m, n) when bucketed, the byzantine mask
// (n,), the validity (n,); `rest` is where a kernel's own scratch begins.
struct Smem {
  float *x, *b, *w, *mask, *valid, *rest;
};

inline size_t prologue_words(int n, int m, bool bucketed) {
  return (size_t)n * TILE + 2 * (size_t)n
      + (bucketed ? (size_t)m * TILE + (size_t)m * n : 0);
}

__device__ __forceinline__ Smem carve(float* smem, int n, int m,
                                      bool bucketed) {
  Smem s;
  s.x = smem;
  s.b = s.x + n * TILE;
  s.w = s.b + (bucketed ? m * TILE : 0);
  s.mask = s.w + (bucketed ? m * n : 0);
  s.valid = s.mask + n;
  s.rest = s.valid + n;
  return s;
}

// Copy the byzantine mask, the validity (1 where none is given) and, when
// given, W into shared memory. Readers wait for the next barrier.
__device__ __forceinline__ void stage_consts(const Src& a,
                                             const float* w_mat, int m,
                                             const Smem& s) {
  const int tid = threadIdx.x;
  if (w_mat)
    for (int q = tid; q < m * a.n; q += TILE) s.w[q] = w_mat[q];
  for (int q = tid; q < a.n; q += TILE) {
    s.mask[q] = a.mask ? a.mask[q] : 0.f;
    s.valid[q] = a.valid ? a.valid[q] : 1.f;
  }
}

// Sparse wire: zero-fill the (n, TILE) tile `tile`, then scatter its
// payload into it, one warp per worker row (RandK indices of a worker are
// distinct, so no atomics). Invalid rows are skipped (the load zeroes
// them): a garbled payload's indices are neither ascending nor in range,
// and an index outside the tile is dropped all the same, as the reference's
// sentinel guard drops it. Reads s_valid, so staged constants must be
// visible. Ends without a barrier.
__device__ __forceinline__ void scatter_tile(const Src& a, int tile,
                                             const float* s_valid,
                                             float* s_x) {
  const int tid = threadIdx.x;
  const long long lo = (long long)tile * TILE;
  for (int i = 0; i < a.n; ++i) s_x[i * TILE + tid] = 0.f;
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < a.n; i += TILE / 32) {
    if (!(s_valid[i] > 0.f)) continue;
    const int* st = a.starts + (long long)i * (a.n_tiles + 1) + tile;
    const int s = st[0], e = st[1];
    const float* v = a.vals + (long long)i * a.k;
    const int* ix = a.idx + (long long)i * a.k;
    for (int p = s + lane; p < e; p += 32) {
      const long long col = (long long)ix[p] - lo;
      if (col >= 0 && col < TILE) s_x[i * TILE + (int)col] = v[p];
    }
  }
}

// v rounded through the candidate dtype: bfloat16 (nearest even) or none.
__device__ __forceinline__ float to_cand(float v, int cand_bf16) {
  return cand_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float bf16_at(const void* p, long long q) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[q]);
}

// Row i's candidate at column c < d: the dense value, or the wire value
// decoded, rounded through the candidate dtype, plus the base, rounded
// again (recon_block). The sparse wire reads its scattered tile from s_x.
template <int LOAD>
__device__ __forceinline__ float candidate(const Src& a, int i, long long c,
                                           const float* s_x) {
  const long long row = (long long)i * a.d;
  if (LOAD == LOAD_DENSE_F32) return static_cast<const float*>(a.x)[row + c];
  if (LOAD == LOAD_DENSE_BF16) return bf16_at(a.x, row + c);
  const float b =
      a.base ? a.base[(a.base_rows > 1 ? row : 0) + c] : 0.f;
  float q;
  if (LOAD == LOAD_SPARSE) {
    q = s_x[i * TILE + threadIdx.x];
  } else if (LOAD == LOAD_BF16_WIRE) {
    q = bf16_at(a.x, row + c);
  } else if (LOAD == LOAD_SIGN) {
    q = __fmul_rn((float)a.q8[(long long)i * a.q8_ld + c],
                  a.qs[(long long)i * a.qs_ld]);
  } else {
    const float p = __fmul_rn(
        a.qs[(long long)i * a.qs_ld + (c >> INT8_BLOCK_SHIFT)],
        (float)a.q8[(long long)i * a.q8_ld + c]);
    if (a.base && !a.cand_bf16) return __fmaf_rn(p, RCP127, b);
    q = __fmul_rn(p, RCP127);
  }
  q = to_cand(q, a.cand_bf16);
  return a.base ? to_cand(__fadd_rn(q, b), a.cand_bf16) : q;
}

// Column c < d of the attacked stack into s_x[:, tid]: each row's
// candidate; byzantine rows take the forged value, rounded through the
// candidate dtype (BF negates the row's own value, already of that dtype);
// then invalid rows become +0.
template <int LOAD>
__device__ __forceinline__ void load_column(const Src& a, long long c,
                                            const Smem& s) {
  const float* s_mask = s.mask;
  float* s_x = s.x;
  const int tid = threadIdx.x;
  float forged = 0.f;     // the ALIE / IPM value of this column
  if (a.attack == ATTACK_ALIE)
    forged = __fmaf_rn(-a.attack_param, a.stdv[c], a.mean[c]);
  else if (a.attack == ATTACK_IPM)
    forged = __fmul_rn(-a.attack_param, a.mean[c]);
  forged = to_cand(forged, a.cand_bf16);
  for (int i = 0; i < a.n; ++i) {
    float v = candidate<LOAD>(a, i, c, s_x);
    if (a.attack != ATTACK_NONE && s_mask[i] > 0.f)
      v = a.attack == ATTACK_BF ? -v : forged;
    if (!(s.valid[i] > 0.f)) v = 0.f;
    s_x[i * TILE + tid] = v;
  }
}

// xb[:, tid] = W s_x[:, tid].
__device__ __forceinline__ void bucket_column(const float* s_w,
                                              const float* s_x, int n, int m,
                                              float* s_b) {
  const int tid = threadIdx.x;
  for (int b = 0; b < m; ++b) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j)
      acc = __fmaf_rn(s_w[b * n + j], s_x[j * TILE + tid], acc);
    s_b[b * TILE + tid] = acc;
  }
}

// XLA on the CPU rewrites a reduction over more rows than this into windows
// of this many rows (aggregators.xla_sum_rows).
constexpr int XLA_WINDOW = 32;

// sum_i w[i] v[i * TILE] over `cnt` <= 64 rows of one column, as the
// reference's compiled kernel body takes sum(x * w, axis=0) on the CPU: up
// to 32 rows one fused multiply-add per row in row order; above, the rounded
// products summed in two windows cut at 32 - (64 - cnt) / 2, each in order,
// then the two window sums added.
__device__ __forceinline__ float weighted_col(const float* v, const float* w,
                                              int cnt) {
  float lo = 0.f, hi = 0.f;
  if (cnt <= XLA_WINDOW) {
    for (int i = 0; i < cnt; ++i) lo = __fmaf_rn(v[i * TILE], w[i], lo);
    return lo;
  }
  const int cut = XLA_WINDOW - (2 * XLA_WINDOW - cnt) / 2;
  for (int i = 0; i < cut; ++i) lo = __fadd_rn(lo, __fmul_rn(v[i * TILE], w[i]));
  for (int i = cut; i < cnt; ++i)
    hi = __fadd_rn(hi, __fmul_rn(v[i * TILE], w[i]));
  return __fadd_rn(lo, hi);
}

// Tile `tile` into shared memory, for a block that loops over tiles:
// s.x the attacked rows and s.b = W s.x when bucketed; columns past d are
// zeros, which add nothing to a Gram or a sum of squares. Returns the rows
// the rule reads. Starts with a barrier (the previous tile's readers are
// done, the staged constants are visible) and ends without one: a thread
// may read its own column at once, other columns after a __syncthreads().
template <int LOAD>
__device__ __forceinline__ const float* load_tile(const Src& a,
                                                  const Smem& s,
                                                  bool bucketed, int m,
                                                  int tile) {
  const int tid = threadIdx.x;
  const long long c = (long long)tile * TILE + tid;
  __syncthreads();
  if (LOAD == LOAD_SPARSE) {
    scatter_tile(a, tile, s.valid, s.x);
    __syncthreads();
  }
  if (c < a.d) {
    load_column<LOAD>(a, c, s);
    if (bucketed) bucket_column(s.w, s.x, a.n, m, s.b);
  } else {
    for (int i = 0; i < a.n; ++i) s.x[i * TILE + tid] = 0.f;
    if (bucketed)
      for (int b = 0; b < m; ++b) s.b[b * TILE + tid] = 0.f;
  }
  return bucketed ? s.b : s.x;
}

// Host: dynamic shared memory above 48 KB needs the attribute set first.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
