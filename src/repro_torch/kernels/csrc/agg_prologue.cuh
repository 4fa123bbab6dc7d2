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

#include <cstdint>
#include <cstring>

#define TILE 128

enum { ATTACK_NONE = 0, ATTACK_BF = 1, ATTACK_ALIE = 2, ATTACK_IPM = 3 };

// Where the worker stack comes from; the Python wrappers pass the same codes
// (kernels/_launch.py, LOADS).
enum {
  LOAD_DENSE_F32 = 0,   // x: (n, d) float32
  LOAD_DENSE_BF16 = 1,  // x: (n, d) bfloat16, candidates in bfloat16
  LOAD_SPARSE = 2,      // vals / idx (n, k), each idx row ascending
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
  const signed char* q8;  // int8 levels or signs, rows q8_ld apart
  const float* qs;        // int8 norms or sign scale, rows qs_ld apart
  const float* base;      // (base_rows, d) or null
  const void* mask;       // (n,) byzantine rows > 0, or null
  const void* valid;      // (n,) rows > 0 are valid (fault guard), or null
  const float* mean;      // (d,) or null
  const float* stdv;      // (d,) or null
  long long d, q8_ld;
  int n, k, n_tiles, qs_ld, base_rows, attack, load, cand_bf16;
  int u8_masks;           // MASK_U8 | VALID_U8 | BVALID_U8: bool bytes
  float attack_param;
};

// A mask is either bool bytes (a zero-copy uint8 view of a torch.bool
// tensor) or float32 read as > 0; u8_masks says which, bit by bit.
enum { MASK_U8 = 1, VALID_U8 = 2, BVALID_U8 = 4 };

__device__ __forceinline__ float mask_at(const void* p, int q, bool u8) {
  return u8 ? (float)static_cast<const unsigned char*>(p)[q]
            : static_cast<const float*>(p)[q];
}

// The leading parameters of every launch entry point, and make_src(SRC_ARGS)
// to gather them: the Python wrappers pass them in this order.
#define SRC_PARAMS                                                           \
  const void *x, const float *vals, const int *idx, int k,                  \
      const signed char *q8, long long q8_ld, const float *qs,               \
      int qs_ld, const float *base, int base_rows, const void *mask,         \
      const void *valid, const float *mean, const float *stdv, int attack,   \
      float attack_param, int load, int cand_bf16, int n, long long d,       \
      int u8_masks
#define SRC_ARGS                                                            \
  x, vals, idx, k, q8, q8_ld, qs, qs_ld, base, base_rows, mask,             \
      valid, mean, stdv, attack, attack_param, load, cand_bf16, n, d,       \
      u8_masks

inline Src make_src(SRC_PARAMS) {
  Src a;
  a.x = x; a.vals = vals; a.idx = idx; a.q8 = q8;
  a.qs = qs; a.base = base; a.mask = mask; a.valid = valid; a.mean = mean;
  a.stdv = stdv; a.d = d; a.q8_ld = q8_ld; a.n = n; a.k = k;
  a.n_tiles = (int)((d + TILE - 1) / TILE); a.qs_ld = qs_ld;
  a.base_rows = base_rows; a.attack = attack; a.load = load;
  a.cand_bf16 = cand_bf16; a.attack_param = attack_param;
  a.u8_masks = u8_masks;
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
    s.mask[q] = a.mask ? mask_at(a.mask, q, a.u8_masks & MASK_U8) : 0.f;
    s.valid[q] = a.valid ? mask_at(a.valid, q, a.u8_masks & VALID_U8) : 1.f;
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

// sum_i w[i] v[i * stride] over `cnt` <= 64 rows of one column, as the
// reference's compiled kernel body takes sum(x * w, axis=0) on the CPU: up
// to 32 rows one fused multiply-add per row in row order; above, the rounded
// products summed in two windows cut at 32 - (64 - cnt) / 2, each in order,
// then the two window sums added.
__device__ __forceinline__ float weighted_col(const float* v, int stride,
                                              const float* w, int cnt) {
  float lo = 0.f, hi = 0.f;
  if (cnt <= XLA_WINDOW) {
    for (int i = 0; i < cnt; ++i) lo = __fmaf_rn(v[i * stride], w[i], lo);
    return lo;
  }
  const int cut = XLA_WINDOW - (2 * XLA_WINDOW - cnt) / 2;
  for (int i = 0; i < cut; ++i)
    lo = __fadd_rn(lo, __fmul_rn(v[i * stride], w[i]));
  for (int i = cut; i < cnt; ++i)
    hi = __fadd_rn(hi, __fmul_rn(v[i * stride], w[i]));
  return __fadd_rn(lo, hi);
}

// Host: dynamic shared memory above 48 KB needs the attribute set first.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Host: the grid of a looping kernel, as many blocks as are resident on
// the current card at once (at least one). The occupancy query runs once
// per kernel, card and shared-memory size, and the kernel's shared-memory
// attribute is only ever raised, to the largest size asked for so far;
// later launches read the caches. Negative: -(CUDA error).
template <typename Kernel>
inline int resident_grid(Kernel kernel, int threads, size_t smem) {
  struct Grid {
    const void* fn;
    size_t smem;
    int dev, blocks;
  };
  struct Attr {
    const void* fn;
    int dev;
    size_t smem;
  };
  static Grid grids[256];
  static Attr attrs[128];
  static int n_grids = 0, n_attrs = 0;
  int dev;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return -(int)err;
  const void* fn = (const void*)kernel;
  for (int q = 0; q < n_grids; ++q)
    if (grids[q].fn == fn && grids[q].smem == smem && grids[q].dev == dev)
      return grids[q].blocks;
  int a = 0;
  while (a < n_attrs && !(attrs[a].fn == fn && attrs[a].dev == dev)) ++a;
  if (a == n_attrs || attrs[a].smem < smem) {
    if ((err = allow_smem(kernel, smem))) return -(int)err;
    if (a == n_attrs && n_attrs < 128) ++n_attrs;
    if (a < 128) attrs[a] = Attr{fn, dev, smem};
  }
  int sms, per_sm;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           threads, smem)))
    return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  if (n_grids < 256) grids[n_grids++] = Grid{fn, smem, dev, per_sm * sms};
  return per_sm * sms;
}

// ---------------------------------------------------------------------------
// The register load of the looping kernels (robust_agg.cu; pair_gram,
// rfa_iter and weighted_sum in norm_agg.cu). A block takes its column
// groups strided over the grid, or, on the sparse wire, as one contiguous
// range; a thread owns V consecutive columns of a group of TILE * V, reads
// each worker row's V values with one load of up to 16 bytes (neighbouring
// threads on neighbouring addresses), and keeps the rows of its columns in
// registers.
// The sparse wire has no row pointers: each block finds where its range
// starts in every worker's ascending idx row with one warp-wide 32-ary
// search, then walks forward group by group.
// ---------------------------------------------------------------------------

// Columns a thread owns: one load of at most 16 bytes a row (4 float32,
// 8 bfloat16 or int8), at most 64 accumulators (MB rows of V columns) in
// registers, and no spills in the -Xptxas -v log (16 int8 columns a thread
// would spill).
__host__ __device__ constexpr int vec_width(int load, int mb) {
  return load == LOAD_DENSE_F32 || load == LOAD_SPARSE || mb > 4 ? 4 : 8;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(signed char v) { return (float)v; }

// V values of T at p in as few loads of up to 16 bytes as there are; p is
// aligned to the loads' width.
template <typename T, int V>
__device__ __forceinline__ void vec_load(const T* p, T (&out)[V]) {
  constexpr int BYTES = (int)sizeof(T) * V;
  if constexpr (V == 1) {
    out[0] = __ldg(p);
  } else if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int q = 0; q < BYTES / 16; ++q) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
      memcpy(reinterpret_cast<char*>(out) + 16 * q, &u, 16);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    memcpy(out, &u, 8);
  } else if constexpr (BYTES == 4) {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
    memcpy(out, &u, 4);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = p[v];
  }
}

// The V values at p widened to float32: one vector load when `full`, else
// the first `left` values one by one (zeros past them: columns past d).
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* p, bool full,
                                         long long left, float (&out)[V]) {
  if (full) {
    T tmp[V];
    vec_load<T, V>(p, tmp);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = widen(tmp[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = v < left ? widen(p[v]) : 0.f;
  }
}

// Store V float32 values at p: 16-byte stores when `full`, else the first
// `left` of them.
template <int V>
__device__ __forceinline__ void store_row(float* p, bool full,
                                          long long left,
                                          const float (&r)[V]) {
  if (full && V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < left) p[v] = r[v];
  }
}

// First p in [0, k) with ix[p] >= target, or k, for an ascending row: a
// search by the whole warp, 32 probes a step (a range of k shrinks 33-fold
// a step, so about log_33(k) dependent loads: 4 at k = 419,430), then one
// last step over at most 32 positions. Two rows at once (`jx` may repeat
// `ix`), so that the warp issues both rows' probes before it waits on
// either. sparse_range_start in kernels/quantize.py is its plain twin.
__device__ __forceinline__ void warp_lower_bound2(const int* ix,
                                                  const int* jx, int k,
                                                  long long target, int* pi,
                                                  int* pj) {
  const int lane = threadIdx.x & 31;
  int lo0 = 0, hi0 = k, lo1 = 0, hi1 = k;  // each answer lies in [lo, hi]
  while (hi0 - lo0 > 32 || hi1 - lo1 > 32) {
    const long long span0 = hi0 - lo0, span1 = hi1 - lo1;
    const int v0 = span0 > 32 ? ix[lo0 + (int)(span0 * (lane + 1) / 33)] : 0;
    const int v1 = span1 > 32 ? jx[lo1 + (int)(span1 * (lane + 1) / 33)] : 0;
    if (span0 > 32) {                      // uniform across the warp
      const int c = __popc(__ballot_sync(0xffffffffu, v0 < target));
      const int nlo = c == 0 ? lo0 : lo0 + (int)(span0 * c / 33) + 1;
      if (c < 32) hi0 = lo0 + (int)(span0 * (c + 1) / 33);
      lo0 = nlo;
    }
    if (span1 > 32) {
      const int c = __popc(__ballot_sync(0xffffffffu, v1 < target));
      const int nlo = c == 0 ? lo1 : lo1 + (int)(span1 * c / 33) + 1;
      if (c < 32) hi1 = lo1 + (int)(span1 * (c + 1) / 33);
      lo1 = nlo;
    }
  }
  const int p0 = lo0 + lane, p1 = lo1 + lane;
  const bool l0 = p0 < hi0 && ix[p0] < target;
  const bool l1 = p1 < hi1 && jx[p1] < target;
  *pi = lo0 + __popc(__ballot_sync(0xffffffffu, l0));
  *pj = lo1 + __popc(__ballot_sync(0xffffffffu, l1));
}

// Sparse wire, at the start of a block's range [lo, ...): s_pos[i] = the
// first entry of valid row i at a column >= lo, each warp searching two
// rows at once. Invalid rows (a garbled payload's indices are neither
// ascending nor in range) are skipped before any search; the load zeroes
// them. Readers wait for the next barrier.
__device__ __forceinline__ void sparse_starts(const Src& a, long long lo,
                                              const float* s_valid,
                                              int* s_pos) {
  constexpr int WARPS = TILE / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i0 = warp; i0 < a.n; i0 += 2 * WARPS) {
    const int i1 = i0 + WARPS;
    const bool v0 = s_valid[i0] > 0.f;
    const bool v1 = i1 < a.n && s_valid[i1] > 0.f;
    if (!v0 && !v1) continue;
    const int* x0 = a.idx + (long long)(v0 ? i0 : i1) * a.k;
    const int* x1 = a.idx + (long long)(v1 ? i1 : i0) * a.k;
    int p0, p1;
    warp_lower_bound2(x0, x1, a.k, lo, &p0, &p1);
    if (lane == 0) {
      if (v0) s_pos[i0] = p0;
      if (v1) s_pos[i1] = p1;
    }
  }
}

// A step of a row's walk, in two halves so that a warp can issue the loads
// of two rows before it waits on either: walk_load reads the next 4 x 32
// entries of row i from `pos` (four independent coalesced loads a lane);
// walk_scatter writes those at columns in [lo, hi) into the tile row and
// returns how many were below hi (they are a prefix of an ascending row:
// fewer than 128 end the row's run in the tile).
__device__ __forceinline__ void walk_load(const Src& a, int i, int pos,
                                          int (&c)[4]) {
  const int lane = threadIdx.x & 31;
  const int* ix = a.idx + (long long)i * a.k;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int p = pos + lane + 32 * q;
    c[q] = p < a.k ? ix[p] : 0;
  }
}

__device__ __forceinline__ int walk_scatter(const Src& a, int i, int pos,
                                            long long lo, long long hi,
                                            const int (&c)[4], int width,
                                            float* s_tile) {
  const int lane = threadIdx.x & 31;
  const float* v = a.vals + (long long)i * a.k;
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int p = pos + lane + 32 * q;
    const bool in = p < a.k && c[q] < hi;
    cnt += __popc(__ballot_sync(0xffffffffu, in));
    if (in && c[q] >= lo) s_tile[i * width + (int)(c[q] - lo)] = v[p];
  }
  return cnt;
}

// Sparse wire: the (n, width) tile of columns [lo, lo + width) into s_tile,
// zero-filled first. Each warp walks two valid rows at once, forward from
// s_pos[i], 128 entries a step while they fall in the tile, then advances
// s_pos[i] past them (RandK / TopK indices of a worker are distinct: no
// atomics). Invalid rows are skipped (their tile rows stay zero). Starts
// and ends with a barrier.
__device__ __forceinline__ void scatter_group(const Src& a, long long lo,
                                              int width,
                                              const float* s_valid,
                                              int* s_pos, float* s_tile) {
  constexpr int WARPS = TILE / 32;
  const int tid = threadIdx.x;
  __syncthreads();                         // the last group's readers are done
  for (int q = tid; q < a.n * width / 4; q += TILE)
    reinterpret_cast<float4*>(s_tile)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  const long long hi = lo + width;
  for (int i0 = warp; i0 < a.n; i0 += 2 * WARPS) {
    const int i1 = i0 + WARPS;
    bool more0 = s_valid[i0] > 0.f;
    bool more1 = i1 < a.n && s_valid[i1] > 0.f;
    int pos0 = more0 ? s_pos[i0] : 0, pos1 = more1 ? s_pos[i1] : 0;
    while (more0 || more1) {
      int c0[4], c1[4];
      walk_load(a, i0, more0 ? pos0 : a.k, c0);
      walk_load(a, more1 ? i1 : i0, more1 ? pos1 : a.k, c1);
      if (more0) {
        const int got = walk_scatter(a, i0, pos0, lo, hi, c0, width,
                                     s_tile);
        pos0 += got;
        more0 = got == 128;
      }
      if (more1) {
        const int got = walk_scatter(a, i1, pos1, lo, hi, c1, width,
                                     s_tile);
        pos1 += got;
        more1 = got == 128;
      }
    }
    if (lane == 0) {
      if (s_valid[i0] > 0.f) s_pos[i0] = pos0;
      if (i1 < a.n && s_valid[i1] > 0.f) s_pos[i1] = pos1;
    }
  }
  __syncthreads();
}

// Row i's candidates at the V columns c0.. of a thread (c0 a multiple of
// V): the dense values, or the wire values decoded, rounded through the
// candidate dtype, plus the base, rounded again, with candidate<LOAD>'s
// arithmetic. `full`: all V columns lie below d and every row is aligned
// for vector loads; else the columns past d read as zeros. The sparse wire
// reads its scattered tile (row stride `width`, this thread's columns at
// `col`); a shared one-row base comes in `base1`.
template <int LOAD, int V>
__device__ __forceinline__ void row_values(const Src& a, int i,
                                           long long c0, bool full,
                                           const float* s_tile, int width,
                                           int col, const float (&base1)[V],
                                           float (&q)[V]) {
  const long long row = (long long)i * a.d, left = a.d - c0;
  if (LOAD == LOAD_DENSE_F32) {
    load_row<float, V>(static_cast<const float*>(a.x) + row + c0, full,
                       left, q);
    return;
  }
  if (LOAD == LOAD_DENSE_BF16) {
    load_row<__nv_bfloat16, V>(
        static_cast<const __nv_bfloat16*>(a.x) + row + c0, full, left, q);
    return;
  }
  float b[V];
  if (a.base && a.base_rows > 1)
    load_row<float, V>(a.base + row + c0, full, left, b);
  else
#pragma unroll
    for (int v = 0; v < V; ++v) b[v] = base1[v];
  if (LOAD == LOAD_SPARSE) {
#pragma unroll
    for (int v = 0; v < V; ++v) q[v] = s_tile[i * width + col + v];
  } else if (LOAD == LOAD_BF16_WIRE) {
    load_row<__nv_bfloat16, V>(
        static_cast<const __nv_bfloat16*>(a.x) + row + c0, full, left, q);
  } else {
    float lev[V];
    load_row<signed char, V>(a.q8 + (long long)i * a.q8_ld + c0, full, left,
                             lev);
    if (LOAD == LOAD_SIGN) {
      const float scale = a.qs[(long long)i * a.qs_ld];
#pragma unroll
      for (int v = 0; v < V; ++v) q[v] = __fmul_rn(lev[v], scale);
    } else {   // V divides 256: the V columns share one norm
      const float norm =
          a.qs[(long long)i * a.qs_ld + (c0 >> INT8_BLOCK_SHIFT)];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float p = __fmul_rn(norm, lev[v]);
        q[v] = a.base && !a.cand_bf16 ? __fmaf_rn(p, RCP127, b[v])
                                      : __fmul_rn(p, RCP127);
      }
      if (a.base && !a.cand_bf16) return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    q[v] = to_cand(q[v], a.cand_bf16);
    if (a.base) q[v] = to_cand(__fadd_rn(q[v], b[v]), a.cand_bf16);
  }
}

// The forged value of the V columns c0..: ALIE mean - z*std (one fused
// multiply-add) or IPM -z*mean, rounded through the candidate dtype. In two
// halves, so that a kernel can issue the loads (forged_load: mean and std,
// zeros past d) before a barrier and use them after it (forged_finish).
template <int V>
__device__ __forceinline__ void forged_load(const Src& a, long long c0,
                                            bool full, float (&mu)[V],
                                            float (&sd)[V]) {
  const long long left = a.d - c0;
#pragma unroll
  for (int v = 0; v < V; ++v) mu[v] = sd[v] = 0.f;
  if (a.attack == ATTACK_ALIE || a.attack == ATTACK_IPM)
    load_row<float, V>(a.mean + c0, full, left, mu);
  if (a.attack == ATTACK_ALIE)
    load_row<float, V>(a.stdv + c0, full, left, sd);
}

template <int V>
__device__ __forceinline__ void forged_finish(const Src& a,
                                              const float (&mu)[V],
                                              const float (&sd)[V],
                                              float (&f)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    f[v] = a.attack == ATTACK_ALIE ? __fmaf_rn(-a.attack_param, sd[v], mu[v])
         : a.attack == ATTACK_IPM  ? __fmul_rn(-a.attack_param, mu[v])
                                   : 0.f;
    f[v] = to_cand(f[v], a.cand_bf16);
  }
}

// Row i's attacked values: byzantine rows take the forged value (BF
// negates the row's own), then invalid rows become +0 (load_column's
// order).
template <int V>
__device__ __forceinline__ void attack_row(const Src& a, float byz,
                                           float valid, const float (&f)[V],
                                           float (&q)[V]) {
  const bool forge = a.attack != ATTACK_NONE && byz > 0.f;
  const bool keep = valid > 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float x = q[v];
    if (forge) x = a.attack == ATTACK_BF ? -x : f[v];
    q[v] = keep ? x : 0.f;
  }
}

// Whether every row of the register load may be read with vector loads of
// V values: d a multiple of V, and every array the load reads aligned.
inline bool vec_aligned(const Src& a, int v, const void* out) {
  const void* ptrs[] = {a.x, a.q8, a.base, a.mean, a.stdv, out};
  for (const void* p : ptrs)
    if (p && (reinterpret_cast<uintptr_t>(p) & 15)) return false;
  return a.d % v == 0 && (!a.q8 || a.q8_ld % v == 0);
}
