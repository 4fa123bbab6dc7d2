// Coordinate-wise robust aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/robust_agg.py::robust_agg together
// with its input prologue repro/kernels/norm_agg.py::_prologue and the
// sparse branch of repro/kernels/quantize.py::recon_block
// (_recon_sparse_block). One launch turns n <= 64 worker rows into one
// aggregate row:
//
//   load      dense (n, d) float32 stack, or a sparse RandK wire payload
//             (vals/idx (n, k), CSR row pointers per tile) plus a base of
//             0, 1 or n rows;
//   attack    the omniscient BF / ALIE / IPM attack replaces the byzantine
//             rows, from the good workers' per-coordinate mean / std;
//   bucket    xb = W x with the (m, n) Alg. 2 bucket operator;
//   rule      mean, median or trimmed mean over the m rows of each column.
//
// Bound: device-memory bytes. Each column's work is O(m^2) compares on
// values already on chip, so the least time is the bytes moved (the stack
// or the wire payload, the base row, mean and std, and the output) over
// the memory rate. The design keeps every intermediate on chip: a block
// owns TILE consecutive columns, one thread per column; its (n, TILE)
// attacked stack and (m, TILE) bucketed stack live in shared memory, so
// neither the attacked nor the bucketed stack (nor, on the wire, the
// dense candidates) is ever written to device memory. Loads of a worker
// row are coalesced across the block's threads; the sparse payload of a
// tile is scattered into the zero-filled shared stack by one warp per
// worker, with no atomics since RandK indices of a worker are distinct.
//
// Arithmetic follows the reference's compiled float32 code with explicitly
// rounded intrinsics, so the compiler can neither fuse nor reorder it: the
// ALIE value mean - z*std is one fused multiply-add, a mean is a sequential
// sum times the rounded reciprocal of the count.

#include <cuda_runtime.h>

#define TILE 128

enum { ATTACK_NONE = 0, ATTACK_BF = 1, ATTACK_ALIE = 2, ATTACK_IPM = 3 };
enum { RULE_MEAN = 0, RULE_MEDIAN = 1, RULE_TRIMMED = 2 };

struct Args {
  const float* x;       // dense (n, d), or null for the sparse wire
  const float* vals;    // sparse (n, k)
  const int* idx;       // sparse (n, k), ascending within each row
  const int* starts;    // sparse (n, n_tiles + 1) row pointers per tile
  const float* base;    // (base_rows, d) or null
  const float* w_mat;   // (m, n) or null (then m == n)
  const float* mask;    // (n,) byzantine rows > 0, or null
  const float* mean;    // (d,) or null
  const float* stdv;    // (d,) or null
  float* out;           // (d,)
  long long d;
  int n, m, k, n_tiles, base_rows, attack, rule, trim;
  float attack_param;
};

template <bool SPARSE>
__global__ void __launch_bounds__(TILE) robust_agg_kernel(Args a) {
  extern __shared__ float smem[];
  const int n = a.n;
  const int m = a.m;
  const bool bucketed = a.w_mat != nullptr;
  float* s_x = smem;                                   // (n, TILE)
  float* s_b = s_x + n * TILE;                         // (m, TILE)
  float* s_w = s_b + (bucketed ? m * TILE : 0);        // (m, n)
  float* s_mask = s_w + (bucketed ? m * n : 0);        // (n,)
  const int tid = threadIdx.x;
  const long long lo = (long long)blockIdx.x * TILE;
  const long long c = lo + tid;

  if (bucketed)
    for (int q = tid; q < m * n; q += TILE) s_w[q] = a.w_mat[q];
  for (int q = tid; q < n; q += TILE) s_mask[q] = a.mask ? a.mask[q] : 0.f;
  if (SPARSE) {
    for (int i = 0; i < n; ++i) s_x[i * TILE + tid] = 0.f;
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    for (int i = warp; i < n; i += TILE / 32) {
      const int* st = a.starts + (long long)i * (a.n_tiles + 1) + blockIdx.x;
      const int s = st[0], e = st[1];
      const float* v = a.vals + (long long)i * a.k;
      const int* ix = a.idx + (long long)i * a.k;
      for (int p = s + lane; p < e; p += 32)
        s_x[i * TILE + (int)(ix[p] - lo)] = v[p];
    }
  }
  __syncthreads();
  if (c >= a.d) return;   // no barrier below: the rest is per column

  float forged = 0.f;     // the ALIE / IPM value of this column
  if (a.attack == ATTACK_ALIE)
    forged = __fmaf_rn(-a.attack_param, a.stdv[c], a.mean[c]);
  else if (a.attack == ATTACK_IPM)
    forged = __fmul_rn(-a.attack_param, a.mean[c]);

  for (int i = 0; i < n; ++i) {
    float v;
    if (SPARSE) {
      v = s_x[i * TILE + tid];
      if (a.base)
        v = __fadd_rn(v, a.base[(a.base_rows > 1 ? (long long)i * a.d : 0) + c]);
    } else {
      v = a.x[(long long)i * a.d + c];
    }
    if (a.attack != ATTACK_NONE && s_mask[i] > 0.f)
      v = a.attack == ATTACK_BF ? -v : forged;
    s_x[i * TILE + tid] = v;
  }

  float* rows = s_x;
  if (bucketed) {
    for (int b = 0; b < m; ++b) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j)
        acc = __fmaf_rn(s_w[b * n + j], s_x[j * TILE + tid], acc);
      s_b[b * TILE + tid] = acc;
    }
    rows = s_b;
  }

  float r;
  if (a.rule == RULE_MEAN) {
    float acc = 0.f;
    for (int i = 0; i < m; ++i) acc = __fadd_rn(acc, rows[i * TILE + tid]);
    r = __fmul_rn(acc, __frcp_rn((float)m));
  } else {
    for (int i = 1; i < m; ++i) {        // insertion sort of the column
      const float v = rows[i * TILE + tid];
      int j = i - 1;
      while (j >= 0 && rows[j * TILE + tid] > v) {
        rows[(j + 1) * TILE + tid] = rows[j * TILE + tid];
        --j;
      }
      rows[(j + 1) * TILE + tid] = v;
    }
    if (a.rule == RULE_MEDIAN) {
      const int h = m / 2;
      r = (m & 1) ? rows[h * TILE + tid]
                  : __fmul_rn(0.5f, __fadd_rn(rows[(h - 1) * TILE + tid],
                                              rows[h * TILE + tid]));
    } else {
      const int t = min(a.trim, (m - 1) / 2);
      float acc = 0.f;
      for (int i = t; i < m - t; ++i) acc = __fadd_rn(acc, rows[i * TILE + tid]);
      r = __fmul_rn(acc, __frcp_rn((float)(m - 2 * t)));
    }
  }
  a.out[c] = r;
}

extern "C" int robust_agg_tile() { return TILE; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Dense when `vals` is null; sparse wire otherwise.
extern "C" int robust_agg_launch(
    const float* x, const float* vals, const int* idx, const int* starts,
    int k, const float* base, int base_rows, const float* w_mat, int m,
    const float* mask, const float* mean, const float* stdv, int attack,
    float attack_param, int rule, int trim, int n, long long d, float* out,
    void* stream) {
  Args a;
  a.x = x; a.vals = vals; a.idx = idx; a.starts = starts; a.base = base;
  a.w_mat = w_mat; a.mask = mask; a.mean = mean; a.stdv = stdv; a.out = out;
  a.d = d; a.n = n; a.m = w_mat ? m : n; a.k = k;
  a.n_tiles = (int)((d + TILE - 1) / TILE);
  a.base_rows = base_rows; a.attack = attack; a.rule = rule; a.trim = trim;
  a.attack_param = attack_param;
  const size_t words = (size_t)n * TILE + n
      + (w_mat ? (size_t)a.m * TILE + (size_t)a.m * n : 0);
  const int smem = (int)(words * sizeof(float));
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (vals) {
    err = cudaFuncSetAttribute(robust_agg_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    robust_agg_kernel<true><<<a.n_tiles, TILE, smem, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(robust_agg_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    robust_agg_kernel<false><<<a.n_tiles, TILE, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
