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
// payload) and mean / std once; the Gram adds m(m+1) flops per column,
// from shared memory, which stays below the float32 rate for m <= 64.
//
// Design. On the TPU, pair_gram and rfa_iter accumulate over d into a
// revisited output block along a sequential grid. Blocks on the card run in
// any order, so a fixed grid of blocks (as many as are resident at once)
// loops over the 128-column tiles; each block keeps its partial Gram, or
// its per-row partial sums of squares, on chip, writes them once to a
// (blocks, ...) workspace, and a second launch sums the partials over the
// blocks in block order. No floating-point atomics: every sum is taken in
// a fixed order, so a call repeats bit for bit, and Krum's argmin and RFA's
// trajectory with it.
//   pair_gram: the upper triangle of xb xb^T. Each of the m(m+1)/2 pairs is
//     a dot product over the tile's columns in shared memory, split over
//     `lanes` threads (1 to 32, as many as 128 threads allow) and reduced
//     with a warp shuffle; lanes start at rotated columns, so the threads
//     of a warp hit distinct banks.
//   rfa_iter: one thread per column computes z_c (in the reference's
//     compiled order, weighted_col) and writes it, then adds (xb_bc - z_c)^2 into its own column of an (m, TILE)
//     accumulator; at the end each row of it is summed by one warp.
//   weighted_sum: a looping grid with the register load of
//     agg_prologue.cuh (several columns a thread, the rows streamed
//     through registers, the sparse wire found on the card, as
//     robust_agg.cu's register path); no W and no reduction across
//     blocks.

#include "agg_prologue.cuh"

enum { KERNEL_GRAM = 0, KERNEL_RFA = 1 };

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

template <int LOAD>
__global__ void __launch_bounds__(TILE) pair_gram_partial(
    Src a, const float* w_mat, int m, int lanes, float* part) {
  extern __shared__ float smem[];
  const bool bucketed = w_mat != nullptr;
  const Smem s = carve(smem, a.n, m, bucketed);
  const int pairs = m * (m + 1) / 2;
  float* s_g = s.rest;                      // (pairs,) this block's Gram
  int* s_pair = (int*)(s_g + pairs);        // (pairs,) i * 256 + j
  const int tid = threadIdx.x;
  stage_consts(a, w_mat, m, s);
  for (int q = tid; q < pairs; q += TILE) {
    int i, j;
    pair_of(q, m, &i, &j);
    s_pair[q] = i * 256 + j;
    s_g[q] = 0.f;
  }
  const int groups = TILE / lanes, g = tid / lanes, l = tid % lanes;
  const int steps = TILE / lanes;           // columns per lane
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const float* rows = load_tile<LOAD>(a, s, bucketed, m, tile);
    __syncthreads();                        // every column is in place
    for (int q0 = 0; q0 < pairs; q0 += groups) {   // uniform trip count
      const int q = q0 + g;
      float v = 0.f;
      if (q < pairs) {
        const float* ri = rows + (s_pair[q] >> 8) * TILE;
        const float* rj = rows + (s_pair[q] & 255) * TILE;
        int t = g % steps;
        for (int u = 0; u < steps; ++u) {
          const int c = l + lanes * t;
          v = __fmaf_rn(ri[c], rj[c], v);
          t = t + 1 == steps ? 0 : t + 1;
        }
      }
      v = warp_sum(v, lanes);
      if (q < pairs && l == 0) s_g[q] = __fadd_rn(s_g[q], v);
    }
  }
  __syncthreads();
  for (int q = tid; q < pairs; q += TILE)
    part[(long long)blockIdx.x * pairs + q] = s_g[q];
}

// G = sum of the blocks' partials, in block order, mirrored into (m, m).
__global__ void gram_finish(const float* part, int blocks, int m,
                            float* out) {
  const int pairs = m * (m + 1) / 2;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= pairs) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b)
    acc = __fadd_rn(acc, part[(long long)b * pairs + q]);
  int i, j;
  pair_of(q, m, &i, &j);
  out[i * m + j] = acc;
  out[j * m + i] = acc;
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

static size_t gram_smem(int n, int m, bool bucketed) {
  return (prologue_words(n, m, bucketed) + (size_t)m * (m + 1)) *
         sizeof(float);
}

static size_t rfa_smem(int n, int m, bool bucketed) {
  return (prologue_words(n, m, bucketed) + (size_t)m * TILE + m) *
         sizeof(float);
}

template <typename Kernel>
static int resident_blocks(Kernel kernel, size_t smem) {
  return resident_grid(kernel, TILE, smem);
}

template <int LOAD>
struct GramBlocks {
  static int run(size_t smem) {
    return resident_blocks(pair_gram_partial<LOAD>, smem);
  }
};

template <int LOAD>
struct RfaBlocks {
  static int run(size_t smem) {
    return resident_blocks(rfa_iter_partial<LOAD>, smem);
  }
};

template <int LOAD>
struct PairGram {
  static int run(Src a, const float* w_mat, int m, int lanes, int blocks,
                 float* part, float* out, size_t smem, cudaStream_t st) {
    const int got = resident_grid(pair_gram_partial<LOAD>, TILE, smem);
    if (got < 0) return -got;
    cudaError_t err;
    pair_gram_partial<LOAD><<<blocks, TILE, smem, st>>>(a, w_mat, m, lanes,
                                                        part);
    if ((err = cudaGetLastError())) return (int)err;
    const int pairs = m * (m + 1) / 2;
    gram_finish<<<(pairs + 255) / 256, 256, 0, st>>>(part, blocks, m, out);
    return (int)cudaGetLastError();
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

// How many blocks of pair_gram (kernel 0) or rfa_iter (kernel 1) on the
// source `load` are resident on the current device at once; the wrapper
// launches min(that, tiles) and sizes the workspace for it. Negative:
// -(CUDA error).
extern "C" int norm_agg_blocks(int kernel, int load, int n, int m,
                               int bucketed) {
  if (!bucketed) m = n;
  if (kernel == KERNEL_GRAM)
    return with_load<GramBlocks>(load, gram_smem(n, m, bucketed));
  return with_load<RfaBlocks>(load, rfa_smem(n, m, bucketed));
}

// The launch entry points enqueue on `stream` and return cudaGetLastError()
// (0 on success), for the source `load` (a LOAD_* code). `m` is W's row
// count (ignored without W); `part` is a (blocks, ...) workspace.

extern "C" int pair_gram_launch(SRC_PARAMS, const float* w_mat, int m,
                                int blocks, float* part, float* out,
                                void* stream) {
  const Src a = make_src(SRC_ARGS);
  if (!w_mat) m = n;
  const int pairs = m * (m + 1) / 2;
  int lanes = 1;
  while (lanes < 32 && pairs * lanes * 2 <= TILE) lanes *= 2;
  return with_load<PairGram>(load, a, w_mat, m, lanes, blocks, part, out,
                             gram_smem(n, m, w_mat != nullptr),
                             (cudaStream_t)stream);
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
