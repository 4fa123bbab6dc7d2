// TopK's selection for Hopper (sm_90a): an exact radix select over each
// row, then an ordered compaction.
//
// Replaces the TPU kernel of repro/kernels/quantize.py::topk_select (its
// pallas_call, which keeps each 2048-column tile's top candidates in VMEM
// because a TPU kernel sees one tile at a time; the card has no such
// limit). The function is lax.top_k(|x|, k)[1]: for each row of x
// (rows, d), the k largest |x|, equal values by ascending index, NaN above
// +inf. The kernels write that support in ascending index order (the
// sparse wire's), with the values x at it; for topk_select the wrapper
// (kernels/quantize.py) orders it by a stable descending sort of the k
// values.
//
// Key: the bits of |x| (sign cleared) are order-preserving as an unsigned
// integer, every NaN mapped to one key (0x7FC00000) so that NaNs tie and
// fall to the lower index, as the plain version's stable sort puts them.
// Three digits of 11, 10 and 10 bits, from the top, find the k-th largest
// key T: at each level a histogram of the digit over the keys that share
// the digits found so far, then the digit where the count from the top
// reaches `need` (the k still to place). Counts are integers, so atomics
// on them give the same histogram in any order; `need` = k minus the keys
// above T is how many keys equal to T are kept, the first in index order.
// The compaction keeps every key > T and those first `need` keys == T,
// from counts of each block and warp, an exclusive scan over the blocks in
// block order, and in-order writes: no position depends on the order
// atomics land in, so a call repeats bit for bit and equals the plain
// twins of kernels/quantize.py (topk_threshold_plain, topk_compact_plain)
// exactly.
//
// Two shapes:
//   rows of at most SMALL_D columns (the Byz-EF21 main path, 5 x 5000):
//     one block a row and one launch; the row's keys stay in shared memory
//     through the three histograms and the compaction;
//   wider rows: blocks of CHUNK consecutive columns, a warp WARP_SPAN of
//     them, seven launches over a workspace (its counters zeroed with one
//     memset): hist0 over x; the top digit's pick, one block a row; hist1
//     over x, which also writes the candidates (the keys whose top digit
//     is T's), a run for each block, and counts each warp's keys above
//     the top digit and candidates; hist2 and the counts of each block's
//     and warp's candidates > T and == T over the candidates alone (these
//     launches, few blocks, pick the second and third digits themselves);
//     the scan of the block counts; the writes over x, each warp from its
//     offset. x is read three times.
//
// Bound: bytes -- x read once and the k indices written,
// 4 * rows * (d + k) bytes. The histograms are plain shared atomics; the
// writes scan within each warp, with no barrier.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned NONE = 0xFFFFFFFFu;    // no bin: the lane counts nothing
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SMALL_D = 16384;            // widest row of the one-block path
constexpr int SMALL_THREADS = 1024;
constexpr int THREADS = 512;              // the wide path's blocks
constexpr int WARPS = THREADS / 32;
constexpr int TILES = 8;                  // steps of 128 columns a warp
constexpr int WARP_SPAN = 128 * TILES;    // consecutive columns a warp owns
constexpr int CHUNK = WARP_SPAN * WARPS;  // columns a wide block owns
// a row's state: the top digit's prefix and need, the first two's, and
// T and need; each launch writes slots that no block of it reads
constexpr int STATE = 6;

// the three digits: shift and bins of level l
__host__ __device__ constexpr int level_shift(int l) {
  return l == 0 ? 20 : l == 1 ? 10 : 0;
}
__host__ __device__ constexpr int level_bins(int l) {
  return l == 0 ? 2048 : 1024;
}

__device__ __forceinline__ unsigned abs_key(float v) {
  const unsigned u = __float_as_uint(v) & 0x7FFFFFFFu;
  return u > 0x7F800000u ? 0x7FC00000u : u;
}

// Whether `key` shares the digits above level l with `prefix`.
__device__ __forceinline__ bool in_prefix(unsigned key, unsigned prefix,
                                          int l) {
  const int hi = level_shift(l) + (l == 0 ? 11 : 10);
  return (key >> hi) == (prefix >> hi);
}

__device__ __forceinline__ unsigned digit(unsigned key, int l) {
  return (key >> level_shift(l)) & (unsigned)(level_bins(l) - 1);
}

// h[bin] += 1 unless bin is NONE: a plain shared atomic.
__device__ __forceinline__ void add_one(unsigned* h, unsigned bin) {
  if (bin != NONE) atomicAdd(&h[bin], 1u);
}

// Sum of v over the lanes of a warp (every lane gets it).
__device__ __forceinline__ unsigned warp_total(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Exclusive prefix of v over the threads of the block in thread order, and
// the block's total. Starts and ends with every thread at a barrier.
template <int NT>
__device__ __forceinline__ unsigned long long block_scan(
    unsigned long long v, unsigned long long* s_warp,
    unsigned long long* total) {
  constexpr int WARPS = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < WARPS ? s_warp[lane] : 0ull;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) s_warp[lane] = w;
  }
  __syncthreads();
  const unsigned long long before = warp ? s_warp[warp - 1] : 0ull;
  *total = s_warp[WARPS - 1];
  __syncthreads();
  return before + incl - v;
}

// The digit of level l (over `bins` counts h) where the count from the top
// reaches need: s_pick = {digit, need - (keys above it)}. Every thread
// sees s_pick after the call.
template <int NT>
__device__ __forceinline__ void pick_digit(const unsigned* h, int bins,
                                           int need,
                                           unsigned long long* s_warp,
                                           int* s_pick) {
  const int per = (bins + NT - 1) / NT;
  const int r0 = threadIdx.x * per;          // from the top: bin bins-1-r
  unsigned long long sum = 0;
  for (int r = r0; r < r0 + per && r < bins; ++r) sum += h[bins - 1 - r];
  unsigned long long total;
  unsigned long long acc = block_scan<NT>(sum, s_warp, &total);
  for (int r = r0; r < r0 + per && r < bins; ++r) {
    const unsigned c = h[bins - 1 - r];
    if (acc < (unsigned long long)need && acc + c >= (unsigned long long)need) {
      s_pick[0] = bins - 1 - r;
      s_pick[1] = need - (int)acc;
    }
    acc += c;
  }
  __syncthreads();
}

// The ordered compaction of one tile: this thread's 4 consecutive keys
// (columns i0.., those at or past d invalid) against T; `gt` and `eq` the
// row's counts of keys > T and == T before the tile, advanced past it.
// A kept column goes to position (keys > T before it) + min(keys == T
// before it, need): emit(position, column, e) for its e-th key.
template <int NT, typename Emit>
__device__ __forceinline__ void compact_tile(
    const unsigned (&key)[4], long long i0, long long d, unsigned T,
    unsigned need, unsigned long long* s_warp, unsigned long long* gt,
    unsigned long long* eq, Emit emit) {
  unsigned cg = 0, ce = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool ok = i0 + e < d;
    cg += ok && key[e] > T;
    ce += ok && key[e] == T;
  }
  unsigned long long total;
  const unsigned long long before =
      block_scan<NT>(((unsigned long long)cg << 32) | ce, s_warp, &total);
  unsigned long long g = *gt + (before >> 32);
  unsigned long long q = *eq + (before & 0xFFFFFFFFull);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (i0 + e >= d) break;
    if (key[e] > T) {
      emit(g + (q < need ? q : need), i0 + e, e);
      ++g;
    } else if (key[e] == T) {
      if (q < need) emit(g + q, i0 + e, e);
      ++q;
    }
  }
  *gt += total >> 32;
  *eq += total & 0xFFFFFFFFull;
}

// --- rows of at most SMALL_D columns: one block a row -------------------

// One block a row: the row's keys in shared memory, the support written
// ascending.
__global__ void __launch_bounds__(SMALL_THREADS) topk_row_kernel(
    const float* __restrict__ x, int d, int k, int* __restrict__ out_idx,
    float* __restrict__ out_val) {
  extern __shared__ unsigned s_key[];                      // (d,)
  __shared__ unsigned s_hist[2048];
  __shared__ unsigned long long s_warp[32];
  __shared__ int s_pick[2];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const float* xr = x + row * d;
  int* oi = out_idx + row * k;
  float* ov = out_val + row * k;
  for (int i = tid; i < d; i += SMALL_THREADS) s_key[i] = abs_key(xr[i]);
  unsigned prefix = 0;
  int need = k;
  for (int l = 0; l < 3; ++l) {
    const int bins = level_bins(l);
    for (int b = tid; b < bins; b += SMALL_THREADS) s_hist[b] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < d; i0 += SMALL_THREADS) {   // uniform trip count
      const int i = i0 + tid;
      const unsigned key = i < d ? s_key[i] : 0;
      add_one(s_hist,
                 i < d && in_prefix(key, prefix, l) ? digit(key, l) : NONE);
    }
    __syncthreads();
    pick_digit<SMALL_THREADS>(s_hist, bins, need, s_warp, s_pick);
    prefix |= (unsigned)s_pick[0] << level_shift(l);
    need = s_pick[1];
    __syncthreads();
  }
  unsigned long long gt = 0, eq = 0;
  for (int i0 = 0; i0 < d; i0 += 4 * SMALL_THREADS) {
    const int i = i0 + 4 * tid;
    unsigned key[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) key[e] = i + e < d ? s_key[i + e] : 0;
    compact_tile<SMALL_THREADS>(
        key, i, d, prefix, (unsigned)need, s_warp, &gt, &eq,
        [&](unsigned long long pos, long long col, int e) {
          oi[pos] = (int)col;
          ov[pos] = xr[col];
        });
  }
}

// --- wider rows ----------------------------------------------------------

// The wide path's scratch, carved from one workspace: the part that must
// start at zero first (one memset).
struct Work {
  unsigned *hist0, *hist1, *hist2, *cand_n;                  // zeroed
  unsigned *above, *cnt_gt, *cnt_eq, *cand_key;
  unsigned *cand_at, *cand_cnt;   // a wide block's candidates: where, how many
  // each warp of a wide block (rows, bpr, WARPS): its keys above the top
  // digit, its candidates, and of those the keys > T and == T
  unsigned *w_above, *w_cand, *w_gt, *w_eq;
  int* state;                 // (rows, STATE)
  unsigned long long* pre;    // (rows, bpr) block prefixes: gt << 32 | eq
  size_t zero_bytes, bytes;
};

inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

inline Work carve(char* base, long long rows, long long d) {
  const long long bpr = (d + CHUNK - 1) / CHUNK;
  Work w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base + off;
    off += align16(bytes);
    return p;
  };
  w.hist0 = (unsigned*)take(rows * 2048 * 4);
  w.hist1 = (unsigned*)take(rows * 1024 * 4);
  w.hist2 = (unsigned*)take(rows * 1024 * 4);
  w.cand_n = (unsigned*)take(rows * 4);
  w.zero_bytes = off;
  w.cnt_gt = (unsigned*)take(rows * bpr * 4);
  w.cnt_eq = (unsigned*)take(rows * bpr * 4);
  w.cand_at = (unsigned*)take(rows * bpr * 4);
  w.cand_cnt = (unsigned*)take(rows * bpr * 4);
  w.w_above = (unsigned*)take(rows * bpr * WARPS * 4);
  w.w_cand = (unsigned*)take(rows * bpr * WARPS * 4);
  w.w_gt = (unsigned*)take(rows * bpr * WARPS * 4);
  w.w_eq = (unsigned*)take(rows * bpr * WARPS * 4);
  w.above = (unsigned*)take(rows * bpr * 4);
  w.state = (int*)take(rows * STATE * 4);
  w.pre = (unsigned long long*)take(rows * bpr * 8);
  w.cand_key = (unsigned*)take(rows * d * 4);
  w.bytes = off;
  return w;
}

// Column of this thread's e-th value of step t in the chunk at c0: a warp
// owns WARP_SPAN consecutive columns, 128 a step, a lane 4 of them.
__device__ __forceinline__ long long chunk_col(long long c0, int t, int e) {
  return c0 + (long long)(threadIdx.x >> 5) * WARP_SPAN + t * 128 +
         4 * (threadIdx.x & 31) + e;
}

// This thread's 4 x TILES values of the chunk at c0 of row xr (one 16-byte
// load a step where the row is aligned); past d reads 0.
__device__ __forceinline__ void load_chunk(const float* xr, long long d,
                                           long long c0,
                                           float (&v)[TILES][4]) {
  const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const long long i = chunk_col(c0, t, 0);
    if (vec && i + 4 <= d) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(xr + i));
      v[t][0] = f.x; v[t][1] = f.y; v[t][2] = f.z; v[t][3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[t][e] = i + e < d ? xr[i + e] : 0.f;
    }
  }
}

// The histogram's nonzero bins into the row's global one.
__device__ __forceinline__ void flush(const unsigned* s_h, int bins,
                                      unsigned* g) {
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x)
    if (s_h[b]) atomicAdd(&g[b], s_h[b]);
}

__global__ void __launch_bounds__(THREADS) radix_hist0(
    const float* __restrict__ x, long long d, int bpr, Work w) {
  __shared__ unsigned s_h[2048];
  const long long row = blockIdx.x / bpr;
  const long long c0 = (blockIdx.x % bpr) * (long long)CHUNK;
  const float* xr = x + row * d;
  for (int b = threadIdx.x; b < 2048; b += THREADS) s_h[b] = 0;
  float v[TILES][4];
  load_chunk(xr, d, c0, v);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      add_one(s_h, chunk_col(c0, t, e) < d ? digit(abs_key(v[t][e]), 0)
                                              : NONE);
  flush(s_h, 2048, w.hist0 + row * 2048);
}

// One block a row: the top digit from hist0 (its prefix and need, the
// state's first two slots).
__global__ void __launch_bounds__(1024) radix_pick0(int k, Work w) {
  __shared__ unsigned long long s_warp[32];
  __shared__ int s_pick[2];
  const long long row = blockIdx.x;
  pick_digit<1024>(w.hist0 + row * 2048, 2048, k, s_warp, s_pick);
  if (threadIdx.x == 0) {
    w.state[row * STATE] = s_pick[0] << 20;
    w.state[row * STATE + 1] = s_pick[1];
  }
}

// Histograms the second digit over the keys that share the top one,
// writes them as the row's candidates, a run for each block (one global
// atomic a block reserves it; the run's place and length are kept), and
// counts the block's keys above the top digit.
__global__ void __launch_bounds__(THREADS) radix_hist1(
    const float* __restrict__ x, long long d, int bpr, Work w) {
  __shared__ unsigned s_h[1024];
  __shared__ unsigned long long s_warp[32];
  __shared__ unsigned s_wn[THREADS / 32], s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x / bpr;
  const int blk = blockIdx.x % bpr;
  const long long c0 = blk * (long long)CHUNK;
  const float* xr = x + row * d;
  for (int b = tid; b < 1024; b += THREADS) s_h[b] = 0;
  float v[TILES][4];
  load_chunk(xr, d, c0, v);
  const unsigned prefix = (unsigned)w.state[row * STATE];
  __syncthreads();                     // s_h is zero
  unsigned above = 0, mine = 0;
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = chunk_col(c0, t, e) < d;
      const unsigned key = abs_key(v[t][e]);
      const bool cand = ok && (key >> 20) == (prefix >> 20);
      above += ok && (key >> 20) > (prefix >> 20);
      mine += cand;
      add_one(s_h, cand ? digit(key, 1) : NONE);
    }
  mine = warp_total(mine);
  const long long wq = (row * bpr + blk) * WARPS + warp;
  if (lane == 0) {
    s_wn[warp] = mine;
    w.w_cand[wq] = mine;
  }
  const unsigned w_above = warp_total(above);
  if (lane == 0) w.w_above[wq] = w_above;
  __syncthreads();
  if (tid == 0) {
    unsigned total = 0;
    for (int q = 0; q < THREADS / 32; ++q) {
      const unsigned c = s_wn[q];
      s_wn[q] = total;
      total += c;
    }
    s_base = total ? atomicAdd(&w.cand_n[row], total) : 0;
    w.cand_at[row * bpr + blk] = s_base;
    w.cand_cnt[row * bpr + blk] = total;
  }
  __syncthreads();
  unsigned pos = s_base + s_wn[warp];
  const long long cap = d;
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long i = chunk_col(c0, t, e);
      const unsigned key = abs_key(v[t][e]);
      const bool cand = i < d && (key >> 20) == (prefix >> 20);
      const unsigned m = __ballot_sync(FULL, cand);
      if (cand) {
        const unsigned p = pos + __popc(m & ((1u << lane) - 1));
        w.cand_key[row * cap + p] = key;
      }
      pos += __popc(m);
    }
  unsigned long long total;
  block_scan<THREADS>(above, s_warp, &total);
  if (tid == 0) w.above[row * bpr + blk] = (unsigned)total;
  flush(s_h, 1024, w.hist1 + row * 1024);
}

// Over the row's candidates, `nb` blocks a row: picks the second digit
// (from hist1) and histograms the third over the candidates that share
// the first two.
__global__ void __launch_bounds__(THREADS) radix_hist2(long long d, int nb,
                                                       Work w) {
  __shared__ unsigned s_h[1024];
  __shared__ unsigned long long s_warp[32];
  __shared__ int s_pick[2];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x / nb;
  const int j = blockIdx.x % nb;
  for (int b = tid; b < 1024; b += THREADS) s_h[b] = 0;
  const unsigned prefix0 = (unsigned)w.state[row * STATE];
  pick_digit<THREADS>(w.hist1 + row * 1024, 1024, w.state[row * STATE + 1],
                      s_warp, s_pick);
  const unsigned prefix = prefix0 | ((unsigned)s_pick[0] << 10);
  const long long n = w.cand_n[row];
  const unsigned* ck = w.cand_key + row * d;
  for (long long i0 = (long long)j * THREADS; i0 < n;
       i0 += (long long)nb * THREADS) {
    const long long i = i0 + tid;
    const unsigned key = i < n ? ck[i] : 0;
    add_one(s_h, i < n && (key >> 10) == (prefix >> 10) ? digit(key, 2)
                                                           : NONE);
  }
  flush(s_h, 1024, w.hist2 + row * 1024);
  if (j == 0 && tid == 0) {
    w.state[row * STATE + 2] = (int)prefix;
    w.state[row * STATE + 3] = s_pick[1];
  }
}

// A warp a wide block: picks the third digit (T and need, from hist2;
// every block of this launch, a few hundred) and counts the block's
// candidates (its run of the candidate buffer) > T and == T.
__global__ void __launch_bounds__(THREADS) radix_count(long long d, int bpr,
                                                       Work w) {
  __shared__ unsigned long long s_warp[32];
  __shared__ int s_pick[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_row = (bpr + WARPS - 1) / WARPS;
  const long long row = blockIdx.x / per_row;
  const int blk = blockIdx.x % per_row * WARPS + warp;
  const unsigned prefix1 = (unsigned)w.state[row * STATE + 2];
  pick_digit<THREADS>(w.hist2 + row * 1024, 1024, w.state[row * STATE + 3],
                      s_warp, s_pick);
  const unsigned T = prefix1 | (unsigned)s_pick[0];
  if (blockIdx.x % per_row == 0 && threadIdx.x == 0) {
    w.state[row * STATE + 4] = (int)T;
    w.state[row * STATE + 5] = s_pick[1];
  }
  if (blk >= bpr) return;
  const long long q = row * bpr + blk;
  const unsigned* ck = w.cand_key + row * d + w.cand_at[q];
  unsigned gt = 0, eq = 0;   // the run holds the block's warps' in order
  for (int u = 0; u < WARPS; ++u) {
    const unsigned n = w.w_cand[q * WARPS + u];
    unsigned ug = 0, ue = 0;
    for (unsigned i = lane; i < n; i += 32) {
      const unsigned key = ck[i];
      ug += key > T;
      ue += key == T;
    }
    ug = warp_total(ug);
    ue = warp_total(ue);
    if (lane == 0) {
      w.w_gt[q * WARPS + u] = ug;
      w.w_eq[q * WARPS + u] = ue;
    }
    gt += ug;
    eq += ue;
    ck += n;
  }
  if (lane == 0) {
    w.cnt_gt[q] = gt;
    w.cnt_eq[q] = eq;
  }
}

// One block a row: the exclusive prefixes, in block order, of the blocks'
// keys > T and == T.
__global__ void __launch_bounds__(1024) radix_scan(int bpr, Work w) {
  __shared__ unsigned long long s_warp[32];
  const long long row = blockIdx.x;
  unsigned long long carry = 0;
  for (int b0 = 0; b0 < bpr; b0 += 1024) {
    const int b = b0 + threadIdx.x;
    const long long q = row * bpr + b;
    const unsigned long long v =
        b < bpr ? ((unsigned long long)(w.above[q] + w.cnt_gt[q]) << 32) |
                      w.cnt_eq[q]
                : 0ull;
    unsigned long long total;
    const unsigned long long before = block_scan<1024>(v, &s_warp[0], &total);
    if (b < bpr) w.pre[q] = carry + before;
    carry += total;
  }
}

// The ordered writes: each block its chunk, from its prefixes (a block
// with nothing to keep returns before it reads x); each warp its span,
// from the block's prefix and the counts of the warps before it (kept by
// hist1 and radix_count), 128 columns a step with a scan inside the warp:
// a kept column goes to (keys > T before it) + min(keys == T before it,
// need). Positions are below k < 2^31 and columns below d < 2^31: 32-bit
// arithmetic.
__global__ void __launch_bounds__(THREADS) radix_write(
    const float* __restrict__ x, long long d, int k, int bpr, Work w,
    int* __restrict__ out_idx, float* __restrict__ out_val) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x / bpr;
  const int blk = blockIdx.x % bpr;
  const long long q = row * bpr + blk;
  const unsigned T = (unsigned)w.state[row * STATE + 4];
  const unsigned need = (unsigned)w.state[row * STATE + 5];
  const unsigned long long pre = w.pre[q];
  unsigned gt = (unsigned)(pre >> 32), eq = (unsigned)pre;
  if (w.above[q] + w.cnt_gt[q] == 0 && (w.cnt_eq[q] == 0 || eq >= need))
    return;
  for (int u = 0; u < warp; ++u) {
    gt += w.w_above[q * WARPS + u] + w.w_gt[q * WARPS + u];
    eq += w.w_eq[q * WARPS + u];
  }
  if (w.w_above[q * WARPS + warp] + w.w_gt[q * WARPS + warp] == 0 &&
      (w.w_eq[q * WARPS + warp] == 0 || eq >= need))
    return;                            // nothing of this warp's is kept
  const float* xr = x + row * d;
  const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  const int col0 = (int)chunk_col(blk * (long long)CHUNK, 0, 0);
  // this lane's columns col0 + t * 128 + e, those at or past d invalid
  // (they read 0.0f, which equals T where T is 0)
  const int c_end = (int)(d - col0 < (1 << 30) ? d - col0 : (1 << 30));
  float v[TILES][4];
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const int c = col0 + t * 128;
    if (vec && t * 128 + 4 <= c_end) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(xr + c));
      v[t][0] = f.x; v[t][1] = f.y; v[t][2] = f.z; v[t][3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[t][e] = t * 128 + e < c_end ? xr[c + e] : 0.f;
    }
  }
  int* oi = out_idx + row * k;
  float* ov = out_val + row * k;
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const int c = col0 + t * 128;
    unsigned cnt = 0;                  // keys > T << 16 | keys == T
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned key = abs_key(v[t][e]);
      cnt += key > T ? 1u << 16 : key == T && t * 128 + e < c_end ? 1u : 0u;
    }
    unsigned incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned tot = __shfl_sync(FULL, incl, 31);
    unsigned g = gt + ((incl - cnt) >> 16);
    unsigned qq = eq + ((incl - cnt) & 0xFFFFu);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned key = abs_key(v[t][e]);
      if (key > T) {
        const unsigned pos = g + (qq < need ? qq : need);
        oi[pos] = c + e;
        ov[pos] = v[t][e];
        ++g;
      } else if (key == T && t * 128 + e < c_end) {
        if (qq < need) {
          oi[g + qq] = c + e;
          ov[g + qq] = v[t][e];
        }
        ++qq;
      }
    }
    gt += tot >> 16;
    eq += tot & 0xFFFFu;
  }
}

}  // namespace

extern "C" int topk_small_d() { return SMALL_D; }

// Bytes of the workspace of the wide path for x (rows, d), d > SMALL_D.
extern "C" long long topk_workspace_bytes(long long rows, long long d) {
  return (long long)carve(nullptr, rows, d).bytes;
}

// x (rows, d) float32 contiguous, 1 <= k <= d < 2^31; out_idx (rows, k)
// int32 ascending and out_val (rows, k) float32 = x at them; `work` of
// topk_workspace_bytes(rows, d) bytes (unused up to SMALL_D columns).
// Returns the CUDA error of the launches (0 when all were accepted).
extern "C" int topk_support_launch(const float* x, long long rows,
                                   long long d, int k, void* work,
                                   int* out_idx, float* out_val,
                                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || d < 1 || k < 1 || k > d || d > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (d <= SMALL_D) {
    if (rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)d * 4;   // + 8.3 KB of static arrays
    if (smem > 32 * 1024 &&
        (err = cudaFuncSetAttribute(topk_row_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)))
      return (int)err;
    topk_row_kernel<<<(unsigned)rows, SMALL_THREADS, smem, st>>>(
        x, (int)d, k, out_idx, out_val);
    return (int)cudaGetLastError();
  }
  const long long bpr = (d + CHUNK - 1) / CHUNK;
  if (rows * bpr > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const Work w = carve((char*)work, rows, d);
  // blocks a row over the candidates: a few waves of the card in all
  const int nb = (int)(rows >= 1024 ? 1 : 1024 / rows);
  if ((err = cudaMemsetAsync(work, 0, w.zero_bytes, st))) return (int)err;
  const unsigned grid = (unsigned)(rows * bpr);
  radix_hist0<<<grid, THREADS, 0, st>>>(x, d, (int)bpr, w);
  radix_pick0<<<(unsigned)rows, 1024, 0, st>>>(k, w);
  radix_hist1<<<grid, THREADS, 0, st>>>(x, d, (int)bpr, w);
  radix_hist2<<<(unsigned)(rows * nb), THREADS, 0, st>>>(d, nb, w);
  radix_count<<<(unsigned)(rows * ((bpr + WARPS - 1) / WARPS)), THREADS, 0,
                st>>>(d, (int)bpr, w);
  radix_scan<<<(unsigned)rows, 1024, 0, st>>>((int)bpr, w);
  radix_write<<<grid, THREADS, 0, st>>>(x, d, k, (int)bpr, w, out_idx,
                                        out_val);
  return (int)cudaGetLastError();
}
