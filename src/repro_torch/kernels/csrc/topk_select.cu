// TopK candidate pools for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/quantize.py::topk_select (its
// pallas_call): for each 2048-column tile of a row, the cp largest |x| and
// their global column indices. The caller then selects the exact top k
// from the (tiles, cp) pool; every element of the global top k lies in its
// own tile's top min(k, 2048) <= cp, so the pool holds the answer.
//
// Order: descending |x|, ascending index among equal values, and the
// padded tail past d reads -1.0 (below any |x|). Each (value, index) pair
// is one 64-bit key -- the float's bits made order-preserving above, the
// complemented index below -- so one unsigned comparison gives that total
// order, and the kernel agrees exactly with the plain version's stable
// sort: selection only compares, it computes nothing.
//
// Batched over rows (workers): one block per (row, tile), grid flattened.
// The block loads its tile into shared memory (2048 keys, 16 KB) and sorts
// it with a bitonic network, 1024 threads, one compare-exchange each per
// pass (66 passes), then writes the first cp pairs.
//
// Bound: bytes -- x read once (4 bytes a column) and the pools written
// (8 bytes an entry). The sort is O(log^2 2048) passes in shared memory,
// a few microseconds a block: the kernel is simple and right first; a
// faster one would sort in registers and warp shuffles before shared
// memory, and keep only the top cp after the first passes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 2048;
constexpr int THREADS = TILE / 2;

__device__ __forceinline__ unsigned long long make_key(float a,
                                                       unsigned idx) {
  unsigned u = __float_as_uint(a);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - idx);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned u = (unsigned)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)key);
}

__global__ void __launch_bounds__(THREADS)
topk_pool(const float* __restrict__ x, long long d, int tiles, int cp,
          float* __restrict__ pv, int* __restrict__ pi) {
  __shared__ unsigned long long key[TILE];
  const long long b = blockIdx.x;               // row * tiles + tile
  const long long row = b / tiles;
  const long long first = (b % tiles) * (long long)TILE;
  const float* xr = x + row * d;
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const long long g = first + j;
    key[j] = make_key(g < d ? fabsf(xr[g]) : -1.0f, (unsigned)g);
  }
  __syncthreads();
  const int t = threadIdx.x;
  for (int size = 2; size <= TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int i = 2 * t - (t & (stride - 1));  // bit `stride` of i is 0
      const int l = i + stride;
      const bool desc = (i & size) == 0;        // the last merge: all desc
      const unsigned long long a = key[i], c = key[l];
      if ((a < c) == desc) {
        key[i] = c;
        key[l] = a;
      }
      __syncthreads();
    }
  }
  for (int j = t; j < cp; j += THREADS) {
    const unsigned long long k = key[j];
    pv[b * cp + j] = key_value(k);
    pi[b * cp + j] = key_index(k);
  }
}

}  // namespace

// x (rows, d) float32, d > 2 * 2048; pv, pi (rows, tiles, cp) with
// tiles = ceil(d / 2048) and 128 <= cp <= 2048. Returns the CUDA error of
// the launch (0 when it was accepted).
extern "C" int topk_pool_launch(const float* x, long long rows, long long d,
                                int tiles, int cp, float* pv, int* pi,
                                void* stream) {
  const long long blocks = rows * tiles;
  if (blocks < 1 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  topk_pool<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, d, tiles, cp, pv, pi);
  return (int)cudaGetLastError();
}
