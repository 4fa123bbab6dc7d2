// Block-l2 stochastic rounding for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/quantize.py::block_quantize
// (its pallas_call, body _quant_kernel): per block of 256 coordinates
//   norm  = sqrt(sum x^2)
//   level = floor(|x| / max(norm, 1e-30) * s + u)     (0 where norm == 0)
//   out   = norm * sign(x) * level * (1/s)
// with the dither u supplied, so the result is a pure function of (x, u).
//
// floor() turns a one-ulp difference in norm into a whole level, so every
// operation is the reference's own, rounded as its compiled float32 code
// on the CPU rounds it: each square rounded, the 256 squares summed as XLA
// sums 256 lanes (eight windows of 32, each in order, then the eight window
// sums in order), IEEE sqrt and division, no fused multiply-adds
// (__fmul_rn / __fadd_rn keep nvcc from contracting), and the division by
// the constant s taken as a product with the rounded 1/s, as XLA rewrites
// it. The kernel agrees with the plain version bit for bit.
//
// One warp per block of 256: lane l reads coordinates l, 32 + l, ...,
// 224 + l (coalesced), every lane takes the eight window sums in order
// through shuffles (so all lanes hold the same norm), then writes its own
// eight outputs. The ragged tail past d reads 0 (the reference pads x and
// u with zeros) and is not written.
//
// Bound: bytes -- x and u read once, out written once, 12 bytes a
// coordinate.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;               // coordinates sharing one norm
constexpr int WINDOW = 32;               // XLA's reduction window
constexpr int PER_LANE = BLOCK / WINDOW;
constexpr int WARPS = 8;                 // quantization blocks per CUDA block

__global__ void __launch_bounds__(WARPS * 32)
block_quantize_kernel(const float* __restrict__ x,
                      const float* __restrict__ u, long long d, int levels,
                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long qb = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long base = qb * BLOCK;
  if (base >= d) return;
  float xv[PER_LANE];
  float sq[PER_LANE];
  for (int j = 0; j < PER_LANE; ++j) {
    const long long i = base + j * WINDOW + lane;
    xv[j] = i < d ? x[i] : 0.0f;
    sq[j] = __fmul_rn(xv[j], xv[j]);
  }
  float acc[PER_LANE];
  for (int j = 0; j < PER_LANE; ++j) acc[j] = __shfl_sync(0xFFFFFFFFu, sq[j], 0);
  for (int src = 1; src < WINDOW; ++src)
    for (int j = 0; j < PER_LANE; ++j)
      acc[j] = __fadd_rn(acc[j], __shfl_sync(0xFFFFFFFFu, sq[j], src));
  float total = acc[0];
  for (int j = 1; j < PER_LANE; ++j) total = __fadd_rn(total, acc[j]);
  const float norm = __fsqrt_rn(total);
  const float s = (float)levels;
  const float inv = __fdiv_rn(1.0f, s);
  const float den = fmaxf(norm, 1e-30f);
  for (int j = 0; j < PER_LANE; ++j) {
    const long long i = base + j * WINDOW + lane;
    if (i >= d) continue;
    const float a = xv[j];
    const float scaled = norm > 0.0f ? __fdiv_rn(fabsf(a), den) : 0.0f;
    const float level = floorf(__fadd_rn(__fmul_rn(scaled, s), u[i]));
    const float sgn = a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : a);
    out[i] = __fmul_rn(__fmul_rn(__fmul_rn(norm, sgn), level), inv);
  }
}

}  // namespace

// x, u, out (d,) float32; levels >= 1. Returns the CUDA error of the launch
// (0 when it was accepted).
extern "C" int block_quantize_launch(const float* x, const float* u,
                                     long long d, int levels, float* out,
                                     void* stream) {
  const long long qblocks = (d + BLOCK - 1) / BLOCK;
  const long long blocks = (qblocks + WARPS - 1) / WARPS;
  if (d < 1 || levels < 1 || blocks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  block_quantize_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                          (cudaStream_t)stream>>>(x, u, d, levels, out);
  return (int)cudaGetLastError();
}
