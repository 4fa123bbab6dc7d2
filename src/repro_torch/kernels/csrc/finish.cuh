// The one-launch finish of the norm kernels for Hopper (norm_agg.cu,
// norm_agg_blocked.cu): partial sums of the blocks of one unit (the whole
// grid of pair_gram and rfa_iter; the column chunks of one row block of
// sqdist_to_blocked, or of one tile pair of pair_gram_blocked) added in a
// fixed order inside the launch that made them, with no second launch and
// no floating-point atomics.
#pragma once

#include <cuda_runtime.h>

// A unit's tickets, groups + 1 counters: the blocks that have written their
// partials, a count for each group of FINISH_GROUP blocks, then the groups
// that have summed theirs; the last to count itself sets the count back to
// 0. The wrapper keeps one zeroed buffer of FINISH_TICKETS for each stream
// (launches on one stream run one after another; launches on two streams
// never share one), and a launch's units take consecutive tickets.
constexpr int FINISH_GROUP = 16;
constexpr int FINISH_MAX_GROUPS = 1024;
constexpr int FINISH_TICKETS = 4096;

__host__ __device__ inline int finish_groups(int blocks) {
  return (blocks + FINISH_GROUP - 1) / FINISH_GROUP;
}

// Block `blk` of a unit of `blocks` hands its `count` partial sums s_part
// (shared memory) on. It writes them to part[blk] of the unit's workspace
// part (blocks + groups, count). The last block of each group of
// FINISH_GROUP to finish (a ticket after a __threadfence) sums the group's
// partials in block order into part[blocks + group]; the last group to
// finish sums the groups' in group order and hands each sum q to
// write(q, sum); a unit of one group hands its group's sums at once. Each
// sum is one fixed-order sum, a thread an entry: a call repeats bit for
// bit. A unit of one block writes at once and touches neither part nor the
// tickets. Every thread of the block calls it; it returns true in every
// thread of the block that handed the sums on.
// (Two levels, so that no one block reads every block's partials: at
// m = 64 the fused Gram's are 2080 floats from each of some 260 blocks, and
// a blocked Gram tile's 16384 floats from each of 128 chunks.)
template <typename Write>
__device__ __forceinline__ bool blocks_finish(const float* s_part, int count,
                                              float* part, unsigned* tickets,
                                              int blk, int blocks,
                                              Write write) {
  __shared__ bool s_last;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int groups = finish_groups(blocks);
  const int grp = blk / FINISH_GROUP, first = grp * FINISH_GROUP;
  const int in_grp = min(FINISH_GROUP, blocks - first);
  if (blocks == 1) {                   // a narrow call: this block's sums
    for (int q = tid; q < count; q += nthreads) write(q, s_part[q]);
    return true;
  }
  for (int q = tid; q < count; q += nthreads)
    part[(long long)blk * count + q] = s_part[q];
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[grp], 1u) == in_grp - 1;
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  float* gpart = part + (long long)blocks * count;
  for (int q = tid; q < count; q += nthreads) {
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < FINISH_GROUP; ++b)
      if (b < in_grp)
        acc = __fadd_rn(acc, __ldcg(part + (long long)(first + b) * count + q));
    if (groups == 1)                   // one group: its sums are the result
      write(q, acc);
    else
      gpart[(long long)grp * count + q] = acc;
  }
  if (tid == 0) tickets[grp] = 0;
  if (groups == 1) return true;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[groups], 1u) == groups - 1;
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  for (int q = tid; q < count; q += nthreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int g = 0; g < groups; ++g)
      acc = __fadd_rn(acc, __ldcg(gpart + (long long)g * count + q));
    write(q, acc);
  }
  if (tid == 0) tickets[groups] = 0;
  return true;
}

// Words of the tickets buffer that the launches taking `tickets` need.
extern "C" int finish_tickets() { return FINISH_TICKETS; }
