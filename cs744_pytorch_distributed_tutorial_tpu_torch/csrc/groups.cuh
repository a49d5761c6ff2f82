// The groups of the grouped matrix products (gmm.cu, gmm_tc.cu) that meet a
// block's rows, found by one warp from group_sizes in device memory.
//
// Group e holds rows [start_e, end_e) of the contiguous layout: start_e is
// the sum of group_sizes[0 .. e-1] and end_e that sum plus group_sizes[e],
// both clamped to M, and the last group runs to M. A block that owns rows
// [row_lo, row_hi) visits, in order, every group whose rows meet them.
//
// No table of all the groups is kept, so any number of groups E >= 1 is
// taken: the warp reads 32 sizes a step (one load a lane), takes their
// inclusive prefix sum by shuffles, and picks the groups that meet the rows
// by a ballot (one step at E = 8, eight at E = 256). gmm.cu's FFMA kernel
// walks them so in its main loop (GroupWalk). gmm_tc.cu's mainloop lists
// them in shared memory once a block (list_groups) and reads its visits
// from the list, as it read a table of the group ends before: a block of R
// rows meets at most R groups, each holding one of its rows, so R entries
// are room enough. Each was the faster of the two on its kernel in paired
// runs at E = 8 against the kernels with a table of at most 64 groups.

#pragma once

#include <stdint.h>

namespace groups {

__device__ __forceinline__ int clamp_rows(int64_t rows, int M) {
  return static_cast<int>(rows < M ? rows : M);
}

// for (GroupWalk w(...); w.next(&e, &lo, &hi);) visits every group e, in
// order, whose rows meet [row_lo, row_hi), with [lo, hi) the rows it holds
// there. Every lane of the calling warp must make the same calls; every warp
// of a block that walks sees the same groups in the same order, so the loop
// body may hold block- or warpgroup-wide barriers.
struct GroupWalk {
  const int* __restrict__ sizes;
  int E, M, row_lo, row_hi;
  int e0 = -32;      // the first group of the step in hand
  int64_t base = 0;  // the sum of the sizes before the next step's groups
  unsigned hits = 0;  // the step's groups that meet the rows, not yet visited
  int lo_l = 0, hi_l = 0;  // this lane's group's rows there

  __device__ __forceinline__ GroupWalk(const int* group_sizes, int num_groups, int rows,
                                       int lo, int hi)
      : sizes(group_sizes), E(num_groups), M(rows), row_lo(lo), row_hi(hi) {}

  __device__ __forceinline__ bool next(int* e, int* lo, int* hi) {
    const int lane = threadIdx.x % 32;
    while (!hits) {
      e0 += 32;
      if (e0 >= E) return false;
      const int g = e0 + lane;
      const int64_t size = g < E ? sizes[g] : 0;
      int64_t acc = size;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t v = __shfl_up_sync(0xffffffffu, acc, d);
        if (lane >= d) acc += v;
      }
      const int64_t end_rows = base + acc;
      const int start = clamp_rows(end_rows - size, M);
      const int end = g == E - 1 ? M : clamp_rows(end_rows, M);
      lo_l = start > row_lo ? start : row_lo;
      hi_l = end < row_hi ? end : row_hi;
      hits = __ballot_sync(0xffffffffu, g < E && lo_l < hi_l);
      base = __shfl_sync(0xffffffffu, end_rows, 31);
    }
    const int l = __ffs(hits) - 1;
    hits &= hits - 1;
    *e = e0 + l;
    *lo = __shfl_sync(0xffffffffu, lo_l, l);
    *hi = __shfl_sync(0xffffffffu, hi_l, l);
    return true;
  }
};

// One warp lists, in order, the groups that meet [row_lo, row_hi) and the
// rows each holds there into e[], lo[] and hi[] (shared memory, room for
// cap = row_hi - row_lo entries or more: enough unless a size is negative,
// and never written past); returns how many it listed, the same on every
// lane. Every lane of the warp must call it.
__device__ __forceinline__ int list_groups(const int* __restrict__ group_sizes, int E, int M,
                                           int row_lo, int row_hi, int* e_out, int* lo_out,
                                           int* hi_out, int cap) {
  int n = 0, e, lo, hi;
  for (GroupWalk walk(group_sizes, E, M, row_lo, row_hi); walk.next(&e, &lo, &hi) && n < cap;
       ++n) {
    if (threadIdx.x % 32 == 0) e_out[n] = e, lo_out[n] = lo, hi_out[n] = hi;
  }
  return n;
}

}  // namespace groups
