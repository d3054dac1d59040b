// Shared stages of the two record decodes (compact_decode.cu and
// split_decode.cu): a warp copies the byte runs of up to 32 records as one
// flattened run (compact_decode's literals), and runs a group of 32
// records' matches in dependency levels, each ready record copied by its
// own lane (flattening the levels' copies too was 2.7 times slower:
// PERF.md, section 6).
//
// A group's lane l holds one record whose match copies n bytes from io
// position ms to md (n = 0: the record copies no match bytes). The caller
// guarantees what the conformance checks of both kernels establish:
//   - every source ends at or before its own output: ms + n <= md;
//   - the match outputs of the group increase with the lane and are
//     disjoint;
//   - every byte before the group's first match output that a source
//     reads is final.
// A record is ready when its source meets the output of no earlier record
// of the group that was still pending when the level began. All ready
// records copy together; then the next level begins. No ready record reads
// a byte that another record of the same level writes: a pending earlier
// writer blocks its reader, and a later writer writes past the reader's
// own output. So the bytes are those of running the records one by one in
// order, and a group takes as many steps as its longest dependency chain.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rg {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// bytes a lane copies at once (against 4 and 16: PERF.md, section 6)
constexpr int kUnroll = 8;

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
  for (int d = 1; d < kLanes; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__device__ __forceinline__ int64_t warp_incl_max(int64_t v, int lane) {
  for (int d = 1; d < kLanes; d <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, v, d);
    if (lane >= d && u > v) v = u;
  }
  return v;
}

// Copies the runs of every lane (n bytes from `from` to `to`; n = 0 for
// none) as one flattened run over the whole warp, kUnroll bytes a lane at
// a time: all their loads, then all their stores. Byte j belongs to the
// first lane whose running end exceeds j, found by a binary search over
// the ends with shuffles. read(x) and write(x, v) address the caller's
// positions. No run may read a byte that another run writes.
template <class Read, class Write>
__device__ __forceinline__ void copy_flat(int n, int from, int to, int lane,
                                          Read read, Write write) {
  const int end = warp_incl_sum(n, lane);
  const int start = end - n;
  const int total = __shfl_sync(kFull, end, kLanes - 1);
  for (int j0 = 0; j0 < total; j0 += kLanes * kUnroll) {   // warp-uniform
    int at[kUnroll];
    uint8_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kLanes + lane;
      int q = 0;
#pragma unroll
      for (int step = kLanes / 2; step > 0; step >>= 1)
        if (__shfl_sync(kFull, end, q + step - 1) <= j) q += step;
      const int i = j - __shfl_sync(kFull, start, q);
      const int f = __shfl_sync(kFull, from, q);
      const int t = __shfl_sync(kFull, to, q);
      at[u] = -1;
      if (j < total) {
        at[u] = t + i;
        v[u] = read(f + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (at[u] >= 0) write(at[u], v[u]);
  }
}

// Copies the lane's own run (n bytes from `from` to `to`), kUnroll bytes
// at a time: all their loads, then all their stores.
template <class Read, class Write>
__device__ __forceinline__ void copy_own(int n, int from, int to, Read read,
                                         Write write) {
  for (int i = 0; i < n; i += kUnroll) {
    uint8_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u < n) v[u] = read(from + i + u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u < n) write(to + i + u, v[u]);
  }
}

// Runs one group's matches by dependency levels (the contract above); a
// ready lane copies its own match.
// Returns the levels taken (0 when no lane copies a match).
template <class Read, class Write>
__device__ int run_levels(int ms, int md, int n, int lane, Read read,
                          Write write) {
  const int g0 = static_cast<int>(__reduce_min_sync(
      kFull, n > 0 ? static_cast<unsigned>(md) : 0x7FFFFFFFu));
  // dep: the earlier lanes whose match output this lane's source meets.
  // A source that ends at or before the group's first output meets none.
  const bool inside = n > 0 && ms + n > g0;
  unsigned dep = 0;
  if (__any_sync(kFull, inside)) {
    for (int j = 0; j < kLanes; ++j) {
      const int dj = __shfl_sync(kFull, md, j);
      const int nj = __shfl_sync(kFull, n, j);
      if (inside && j < lane && nj > 0 && dj < ms + n && ms < dj + nj)
        dep |= 1u << j;
    }
  }
  unsigned pending = __ballot_sync(kFull, n > 0);
  int levels = 0;
  while (pending) {
    const bool ready = (pending >> lane & 1u) && !(dep & pending);
    pending &= ~__ballot_sync(kFull, ready);
    if (ready) copy_own(n, ms, md, read, write);
    __syncwarp();
    ++levels;
  }
  return levels;
}

}  // namespace rg
