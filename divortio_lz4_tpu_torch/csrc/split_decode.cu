// Placed-literal split decode for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel _make_kernel of divortio_lz4_tpu/ops/
// pallas_split_decode.py:91 (launched by decode_blocks_split at :193, the
// pl.pallas_call at :244), the round-3 decode: the host parser
// (lz4t_parse_records) places every literal byte at its output offset and
// leaves match records (w0 = offset | mlen << 16, w1 = dst), each at most
// 128 bytes. Per block:
//   - seed the output row with the literal image, lit[out_base :
//     out_base + out_cap] (out_base = 65536 when the image carries a
//     history window ahead of the block, else 0);
//   - run the block's counts[b] records in order, each read-all-then-write
//     (its source bytes are read before any of its bytes is written), with
//     the TPU kernel's clamps (:136-142), so garbage records stay inside
//     their own row:
//       dst    = max(clip(w1, 0, out_cap) + out_base, 1), w1 signed;
//       offset = clip(w0 & 0xFFFF, 1, dst);
//       mlen   = clip((w0 >> 16) & 0xFFFF, 0,
//                     min(128, out_base + out_cap - dst)).
// Addresses are those of the TPU's io row [history | block]: a source below
// out_base reads the (never written) history of the literal image, one at
// or above it reads the output row. The TPU's interleave of `ways` blocks
// per grid step, its trips and NOOP padding are scheduling: a block here
// runs its own records, so the bytes are the same.
//
// Design: one warp decodes a block. Rows of up to 64 KB live in shared
// memory, one block a CTA of kWarps warps (all of them seed the row from
// the literal image and write it back; warp 0 decodes); longer rows (a
// 256 KB block, with its 64 KB history past the 227 KB shared-memory
// limit) are decoded in place in device memory, kWarps blocks a CTA, a
// warp each. A history is read from the literal image in device memory.
// After the seed:
//   1. the conformance check, 32 records a step, on the raw words of every
//      record that writes (mlen > 0): no clamp binds (0 <= w1 <= out_cap,
//      w1 + out_base >= 1, 1 <= offset <= dst, mlen <= 128 and
//      mlen <= out_base + out_cap - dst); the record reads only bytes
//      before it (mlen <= offset); and its write range starts at or after
//      the end of every earlier one (a running maximum), so the write
//      ranges increase and are disjoint. The host parser emits only such
//      records;
//   2. a block that passes runs its matches in groups of 32 records by
//      dependency levels (record_groups.cuh), each group's record words
//      loaded with one coalesced load while the group before runs; a
//      block that fails takes the serial route, the first port's walk
//      (each lane 4 bytes of a record, __syncwarp() between a record's
//      reads and its writes).
// Both kernels are templated on the history, as compact_decode.cu's: the
// shared row then takes shared-memory loads, not generic ones. On the
// 64 MiB hybrid frame's 64 KB blocks the shared row took less than half
// the time of the row in device memory (PERF.md, section 6).
//
// What bounds it on this card: not bytes but each block's chain of group
// levels; blocks run in parallel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "record_groups.cuh"

namespace {

constexpr int kLanes = rg::kLanes;
constexpr int kWarps = 4;
constexpr int kPerLane = 4;          // kLanes * kPerLane = 128-byte records
constexpr int64_t kSpan = kLanes * kPerLane;
constexpr int kStats = 5;            // records, groups, levels, max, serial
constexpr int64_t kSharedRow = 65536;  // rows up to this in shared memory

__device__ __forceinline__ int64_t clip64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// dst[0, n) = src[0, n), threads t of nt together (16 bytes a thread
// where both rows are 16-byte aligned).
__device__ void copy_row(uint8_t* dst, const uint8_t* src, int64_t n, int t,
                         int nt) {
  int64_t i = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src))
       & 15) == 0) {
    const int64_t body = n & ~int64_t{15};
    for (int64_t j = 16 * t; j < body; j += 16 * nt)
      *reinterpret_cast<uint4*>(dst + j) =
          *reinterpret_cast<const uint4*>(src + j);
    i = body;
  }
  for (int64_t j = i + t; j < n; j += nt) dst[j] = src[j];
}

// The serial route: the block's n records in order, with every clamp.
__device__ void serial_walk(const int32_t* r, int64_t n,
                            const uint8_t* image, uint8_t* row,
                            int64_t out_base, int64_t out_cap, int lane) {
  const int64_t limit = out_base + out_cap;
  for (int64_t k = 0; k < n; ++k) {
    const int32_t w0 = __ldg(r + 2 * k);
    const int32_t w1 = __ldg(r + 2 * k + 1);
    int64_t dst = clip64(w1, 0, out_cap) + out_base;
    dst = dst < 1 ? 1 : dst;
    const int64_t offset = clip64(w0 & 0xFFFF, 1, dst);
    const int64_t mlen = clip64((w0 >> 16) & 0xFFFF, 0,
                                kSpan < limit - dst ? kSpan : limit - dst);
    const int64_t src = dst - offset;
    uint8_t v[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t i = j * kLanes + lane;
      const int64_t q = src + i;
      v[j] = i < mlen ? (q < out_base ? __ldg(image + q) : row[q - out_base])
                      : 0;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t i = j * kLanes + lane;
      if (i < mlen) row[dst - out_base + i] = v[j];
    }
    __syncwarp();
  }
}

// Lane's record k of the block (a record past n reads as one that writes
// nothing).
__device__ __forceinline__ int2 word_at(const int32_t* r, int64_t k,
                                        int64_t n) {
  return k < n ? __ldg(reinterpret_cast<const int2*>(r) + k) : make_int2(0, 0);
}

struct Args {
  const uint8_t* lit;      // u8[nb, io_w]
  int64_t nb, io_w;
  const int32_t* recs;     // i32[nb, cap, 2]
  int64_t cap;
  const int32_t* counts;   // i32[nb]
  int64_t out_base, out_cap;
  uint8_t* out;            // u8[nb, out_cap]
  int32_t* stats;          // i32[nb, kStats]
};

// Block b's records over its output row (row: its bytes [out_base,
// out_base + out_cap) of the io row, seeded with the literal image), one
// warp: the conformance check, then the groups or the serial route.
template <bool kWithHist>
__device__ __forceinline__ void decode_block(const Args& a, int64_t b,
                                             uint8_t* row, int lane) {
  const uint8_t* image = a.lit + b * a.io_w;
  const int32_t* r = a.recs + b * a.cap * 2;
  const int64_t n = clip64(a.counts[b], 0, a.cap);
  const int64_t base = a.out_base;
  const int64_t limit = base + a.out_cap;

  // 1. Conformance. prev: the end of every earlier write range.
  int64_t prev = 0;
  bool bad = false;
  for (int64_t k0 = 0; k0 < n; k0 += kLanes) {
    const int2 w = word_at(r, k0 + lane, n);
    const int64_t offset = w.x & 0xFFFF;
    const int64_t mlen = (w.x >> 16) & 0xFFFF;
    const int64_t dst = static_cast<int64_t>(w.y) + base;
    const bool writes = mlen > 0;
    const int64_t incl = rg::warp_incl_max(writes ? dst + mlen : 0, lane);
    int64_t before = __shfl_up_sync(rg::kFull, incl, 1);
    before = lane == 0 || before < prev ? prev : before;
    const int64_t last = __shfl_sync(rg::kFull, incl, kLanes - 1);
    prev = last > prev ? last : prev;
    bad |= writes &&
           !(w.y >= 0 && w.y <= a.out_cap && dst >= 1 && offset >= 1 &&
             offset <= dst && mlen <= kSpan && mlen <= limit - dst &&
             mlen <= offset && dst >= before);
  }
  int levels = 0, most = 0;
  const bool serial = __any_sync(rg::kFull, bad);
  if (serial) {
    serial_walk(r, n, image, row, base, a.out_cap, lane);
  } else {
    // 2. The matches, group by group; each group's record words are
    // loaded while the group before runs.
    auto read = [&](int x) -> uint8_t {   // as compact_decode.cu's
      if (kWithHist && x < base) return __ldg(image + x);
      return row[x - base];
    };
    auto write = [&](int x, uint8_t v) { row[x - base] = v; };
    int2 next = word_at(r, lane, n);
    for (int64_t k0 = 0; k0 < n; k0 += kLanes) {
      const int2 w = next;
      next = word_at(r, k0 + kLanes + lane, n);
      const int md = static_cast<int>(w.y + base);
      const int lv = rg::run_levels(md - (w.x & 0xFFFF), md,
                                    (w.x >> 16) & 0xFFFF, lane, read, write);
      levels += lv;
      most = lv > most ? lv : most;
    }
  }
  if (lane == 0) {
    int32_t* st = a.stats + kStats * b;
    st[0] = static_cast<int32_t>(n);
    st[1] = serial ? 0 : static_cast<int32_t>((n + kLanes - 1) / kLanes);
    st[2] = levels;
    st[3] = most;
    st[4] = serial;
  }
}

// kShared: one block a CTA, its output row in shared memory (seeded and
// written back by the whole CTA, decoded by warp 0). Otherwise kWarps
// blocks a CTA, a warp each, decoding in the output rows in place.
template <bool kShared, bool kWithHist>
__global__ void __launch_bounds__(kLanes * kWarps)
split_decode_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t srow[];
  const int t = threadIdx.x;
  const int lane = t % kLanes;
  const int wi = t / kLanes;
  const int64_t b = kShared ? blockIdx.x
                            : static_cast<int64_t>(blockIdx.x) * kWarps + wi;
  if (b >= a.nb) return;  // the whole warp leaves together
  const uint8_t* seed = a.lit + b * a.io_w + a.out_base;
  uint8_t* orow = a.out + b * a.out_cap;
  if (kShared) {
    copy_row(srow, seed, a.out_cap, t, kLanes * kWarps);
    __syncthreads();
    if (wi == 0) decode_block<kWithHist>(a, b, srow, lane);
    __syncthreads();
    copy_row(orow, srow, a.out_cap, t, kLanes * kWarps);
  } else {
    copy_row(orow, seed, a.out_cap, lane, kLanes);
    __syncwarp();
    decode_block<kWithHist>(a, b, orow, lane);
  }
}

}  // namespace

// lit u8[nb, io_w] (literal images, io_w >= out_base + out_cap); recs
// i32[nb, cap, 2] (8-byte aligned); counts i32[nb] (records run per block,
// clipped to [0, cap]); out u8[nb, out_cap] (out_base + out_cap < 2**31);
// stats i32[nb, 5]: per block the records, groups of 32, levels (their
// sum and the largest group's) and the serial route's flag (a serially
// routed block counts no groups or levels). One warp per block on
// *stream*; does not synchronise; returns cudaGetLastError().
extern "C" int lz4t_split_decode(const void* lit, int64_t nb, int64_t io_w,
                                 const void* recs, int64_t cap,
                                 const void* counts, int64_t out_base,
                                 int64_t out_cap, void* out, void* stats,
                                 void* stream) {
  if (nb <= 0) return 0;
  const Args a{static_cast<const uint8_t*>(lit), nb, io_w,
               static_cast<const int32_t*>(recs), cap,
               static_cast<const int32_t*>(counts), out_base, out_cap,
               static_cast<uint8_t*>(out), static_cast<int32_t*>(stats)};
  const auto st = static_cast<cudaStream_t>(stream);
  const bool hist = out_base > 0;
  if (out_cap <= kSharedRow) {
    const auto kernel = hist ? split_decode_kernel<true, true>
                             : split_decode_kernel<true, false>;
    const int smem = static_cast<int>(out_cap);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(nb), kLanes * kWarps, smem, st>>>(a);
  } else {
    const auto kernel = hist ? split_decode_kernel<false, true>
                             : split_decode_kernel<false, false>;
    const int64_t grid = (nb + kWarps - 1) / kWarps;
    kernel<<<static_cast<unsigned>(grid), kLanes * kWarps, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
