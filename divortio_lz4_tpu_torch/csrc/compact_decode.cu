// Compact-record LZ4 block decode for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel _make_wire_kernel_compact
// (divortio_lz4_tpu/ops/pallas_split_decode.py:689, launched by
// decode_blocks_wire_compact at :868). The host parser has already cut
// every LZ4 sequence into records of at most 128 output bytes. Record
// (w0, w1) = (src | ll<<16 | ml<<24, dst | off<<16) writes, at output
// position dst, ll literal bytes read from the block's compressed bytes at
// src, then ml match bytes read from the output at dst + ll - off. Every
// record reads all its bytes before it writes any, with the TPU kernel's
// clamps (:731-736, and dst = min(dst, out_cap) + out_base at :761), so
// garbage records stay inside their own row. Output bytes past a block's
// out_len are zeros. Positions below are those of the io row
// [64 KB history (dictionary only) | block_size].
//
// Design: one CTA of kThreads = 256 threads a block (128 were slower:
// PERF.md, section 6), two kernels.
//   1. compact_groups_kernel keeps the block's output row in shared memory
//      (block_size bytes, 3 CTAs an SM at 64 KB; a history is read from
//      device memory), zeroed, then, kThreads records a pass over the CTA:
//      - the conformance check, on the raw words of every record that
//        writes (ll + ml > 0): no clamp binds (dst <= block_size,
//        ll + ml <= 128, dst + ll + ml <= block_size,
//        src <= wire_cap - 256, off >= 1); dst is the running sum of the
//        block's earlier ll + ml (a CTA scan); a match (ml > 0) reads only
//        bytes before its record (off >= ll + ml) and none below the io
//        row (out_base + dst + ll - off >= 0). The host parser
//        (lz4t_parse_records2) emits only such records;
//      - the literals of every conforming record, copied from the wire
//        row as one flattened run a warp, in no order (they read nothing
//        that any record writes).
//      A block with a record that fails the check stops there. Otherwise
//      warp 0 runs the matches in groups of 32 records by dependency
//      levels (record_groups.cuh), each group's record words loaded while
//      the group before runs: a conforming block's writes are disjoint
//      and increasing and every source lies before its record, so the
//      bytes are those of the serial walk. The CTA writes the row out,
//      zeros past out_len.
//   2. compact_serial_kernel: the first port's walk (one thread a byte of
//      a record, the row in shared memory, a barrier pair a record), on
//      the blocks step 1 refused only; the others return at once.
// The row in device memory instead (every block resident, each dependent
// read an L1 trip) took twice as long on the 64 MiB corpus frame
// (PERF.md, section 6). The kernel is templated on the history so that,
// without one, every read of the row is a shared-memory load: a read that
// chose between the history and the row at run time, likely compiled to
// generic loads, took 2.7 times as long. With a history, loading both and
// keeping one was slower than that choice.
//
// What bounds it on this card: not bytes. A 64 KB block moves 64 KB out,
// its compressed bytes in and 8 B a record. The floor is warp 0's chain of
// group levels (1740 in the corpus frame's densest block, 280 groups).

#include <cuda_runtime.h>
#include <stdint.h>

#include "record_groups.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / rg::kLanes;
constexpr int kSpan = 128;      // output bytes one record covers at most
constexpr int kHist = 65536;    // dictionary window ahead of the payload
constexpr int kRecChunk = 512;  // records the serial walk stages at once
constexpr int kStats = 5;       // records, groups, levels, max, serial

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Blocks {
  const uint8_t* wire;
  int64_t wire_cap;
  const uint2* recs;
  int64_t n_rec;
  const int64_t* rec_off;
  const int64_t* out_lens;
  const uint8_t* hist;     // u8[nb, kHist] or null
  int out_base;            // kHist with a history, else 0
  int block_size;
  uint8_t* out;            // u8[nb, block_size]
  int32_t* stats;          // i32[nb, kStats]
};

// A record's raw fields; dst relative to the block.
struct Rec {
  int src, ll, ml, dst, off;
};

__device__ __forceinline__ Rec unpack(uint2 r) {
  return {static_cast<int>(r.x & 0xFFFF), static_cast<int>((r.x >> 16) & 0xFF),
          static_cast<int>(r.x >> 24), static_cast<int>(r.y & 0xFFFF),
          static_cast<int>(r.y >> 16)};
}

// The conformance check of one record; excl is the block's earlier
// ll + ml. Records that write nothing pass.
__device__ __forceinline__ bool conforms(const Rec& r, int64_t excl,
                                         int block_size, int out_base,
                                         int src_max) {
  const int tot = r.ll + r.ml;
  if (tot == 0) return true;
  return r.dst <= block_size && tot <= kSpan && r.dst + tot <= block_size &&
         r.src <= src_max && r.off >= 1 && r.dst == excl &&
         (r.ml == 0 || (r.off >= tot && out_base + r.dst + r.ll - r.off >= 0));
}

template <bool kWithHist>
__global__ void __launch_bounds__(kThreads)
compact_groups_kernel(Blocks bk) {
  extern __shared__ __align__(16) uint8_t row[];   // the block's output
  __shared__ int wsum[kWarps];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int w = t / rg::kLanes;
  const int lane = t % rg::kLanes;
  const int base = bk.out_base;
  const int bs = bk.block_size;
  const uint8_t* wrow = bk.wire + b * bk.wire_cap;
  const uint8_t* hrow = bk.hist != nullptr ? bk.hist + b * kHist : nullptr;
  // The TPU kernel reads two 128-lane rows from src: (wire_nr - 2) * 128.
  const int src_max = static_cast<int>(bk.wire_cap) - 2 * kSpan;

  // io positions: the history (read only) below base, the row above it.
  // Without a history every read is a shared-memory load.
  auto read = [&](int x) -> uint8_t {
    if (kWithHist && x < base) return __ldg(hrow + x);
    return row[x - base];
  };
  auto write = [&](int x, uint8_t v) { row[x - base] = v; };
  auto wire_at = [&](int x) -> uint8_t { return __ldg(wrow + x); };

  for (int i = t * 16; i < bs; i += kThreads * 16)
    *reinterpret_cast<uint4*>(row + i) = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // 1. Conformance and literals, kThreads records a pass.
  const int64_t r0 = clamp64(bk.rec_off[b], 0, bk.n_rec);
  const int64_t r1 = clamp64(bk.rec_off[b + 1], r0, bk.n_rec);
  int64_t carry = 0;
  bool bad = false;
  for (int64_t c = r0; c < r1; c += kThreads) {
    const int64_t k = c + t;
    const Rec r = k < r1 ? unpack(bk.recs[k]) : Rec{0, 0, 0, 0, 1};
    const int tot = r.ll + r.ml;
    const int incl = rg::warp_incl_sum(tot, lane);
    if (lane == rg::kLanes - 1) wsum[w] = incl;
    __syncthreads();
    int64_t excl = carry + incl - tot;
    for (int i = 0; i < kWarps; ++i) {
      if (i < w) excl += wsum[i];
      carry += wsum[i];
    }
    __syncthreads();
    const bool ok = conforms(r, excl, bs, base, src_max);
    bad |= !ok;
    rg::copy_flat(ok ? r.ll : 0, r.src, base + r.dst, lane, wire_at, write);
  }
  if (__syncthreads_or(bad)) {
    if (t == 0) {
      int32_t* st = bk.stats + kStats * b;
      st[0] = static_cast<int32_t>(clamp64(r1 - r0, 0, 0x7FFFFFFF));
      st[1] = st[2] = st[3] = 0;
      st[4] = 1;
    }
    return;
  }

  if (w == 0) {   // 2. The matches, group by group
    // each group's record words are loaded while the group before runs
    const uint2 none = make_uint2(0, 1u << 16);   // writes nothing
    uint2 next = r0 + lane < r1 ? bk.recs[r0 + lane] : none;
    int levels = 0, most = 0;
    for (int64_t c = r0; c < r1; c += rg::kLanes) {
      const Rec r = unpack(next);
      const int64_t k = c + rg::kLanes + lane;
      next = k < r1 ? bk.recs[k] : none;
      const int md = base + r.dst + r.ll;
      const int lv = rg::run_levels(md - r.off, md, r.ml, lane, read, write);
      levels += lv;
      most = max(most, lv);
    }
    if (lane == 0) {
      const int64_t n = clamp64(r1 - r0, 0, 0x7FFFFFFF);
      int32_t* st = bk.stats + kStats * b;
      st[0] = static_cast<int32_t>(n);
      st[1] = static_cast<int32_t>((n + rg::kLanes - 1) / rg::kLanes);
      st[2] = levels;
      st[3] = most;
      st[4] = 0;
    }
  }
  __syncthreads();
  const int olen = static_cast<int>(clamp64(bk.out_lens[b], 0, bs));
  uint8_t* orow = bk.out + b * bs;
  for (int i = t * 16; i < bs; i += kThreads * 16) {
    uint4 v = *reinterpret_cast<const uint4*>(row + i);
    if (i + 16 > olen) {
      uint8_t* p = reinterpret_cast<uint8_t*>(&v);
      for (int q = 0; q < 16; ++q)
        if (i + q >= olen) p[q] = 0;
    }
    *reinterpret_cast<uint4*>(orow + i) = v;
  }
}

// The serial route: the first port's kernel, on the blocks that failed the
// conformance check. One thread a byte of a record (threads past the
// 128th idle); the block's io row in shared memory; records staged
// kRecChunk at a time. Per record every thread reads its byte, the CTA
// meets, every thread writes it and the CTA meets again: the TPU kernel's
// read-all-then-write order (:740-751).
__global__ void __launch_bounds__(kThreads)
compact_serial_kernel(Blocks bk) {
  const int64_t b = blockIdx.x;
  if (bk.stats[kStats * b + 4] == 0) return;
  extern __shared__ __align__(16) uint8_t smem[];
  uint2* srec = reinterpret_cast<uint2*>(smem);
  uint8_t* io = smem + kRecChunk * sizeof(uint2);

  const int t = threadIdx.x;
  const int out_base = bk.out_base;
  const int block_size = bk.block_size;
  const int bs_limit = out_base + block_size;
  const uint8_t* wrow = bk.wire + b * bk.wire_cap;
  const int src_max = static_cast<int>(bk.wire_cap) - 2 * kSpan;

  for (int i = t * 16; i < bs_limit; i += kThreads * 16) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (bk.hist != nullptr && i < out_base)
      v = *reinterpret_cast<const uint4*>(bk.hist + b * kHist + i);
    *reinterpret_cast<uint4*>(io + i) = v;
  }

  const int64_t r0 = clamp64(bk.rec_off[b], 0, bk.n_rec);
  const int64_t r1 = clamp64(bk.rec_off[b + 1], r0, bk.n_rec);
  for (int64_t c = r0; c < r1; c += kRecChunk) {
    const int n = static_cast<int>(clamp64(r1 - c, 0, kRecChunk));
    __syncthreads();  // the seed, or the previous chunk, is done
    for (int i = t; i < n; i += kThreads) srec[i] = bk.recs[c + i];
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const uint2 r = srec[k];
      int ll = (r.x >> 16) & 0xFF;
      const int ml = r.x >> 24;
      const int dst =
          min(static_cast<int>(r.y & 0xFFFF), block_size) + out_base;
      const int off = max(static_cast<int>(r.y >> 16), 1);
      const int tot = min(ll + ml, min(kSpan, bs_limit - dst));
      ll = min(ll, tot);
      const int msrc = max(dst + ll - off, 0);
      const int src = min(static_cast<int>(r.x & 0xFFFF), src_max);
      uint8_t v = 0;
      if (t < tot) v = t < ll ? wrow[src + t] : io[msrc + t - ll];
      __syncthreads();
      if (t < tot) io[dst + t] = v;
      __syncthreads();
    }
  }
  __syncthreads();

  const int olen = static_cast<int>(clamp64(bk.out_lens[b], 0, block_size));
  uint8_t* orow = bk.out + b * block_size;
  for (int i = t * 16; i < block_size; i += kThreads * 16) {
    uint4 v = *reinterpret_cast<const uint4*>(io + out_base + i);
    if (i + 16 > olen) {
      uint8_t* p = reinterpret_cast<uint8_t*>(&v);
      for (int q = 0; q < 16; ++q)
        if (i + q >= olen) p[q] = 0;
    }
    *reinterpret_cast<uint4*>(orow + i) = v;
  }
}

}  // namespace

// wire u8[nb, wire_cap] (wire_cap % 128 == 0, >= 256); recs u32[n_rec, 2]
// (8-byte aligned); rec_off i64[nb + 1]; out_lens i64[nb]; hist u8[nb,
// 65536] or null; out u8[nb, block_size] (block_size % 16 == 0, <= 65536;
// 16-byte aligned like hist); stats i32[nb, 5]: per block the records,
// groups of 32, levels (their sum and the largest group's) and the serial
// route's flag (a serially routed block counts no groups or levels).
// Launches both kernels on *stream*, does not synchronise, and returns
// the first cudaError.
extern "C" int lz4t_compact_decode(const void* wire, int64_t nb,
                                   int64_t wire_cap, const void* recs,
                                   int64_t n_rec, const void* rec_off,
                                   const void* out_lens, const void* hist,
                                   int64_t block_size, void* out, void* stats,
                                   void* stream) {
  if (nb <= 0) return 0;
  Blocks bk;
  bk.wire = static_cast<const uint8_t*>(wire);
  bk.wire_cap = wire_cap;
  bk.recs = static_cast<const uint2*>(recs);
  bk.n_rec = n_rec;
  bk.rec_off = static_cast<const int64_t*>(rec_off);
  bk.out_lens = static_cast<const int64_t*>(out_lens);
  bk.hist = static_cast<const uint8_t*>(hist);
  bk.out_base = hist != nullptr ? kHist : 0;
  bk.block_size = static_cast<int>(block_size);
  bk.out = static_cast<uint8_t*>(out);
  bk.stats = static_cast<int32_t*>(stats);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(nb);

  const int serial_smem = kRecChunk * static_cast<int>(sizeof(uint2)) +
                          bk.out_base + bk.block_size;
  const auto groups = hist != nullptr ? compact_groups_kernel<true>
                                      : compact_groups_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      groups, cudaFuncAttributeMaxDynamicSharedMemorySize, bk.block_size);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(compact_serial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               serial_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  groups<<<grid, kThreads, bk.block_size, st>>>(bk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_serial_kernel<<<grid, kThreads, serial_smem, st>>>(bk);
  return static_cast<int>(cudaGetLastError());
}
