// The two LZ4 block encoders for Hopper (sm_90a), plain C entry points that
// share one emitter (emit, put_ext, ext_count, zero_fill):
//   lz4t_greedy_encode  the reference-identical greedy hash-table scan;
//   lz4t_hybrid_encode  the hybrid engine's walk over packed chains (see
//                       hybrid_walk_kernel below).
//
// lz4t_greedy_encode replaces the TPU kernel _make_kernel of
// divortio_lz4_tpu/ops/pallas_encode.py:66 (launched by encode_blocks_pallas
// at :272, the pl.pallas_call at :340). It runs the reference encoder's greedy
// hash-table scan exactly, so a block's bytes equal the host C++ encoder's:
//   - hash = (u32(word) * 2654435761) >> 18 & 0x3FFF over the 4-byte
//     little-endian word at s; the 16K-entry table stores pos + 1 (0 =
//     empty) and is cleared for every block;
//   - a hit needs cand >= 0, s != cand, s - cand < 65536 and equal words;
//   - the match extends forward only, up to src_len - LAST_LITERALS, and
//     the scan runs while s < src_len - MF_LIMIT;
//   - a miss advances s by search >> 6 and bumps search; a hit resets it to
//     (1 << 6) + 3; positions inside a match are not inserted;
//   - the block ends with its trailing literal run; an empty row encodes to
//     nothing (out_len 0).
// The output row is exact: bytes past out_len are zeros (the TPU kernel
// leaves its wild 128-byte writes there).
//
// Design: one CTA of one warp per block. The table (64 KB of int32) lives in
// dynamic shared memory. The probe loop is serial by construction: every
// lane runs it in lockstep on the same values (broadcast loads), lane 0
// writes the table, and __syncwarp() orders the write before the next
// probe's read. The warp extends a match 32 bytes a step (__ballot_sync
// finds the first mismatch) and writes literals and 0xFF runs together.
// The TPU's precomputed i32 word array, lane rolls and SMEM word copy exist
// for Mosaic; words are read from the u8 row here.
//
// What bounds it on this card: the dependent latency of each probe (a
// global read of the word, a shared-memory table read and write, a warp
// barrier), not bytes: a block is one serial walk. Blocks run in parallel,
// three CTAs per SM (64 KB of table each). A u16 table for blocks of at
// most 64 KB, and staging the row in shared memory, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kTableLog = 14;
constexpr int kTable = 1 << kTableLog;        // 16384 entries
constexpr uint32_t kHashMult = 2654435761u;
constexpr int kHashShift = 18;
constexpr int64_t kMinMatch = 4;
constexpr int64_t kLastLiterals = 5;
constexpr int64_t kMfLimit = 12;
constexpr int kSkipTrigger = 6;
constexpr int64_t kWindow = 65536;
constexpr int kTableBytes = kTable * 4;

__device__ __forceinline__ uint32_t word_at(const uint8_t* p) {
  return static_cast<uint32_t>(__ldg(p)) |
         (static_cast<uint32_t>(__ldg(p + 1)) << 8) |
         (static_cast<uint32_t>(__ldg(p + 2)) << 16) |
         (static_cast<uint32_t>(__ldg(p + 3)) << 24);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Bytes of the 0xFF-run length extension for a length nibble value.
__device__ __forceinline__ int64_t ext_count(int64_t v) {
  return v >= 15 ? 1 + (v - 15) / 255 : 0;
}

// Writes the extension of v at dst (every lane calls it); returns its size.
__device__ __forceinline__ int64_t put_ext(uint8_t* dst, int64_t v,
                                           int lane) {
  const int64_t n = ext_count(v);
  const uint8_t last = static_cast<uint8_t>((v - 15) % 255);
  for (int64_t i = lane; i < n; i += kLanes)
    dst[i] = i < n - 1 ? 255 : last;
  return n;
}

__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                           int64_t n, int lane) {
  for (int64_t i = lane; i < n; i += kLanes) dst[i] = __ldg(src + i);
}

__device__ void zero_fill(uint8_t* p, int64_t n, int lane) {
  const int64_t misalign =
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) & 15);
  const int64_t head = min64(n, (16 - misalign) & 15);
  const int64_t body_end = head + ((n - head) & ~int64_t{15});
  for (int64_t i = lane; i < head; i += kLanes) p[i] = 0;
  for (int64_t i = head + 16 * lane; i < body_end; i += 16 * kLanes)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
  for (int64_t i = body_end + lane; i < n; i += kLanes) p[i] = 0;
}

// One sequence: token, literal-length extension, literals, offset and
// match-length extension (has_match), or the trailing literal run. Returns
// the output cursor after it.
__device__ __forceinline__ int64_t emit(uint8_t* out, int64_t d,
                                        const uint8_t* lits, int64_t lit,
                                        bool has_match, int64_t offset,
                                        int64_t mcode, int lane) {
  if (lane == 0)
    out[d] = static_cast<uint8_t>(
        (min64(lit, 15) << 4) | (has_match ? min64(mcode, 15) : 0));
  d += 1;
  d += put_ext(out + d, lit, lane);
  copy_bytes(out + d, lits, lit, lane);
  d += lit;
  if (has_match) {
    if (lane == 0) {
      out[d] = static_cast<uint8_t>(offset & 0xFF);
      out[d + 1] = static_cast<uint8_t>((offset >> 8) & 0xFF);
    }
    d += 2;
    d += put_ext(out + d, mcode, lane);
  }
  return d;
}

__global__ void __launch_bounds__(kLanes)
greedy_encode_kernel(const uint8_t* __restrict__ work, int64_t row_w,
                     const int64_t* __restrict__ lens, int64_t out_w,
                     uint8_t* __restrict__ out,
                     int64_t* __restrict__ out_lens) {
  extern __shared__ int4 table4[];
  int32_t* table = reinterpret_cast<int32_t*>(table4);
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* src = work + b * row_w;
  uint8_t* dst = out + b * out_w;
  int64_t src_len = lens[b];
  src_len = src_len < 0 ? 0 : min64(src_len, row_w);

  for (int i = lane; i < kTable / 4; i += kLanes)
    table4[i] = make_int4(0, 0, 0, 0);
  __syncwarp();

  const int64_t mf_limit = src_len - kMfLimit;
  const int64_t match_limit = src_len - kLastLiterals;
  int64_t s = 0, anchor = 0, d = 0;
  int64_t search = (1 << kSkipTrigger) + 3;
  while (s < mf_limit) {
    const uint32_t seq = word_at(src + s);
    const uint32_t h = (seq * kHashMult) >> kHashShift & (kTable - 1);
    const int64_t cand = static_cast<int64_t>(table[h]) - 1;
    __syncwarp();
    if (lane == 0) table[h] = static_cast<int32_t>(s + 1);
    __syncwarp();
    const bool good = cand >= 0 && s != cand && s - cand < kWindow &&
                      word_at(src + cand) == seq;
    if (!good) {
      s += search >> kSkipTrigger;
      search += 1;
      continue;
    }
    // Forward extension from +4, 32 bytes a step, capped at match_limit.
    int64_t k = 0;
    for (;;) {
      const int64_t pos = s + kMinMatch + k + lane;
      const bool neq = pos >= match_limit ||
                       __ldg(src + pos) != __ldg(src + cand + kMinMatch +
                                                  k + lane);
      const unsigned m = __ballot_sync(0xffffffffu, neq);
      if (m) {
        k += __ffs(m) - 1;
        break;
      }
      k += kLanes;
    }
    const int64_t mlen = kMinMatch + k;
    d = emit(dst, d, src + anchor, s - anchor, true, s - cand,
             mlen - kMinMatch, lane);
    s += mlen;
    anchor = s;
    search = (1 << kSkipTrigger) + 3;
  }
  if (src_len > 0)
    d = emit(dst, d, src + anchor, src_len - anchor, false, 0, 0, lane);
  __syncwarp();
  zero_fill(dst + d, out_w - d, lane);
  if (lane == 0) out_lens[b] = d;
}

// The hybrid engine's sequence walk. Replaces the TPU kernel _make_kernel
// of divortio_lz4_tpu/ops/hybrid_encode.py:366 (launched by
// encode_blocks_hybrid at :536, the pl.pallas_call at :604). Per row, over
// the packed chain (m << 16 | dist) of build_chains:
//   - mf_limit = src_len - 12, match_limit = src_len - 5;
//   - start at (m, dist) = chain[0]; while m < mf_limit, extend from m + 4
//     (exact-word chains guarantee the first 4 bytes) to the first mismatch
//     or match_limit, emit the sequence, then jump to chain[m + mlen];
//   - end with the trailing literal run; an empty row encodes to nothing;
//   - meta: the trailing token's position, the trailing literal count, and
//     the last match sequence's stream offset and payload anchor (-1 where
//     there is none), the TPU kernel's meta lanes 1-4.
// Bytes are read from the u8 [history | payload] row: the LE32 word array,
// lane rolls and SMEM chain layout are Mosaic's and are not ported. The
// output row is exact: zeros past out_len, where the TPU leaves wild
// 128-byte writes.
//
// Design: one warp per row, kWalkWarps rows per CTA, no shared memory.
// Every lane carries the same walk state (broadcast loads of the chain
// entry), so control flow is uniform; the warp extends a match 32 bytes a
// step with __ballot_sync and copies literals together through emit.
//
// What bounds it on this card: the dependent latency of each sequence (a
// chain load, then extension loads that depend on it), not bytes; rows run
// in parallel, many warps per SM.
constexpr int kWalkWarps = 4;

__global__ void __launch_bounds__(kLanes * kWalkWarps)
hybrid_walk_kernel(const uint8_t* __restrict__ work, int64_t nb,
                   int64_t row_w, int64_t hist_len,
                   const int64_t* __restrict__ lens,
                   const uint32_t* __restrict__ chains, int64_t out_w,
                   uint8_t* __restrict__ out, int64_t* __restrict__ out_lens,
                   int64_t* __restrict__ meta) {
  const int lane = threadIdx.x % kLanes;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWalkWarps +
                    threadIdx.x / kLanes;
  if (b >= nb) return;  // the whole warp leaves together
  const int64_t cap = row_w - hist_len;
  const uint8_t* src = work + b * row_w + hist_len;  // history lies below
  const uint32_t* chain = chains + b * cap;
  uint8_t* dst = out + b * out_w;
  int64_t src_len = lens[b];
  src_len = src_len < 0 ? 0 : min64(src_len, cap);

  const int64_t mf_limit = src_len - kMfLimit;
  const int64_t match_limit = src_len - kLastLiterals;
  uint32_t e = __ldg(chain);
  int64_t m = e >> 16, dist = e & 0xFFFF;
  int64_t anchor = 0, d = 0, last_d = -1, last_anchor = -1;
  while (m < mf_limit) {
    int64_t k = 0;
    for (;;) {
      const int64_t pos = m + kMinMatch + k + lane;
      const bool neq = pos >= match_limit ||
                       __ldg(src + pos) != __ldg(src + pos - dist);
      const unsigned mask = __ballot_sync(0xffffffffu, neq);
      if (mask) {
        k += __ffs(mask) - 1;
        break;
      }
      k += kLanes;
    }
    last_d = d;
    last_anchor = anchor;
    d = emit(dst, d, src + anchor, m - anchor, true, dist, k, lane);
    anchor = m + kMinMatch + k;
    e = __ldg(chain + anchor);
    m = e >> 16;
    dist = e & 0xFFFF;
  }
  const int64_t token_pos = d;
  const int64_t lit = src_len - anchor;
  if (src_len > 0)
    d = emit(dst, d, src + anchor, lit, false, 0, 0, lane);
  __syncwarp();
  zero_fill(dst + d, out_w - d, lane);
  if (lane == 0) {
    out_lens[b] = d;
    int64_t* mt = meta + 4 * b;
    mt[0] = token_pos;
    mt[1] = lit;
    mt[2] = last_d;
    mt[3] = last_anchor;
  }
}

}  // namespace

// work u8[nb, row_w] (row b's payload is its first lens[b] bytes); lens
// i64[nb]; out u8[nb, out_w] with out_w >= block_bound(row_w); out_lens
// i64[nb]. One CTA per block on *stream*; does not synchronise; returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
extern "C" int lz4t_greedy_encode(const void* work, int64_t nb,
                                  int64_t row_w, const void* lens,
                                  int64_t out_w, void* out, void* out_lens,
                                  void* stream) {
  if (nb <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      greedy_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTableBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_encode_kernel<<<static_cast<unsigned>(nb), kLanes, kTableBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(work), row_w,
      static_cast<const int64_t*>(lens), out_w, static_cast<uint8_t*>(out),
      static_cast<int64_t*>(out_lens));
  return static_cast<int>(cudaGetLastError());
}

// work u8[nb, row_w] ([history | payload] rows, hist_len bytes of history);
// lens i64[nb]; chains i32[nb, row_w - hist_len] (build_chains, read as
// u32); out u8[nb, out_w] with out_w >= block_bound(row_w - hist_len);
// out_lens i64[nb]; meta i64[nb, 4]. One warp per row on *stream*; does
// not synchronise; returns cudaGetLastError().
extern "C" int lz4t_hybrid_encode(const void* work, int64_t nb,
                                  int64_t row_w, int64_t hist_len,
                                  const void* lens, const void* chains,
                                  int64_t out_w, void* out, void* out_lens,
                                  void* meta, void* stream) {
  if (nb <= 0) return 0;
  const int64_t grid = (nb + kWalkWarps - 1) / kWalkWarps;
  hybrid_walk_kernel<<<static_cast<unsigned>(grid), kLanes * kWalkWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(work), nb, row_w, hist_len,
      static_cast<const int64_t*>(lens),
      static_cast<const uint32_t*>(chains), out_w,
      static_cast<uint8_t*>(out), static_cast<int64_t*>(out_lens),
      static_cast<int64_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}
