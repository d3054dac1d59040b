// The two LZ4 block encoders for Hopper (sm_90a), plain C entry points that
// share one emitter (emit, put_ext, copy_bytes, zero_fill):
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
// What bounds it on this card: the dependent latency of one block's scan,
// not bytes. A block is one serial chain of probes, and the kernel lasts as
// long as its slowest block (on the 64 MiB corpus, 8947 sequences in one
// 64 KB block), so the chain's length per probe is what counts:
//   - One probe a step while the scan hits: lane 0 alone reads and writes
//     the table (no warp barrier), and the candidate's word check is the
//     first step of the extension (32 bytes at s and at cand, one ballot;
//     a hit is a first mismatch at 4 or later), so a hit costs one load
//     round after the table.
//   - The emitter is off the probe chain: each lane holds one sequence, and
//     every 32 hits the warp writes the group at once (flush_group: each
//     lane its token, extensions, offset and short literals at its offset
//     from a warp scan of the sizes; longer literal runs by the whole warp).
//   - 32 probes a step after a miss. From (s, search) the positions a run
//     of misses visits are fixed: p_i = s + sum_{k<i} ((search + k) >> 6),
//     a closed form. Lane i probes p_i if p_i < mf_limit; its candidate is
//     the highest lower lane's position with the same hash
//     (__match_any_sync), else the table's entry; the first good lane f is
//     the serial scan's next hit. Lanes 0..f wrote the table before their
//     test, so per hash the highest of them writes; later lanes are dropped.
//     A miss run costs one step per 32 probes.
//   - A u16 table for rows of at most 64 KB (pos + 1 <= 65524, since the
//     scan stops at src_len - 12): 32 KB of shared memory a CTA, 6 one-warp
//     CTAs an SM instead of 3. Wider rows (256 KB, 4 MB) keep the int32
//     table (a template on the entry type), same algorithm.
//   - Positions are 32-bit inside a row; the row's bytes are read through
//     L1 (__ldg). Staging the 64 KB row in shared memory (96 KB a CTA, 2
//     CTAs an SM) measured slower and is not kept (PERF.md).
//   - The shared emitter (the trailing literals here, every sequence of the
//     hybrid walk) stores literals and 0xFF runs 4 bytes a lane (aligned
//     words built from the unaligned source with a funnel shift).
//
// lz4t_hybrid_encode: see the note above hybrid_walk_kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTableLog = 14;
constexpr int kTable = 1 << kTableLog;        // 16384 entries
constexpr uint32_t kHashMult = 2654435761u;
constexpr int kHashShift = 18;
constexpr int32_t kMinMatch = 4;
constexpr int32_t kLastLiterals = 5;
constexpr int32_t kMfLimit = 12;
constexpr int kSkipTrigger = 6;
constexpr int32_t kFresh = (1 << kSkipTrigger) + 3;
constexpr int32_t kWindow = 65536;
constexpr int64_t kU16Rows = 65536;           // widest row of the u16 table

__device__ __forceinline__ uint8_t ld8(const uint8_t* p) { return __ldg(p); }

// p must be 4-byte aligned.
__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ uint32_t word_at(const uint8_t* p) {
  return static_cast<uint32_t>(ld8(p)) |
         (static_cast<uint32_t>(ld8(p + 1)) << 8) |
         (static_cast<uint32_t>(ld8(p + 2)) << 16) |
         (static_cast<uint32_t>(ld8(p + 3)) << 24);
}

__device__ __forceinline__ uint32_t hash_of(uint32_t word) {
  return (word * kHashMult) >> kHashShift & (kTable - 1);
}

__device__ __forceinline__ int32_t min32(int32_t a, int32_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int32_t head_to_word(const uint8_t* p, int32_t n) {
  return min32(n, (4 - static_cast<int32_t>(
                           reinterpret_cast<uintptr_t>(p) & 3)) & 3);
}

// Bytes of the 0xFF-run length extension for a length nibble value.
__device__ __forceinline__ int32_t ext_count(int32_t v) {
  return v >= 15 ? 1 + (v - 15) / 255 : 0;
}

// Writes the extension of v at dst (every lane calls it): n - 1 bytes of
// 0xFF, aligned words of them 4 bytes a lane, then (v - 15) % 255. Returns n.
__device__ __forceinline__ int32_t put_ext(uint8_t* dst, int32_t v,
                                           int lane) {
  const int32_t n = ext_count(v);
  if (n == 0) return 0;
  const int32_t ff = n - 1;
  const int32_t head = head_to_word(dst, ff);
  const int32_t words = (ff - head) >> 2;
  if (lane < head) dst[lane] = 255;
  uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + head);
  for (int32_t i = lane; i < words; i += kLanes) d32[i] = kFull;
  for (int32_t i = head + 4 * words + lane; i < ff; i += kLanes) dst[i] = 255;
  if (lane == 0) dst[ff] = static_cast<uint8_t>((v - 15) % 255);
  return n;
}

// dst[0, n) = src[0, n): single bytes up to dst's first aligned word, then
// one aligned 4-byte store a lane per step (each word funnel-shifted out of
// the two aligned source words that hold it), then the last bytes. An
// aligned word that holds a valid byte lies inside the source allocation.
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                           int32_t n, int lane) {
  const int32_t head = head_to_word(dst, n);
  const int32_t words = (n - head) >> 2;
  if (lane < head) dst[lane] = ld8(src + lane);
  const uint8_t* s0 = src + head;
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(s0) & 3);
  const uint8_t* base = s0 - sh;
  uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + head);
  for (int32_t i = lane; i < words; i += kLanes) {
    const uint32_t lo = ld32(base + 4 * i);
    d32[i] = sh ? __funnelshift_r(lo, ld32(base + 4 * i + 4), 8 * sh) : lo;
  }
  for (int32_t i = head + 4 * words + lane; i < n; i += kLanes)
    dst[i] = ld8(src + i);
}

// p[0, n) = 0 by threads t of nt: bytes to 16-byte alignment, then uint4s.
__device__ void zero_fill(uint8_t* p, int32_t n, int t, int nt) {
  const int32_t misalign =
      static_cast<int32_t>(reinterpret_cast<uintptr_t>(p) & 15);
  const int32_t head = min32(n, (16 - misalign) & 15);
  const int32_t body_end = head + ((n - head) & ~15);
  for (int32_t i = t; i < head; i += nt) p[i] = 0;
  for (int32_t i = head + 16 * t; i < body_end; i += 16 * nt)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
  for (int32_t i = body_end + t; i < n; i += nt) p[i] = 0;
}

// One sequence: token, literal-length extension, literals, offset and
// match-length extension (has_match), or the trailing literal run. Returns
// the output cursor after it.
__device__ __forceinline__ int32_t emit(uint8_t* out, int32_t d,
                                        const uint8_t* lits, int32_t lit,
                                        bool has_match, int32_t offset,
                                        int32_t mcode, int lane) {
  if (lane == 0)
    out[d] = static_cast<uint8_t>(
        (min32(lit, 15) << 4) | (has_match ? min32(mcode, 15) : 0));
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

// The first k >= k0 with a + k >= match_limit or src[a + k] != src[b + k]
// (b < a), 32 bytes a warp step; __ballot_sync finds the first mismatch.
// Every lane gets the same k.
__device__ __forceinline__ int32_t extend_from(const uint8_t* src, int32_t a,
                                               int32_t b, int32_t k,
                                               int32_t match_limit,
                                               int lane) {
  for (;;) {
    const int32_t pos = a + k + lane;
    const bool neq = pos >= match_limit ||
                     ld8(src + pos) != ld8(src + b + k + lane);
    const unsigned m = __ballot_sync(kFull, neq);
    if (m) return k + __ffs(m) - 1;
    k += kLanes;
  }
}

constexpr int32_t kShortLit = 16;

// Writes a group of n <= 32 sequences, lane j's being (at, lit, off, code),
// from d: each lane writes its own token, extensions, offset and (when at
// most kShortLit) literals at its offset from a warp scan of the sizes;
// longer literal runs are then copied by the whole warp. Returns d after.
__device__ int32_t flush_group(uint8_t* dst, int32_t d, const uint8_t* src,
                               int32_t at, int32_t lit, int32_t off,
                               int32_t code, int n, int lane) {
  const bool mine = lane < n;
  const int32_t el = mine ? ext_count(lit) : 0;
  const int32_t em = mine ? ext_count(code) : 0;
  const int32_t size = mine ? 3 + el + lit + em : 0;
  int32_t incl = size;
  for (int o = 1; o < kLanes; o <<= 1) {
    const int32_t v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int32_t total = __shfl_sync(kFull, incl, kLanes - 1);
  const int32_t lit_at = incl - size + 1 + el;   // literals, from d
  if (mine) {
    uint8_t* o = dst + d + incl - size;
    o[0] = static_cast<uint8_t>((min32(lit, 15) << 4) | min32(code, 15));
    for (int32_t i = 1; i < el; ++i) o[i] = 255;
    if (el) o[el] = static_cast<uint8_t>((lit - 15) % 255);
    if (lit <= kShortLit)
      for (int32_t i = 0; i < lit; ++i) o[1 + el + i] = ld8(src + at + i);
    uint8_t* q = o + 1 + el + lit;
    q[0] = static_cast<uint8_t>(off & 0xFF);
    q[1] = static_cast<uint8_t>((off >> 8) & 0xFF);
    for (int32_t i = 1; i < em; ++i) q[1 + i] = 255;
    if (em) q[1 + em] = static_cast<uint8_t>((code - 15) % 255);
  }
  unsigned longs = __ballot_sync(kFull, mine && lit > kShortLit);
  while (longs) {
    const int j = __ffs(longs) - 1;
    longs &= longs - 1;
    copy_bytes(dst + d + __shfl_sync(kFull, lit_at, j),
               src + __shfl_sync(kFull, at, j), __shfl_sync(kFull, lit, j),
               lane);
  }
  return d + total;
}

// sum_{j<n} (j >> 6): the miss steps of a run, p_i = s + tri(search + i) -
// tri(search).
__device__ __forceinline__ int64_t tri(int64_t n) {
  const int64_t t = n >> kSkipTrigger;
  return 32 * t * (t - 1) + t * (n & 63);
}

template <typename T>
__global__ void __launch_bounds__(kLanes)
greedy_encode_kernel(const uint8_t* __restrict__ work, int64_t row_w,
                     const int64_t* __restrict__ lens, int64_t out_w,
                     uint8_t* __restrict__ out,
                     int64_t* __restrict__ out_lens,
                     int64_t* __restrict__ stats) {
  extern __shared__ int4 table4[];
  T* table = reinterpret_cast<T*>(table4);
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* src = work + b * row_w;
  uint8_t* dst = out + b * out_w;
  const int64_t len64 = lens[b];
  const int32_t src_len = static_cast<int32_t>(
      len64 < 0 ? 0 : (len64 < row_w ? len64 : row_w));

  constexpr int kTable4 = kTable * static_cast<int>(sizeof(T)) / 16;
  for (int i = lane; i < kTable4; i += kLanes)
    table4[i] = make_int4(0, 0, 0, 0);
  __syncwarp();

  const int32_t mf_limit = src_len - kMfLimit;
  const int32_t match_limit = src_len - kLastLiterals;
  const unsigned lt = (1u << lane) - 1;           // lanes below this one
  int32_t s = 0, anchor = 0, d = 0, search = kFresh;
  int64_t steps = 0, hits = 0;
  int32_t g_at = 0, g_lit = 0, g_off = 0, g_code = 0;  // lane j: sequence j
  int g_n = 0;
  while (s < mf_limit) {
    // the probe at s: its word, and the 32 bytes from s for the extension
    const uint32_t seq = word_at(src + s);
    const int32_t at = s + lane;
    const uint8_t here = at < match_limit ? ld8(src + at) : 0;
    ++steps;
    const uint32_t h = hash_of(seq);
    int32_t entry = 0;
    if (lane == 0) {
      entry = table[h];
      table[h] = static_cast<T>(s + 1);
    }
    int32_t hs = s, hc = __shfl_sync(kFull, entry, 0) - 1, mlen = 0;
    if (hc >= 0 && s != hc && s - hc < kWindow) {
      const bool neq = at >= match_limit || here != ld8(src + hc + lane);
      const unsigned m = __ballot_sync(kFull, neq);
      const int32_t first = m ? __ffs(m) - 1 : kLanes;
      if (first >= kMinMatch)          // equal words: a hit
        mlen = first < kLanes
                   ? first
                   : extend_from(src, s, hc, kLanes, match_limit, lane);
    }
    if (!mlen) {
      s += search >> kSkipTrigger;
      ++search;
      if (s >= mf_limit) break;
      // 32 probes of the miss run from (s, search) at once
      __syncwarp();                             // lane 0's table write
      ++steps;
      const int64_t t0 = tri(search);
      const int32_t p = s + static_cast<int32_t>(tri(search + lane) - t0);
      const bool joined = p < mf_limit;
      uint32_t word = 0, hp = kTable;           // kTable: no lane's hash
      if (joined) {
        word = word_at(src + p);
        hp = hash_of(word);
      }
      const unsigned peers = __match_any_sync(kFull, hp);
      const unsigned lower = peers & lt;
      const int32_t prev =
          __shfl_sync(kFull, p, lower ? 31 - __clz(lower) : lane);
      int32_t cand = -1;
      if (joined) cand = lower ? prev : static_cast<int32_t>(table[hp]) - 1;
      const bool good = joined && cand >= 0 && p != cand &&
                        p - cand < kWindow && word_at(src + cand) == word;
      const unsigned gm = __ballot_sync(kFull, good);
      const int f = gm ? __ffs(gm) - 1 : kLanes - 1;
      __syncwarp();                             // every read, then writes
      if (joined && lane <= f) {
        const unsigned upto =
            peers & (f == kLanes - 1 ? kFull : (2u << f) - 1);
        if (31 - __clz(upto) == lane) table[hp] = static_cast<T>(p + 1);
      }
      __syncwarp();
      if (!gm) {
        s += static_cast<int32_t>(tri(search + kLanes) - t0);
        search += kLanes;
        continue;
      }
      hs = __shfl_sync(kFull, p, f);
      hc = __shfl_sync(kFull, cand, f);
      mlen = extend_from(src, hs, hc, kMinMatch, match_limit, lane);
    }
    ++hits;
    if (lane == g_n) {
      g_at = anchor;
      g_lit = hs - anchor;
      g_off = hs - hc;
      g_code = mlen - kMinMatch;
    }
    if (++g_n == kLanes) {
      d = flush_group(dst, d, src, g_at, g_lit, g_off, g_code, g_n, lane);
      g_n = 0;
    }
    s = hs + mlen;
    anchor = s;
    search = kFresh;
  }
  if (g_n) d = flush_group(dst, d, src, g_at, g_lit, g_off, g_code, g_n, lane);
  if (src_len > 0)
    d = emit(dst, d, src + anchor, src_len - anchor, false, 0, 0, lane);
  __syncwarp();
  zero_fill(dst + d, static_cast<int32_t>(out_w - d), lane, kLanes);
  if (lane == 0) {
    out_lens[b] = d;
    stats[2 * b] = steps;
    stats[2 * b + 1] = hits;
  }
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
// What bounds it on this card: dependent latency. Each sequence loads a
// chain entry (the [rows, 64K] i32 chains are 256 MB, so mostly a DRAM
// access) and then the extension loads that depend on it; one warp per row
// gave only ~8 warps an SM to hide it. The design walks a row in W
// segments at once (one CTA of W warps a row):
//   1. Speculative walks. Warp w starts an anchor at sigma_w = w * S (S =
//      ceil(src_len / W); warp 0 is exact) and walks while its anchor is
//      below sigma_{w+1}, recording each sequence's (m, mlen - 4) as u16
//      pairs in shared memory (a segment of S bytes holds at most S/4 + 1).
//   2. The stitch (warp 0, in segment order). chain[x] == chain[a_j] for
//      every x in [a_j, m_j], so when the true anchor x entering segment w
//      lies in such a gap of w's list (binary search on m), sequence j and
//      every later one of w are exact (j's literals start at x). Otherwise
//      the warp walks on from x, appending to a per-row scratch in device
//      memory, until x lands in a gap or passes the segment (whose list is
//      then dropped) or the row ends. Never wrong, only slower on rows that
//      do not resynchronise.
//   3. Emission. Each warp sums its group's sizes (re-walked sequences,
//      then its kept ones: 1 + ext(lit) + lit + 2 + ext(mlen - 4)), a scan
//      over the W totals gives each group's stream offset, and every warp
//      writes its sequences through the shared emitter; then the trailing
//      literals, out_len, meta and the zero tail.
// Rows with history (hist_len = 65536) split only the payload; matches read
// below it as before.

__device__ __forceinline__ int32_t seq_end(uint32_t e) {
  return static_cast<int32_t>(e >> 16) + kMinMatch +
         static_cast<int32_t>(e & 0xFFFF);
}

// The sequence from an anchor with chain entry e: (m << 16) | (mlen - 4),
// or kFull where no match is left in the row.
__device__ __forceinline__ uint32_t walk_step(const uint8_t* src, uint32_t e,
                                              int32_t mf_limit,
                                              int32_t match_limit, int lane) {
  const int32_t m = static_cast<int32_t>(e >> 16);
  if (m >= mf_limit) return kFull;
  const int32_t k = extend_from(src, m, m - static_cast<int32_t>(e & 0xFFFF),
                                kMinMatch, match_limit, lane) -
                    kMinMatch;
  return static_cast<uint32_t>(m) << 16 | static_cast<uint32_t>(k);
}

// Segments (warps) a row. 8, 16 and 32 were timed on the 64 MiB frame's rows
// and 32 was fastest (PERF.md); two of its CTAs share an SM (64 warps), which
// sets the register cap.
constexpr int W = 32;

__global__ void __launch_bounds__(kLanes * W, 2)
hybrid_walk_kernel(const uint8_t* __restrict__ work, int64_t row_w,
                   int64_t hist_len, const int64_t* __restrict__ lens,
                   const uint32_t* __restrict__ chains, int64_t out_w,
                   uint8_t* __restrict__ out, int64_t* __restrict__ out_lens,
                   int64_t* __restrict__ meta, uint32_t* __restrict__ redo,
                   int64_t redo_w, int32_t cap,
                   int64_t* __restrict__ rewalked) {
  extern __shared__ uint32_t seqs[];          // [W][cap]: (m << 16) | k
  __shared__ int32_t cnt[W], exit_a[W], start_a[W], redo0[W], redo_n[W],
      kept[W], total[W];
  __shared__ int32_t final_a;
  const int lane = threadIdx.x % kLanes;
  const int w = threadIdx.x / kLanes;
  const int64_t b = blockIdx.x;
  const int64_t B = row_w - hist_len;
  const uint8_t* src = work + b * row_w + hist_len;  // history lies below
  const uint32_t* chain = chains + b * B;
  uint32_t* redo_row = redo + b * redo_w;
  uint8_t* dst = out + b * out_w;
  const int64_t len64 = lens[b];
  const int32_t src_len =
      static_cast<int32_t>(len64 < 0 ? 0 : (len64 < B ? len64 : B));
  const int32_t mf_limit = src_len - kMfLimit;
  const int32_t match_limit = src_len - kLastLiterals;
  const int32_t S = (src_len + W - 1) / W;

  // 1. speculative walk of segment w
  uint32_t* mine = seqs + w * cap;
  int32_t a = min32(w * S, src_len), n = 0;
  const int32_t hi = min32(a + S, src_len);
  while (a < hi) {
    const uint32_t sq = walk_step(src, __ldg(chain + a), mf_limit,
                                  match_limit, lane);
    if (sq == kFull) break;                   // no match left in the row
    if (lane == 0) mine[n] = sq;
    ++n;
    a = seq_end(sq);
  }
  if (lane == 0) {
    cnt[w] = n;
    exit_a[w] = a;
  }
  __syncthreads();

  // 2. the stitch, warp 0 in segment order
  if (w == 0) {
    int32_t x = exit_a[0], nredo = 0;
    bool ended = false;
    if (lane == 0) start_a[0] = redo0[0] = redo_n[0] = kept[0] = 0;
    for (int g = 1; g < W; ++g) {
      const int32_t g_start = x, g_redo = nredo;
      const uint32_t* list = seqs + g * cap;
      const int32_t c = cnt[g];
      int32_t keep = c;                       // nothing kept unless it meets
      while (!ended && x < exit_a[g]) {
        int32_t lo = 0, up = c;               // first entry with m >= x
        while (lo < up) {
          const int32_t mid = (lo + up) / 2;
          if (static_cast<int32_t>(list[mid] >> 16) < x) lo = mid + 1;
          else up = mid;
        }
        if (lo < c &&
            (lo == 0 ? min32(g * S, src_len) : seq_end(list[lo - 1])) <= x) {
          keep = lo;                          // x lies in lo's gap
          x = exit_a[g];
          break;
        }
        const uint32_t sq = walk_step(src, __ldg(chain + x), mf_limit,
                                      match_limit, lane);   // walk on
        if (sq == kFull) {
          ended = true;
          break;
        }
        if (lane == 0) redo_row[nredo] = sq;
        ++nredo;
        x = seq_end(sq);
      }
      if (lane == 0) {
        start_a[g] = g_start;
        redo0[g] = g_redo;
        redo_n[g] = nredo - g_redo;
        kept[g] = keep;
      }
    }
    if (lane == 0) {
      final_a = x;
      rewalked[b] = nredo;
    }
  }
  __syncthreads();

  // 3. emission: group w is its re-walked sequences, then its kept ones
  const int32_t nr = redo_n[w], nseq = nr + cnt[w] - kept[w];
  const uint32_t* rlist = redo_row + redo0[w];
  const uint32_t* klist = mine + kept[w] - nr;
  int32_t sz = 0;
  for (int32_t i = lane; i < nseq; i += kLanes) {
    const uint32_t e = i < nr ? rlist[i] : klist[i];
    const int32_t at = i == 0 ? start_a[w]
                              : seq_end(i - 1 < nr ? rlist[i - 1]
                                                   : klist[i - 1]);
    const int32_t lit = static_cast<int32_t>(e >> 16) - at;
    sz += 3 + ext_count(lit) + lit + ext_count(e & 0xFFFF);
  }
  for (int o = kLanes / 2; o; o >>= 1) sz += __shfl_xor_sync(kFull, sz, o);
  if (lane == 0) total[w] = nseq ? sz : -1;   // -1 marks an empty group
  __syncthreads();
  int32_t d = 0, tot = 0;
  bool last_group = nseq > 0;
  for (int g = 0; g < W; ++g) {
    const int32_t t = total[g] < 0 ? 0 : total[g];
    if (g < w) d += t;
    if (g > w && total[g] >= 0) last_group = false;
    tot += t;
  }
  int32_t at = start_a[w], last_d = -1, last_a = -1;
  for (int32_t i = 0; i < nseq; ++i) {
    const uint32_t e = i < nr ? rlist[i] : klist[i];
    const int32_t m = static_cast<int32_t>(e >> 16);
    last_d = d;
    last_a = at;
    d = emit(dst, d, src + at, m - at, true, __ldg(chain + m) & 0xFFFF,
             e & 0xFFFF, lane);
    at = seq_end(e);
  }
  const int32_t tail = src_len - final_a;
  const int32_t len = src_len > 0 ? tot + 1 + ext_count(tail) + tail : 0;
  if (w == W - 1 && src_len > 0)
    emit(dst, tot, src + final_a, tail, false, 0, 0, lane);
  if (lane == 0 && last_group) {
    meta[4 * b + 2] = last_d;
    meta[4 * b + 3] = last_a;
  }
  if (threadIdx.x == 0) {
    out_lens[b] = len;
    meta[4 * b] = tot;
    meta[4 * b + 1] = tail;
    if (tot == 0) meta[4 * b + 2] = meta[4 * b + 3] = -1;
  }
  zero_fill(dst + len, static_cast<int32_t>(out_w - len), threadIdx.x,
            kLanes * W);
}

template <typename T>
int launch_greedy(const void* work, int64_t nb, int64_t row_w,
                  const void* lens, int64_t out_w, void* out, void* out_lens,
                  void* stats, cudaStream_t stream) {
  const int smem = kTable * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      greedy_encode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_encode_kernel<T><<<static_cast<unsigned>(nb), kLanes, smem,
                            stream>>>(
      static_cast<const uint8_t*>(work), row_w,
      static_cast<const int64_t*>(lens), out_w, static_cast<uint8_t*>(out),
      static_cast<int64_t*>(out_lens), static_cast<int64_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work u8[nb, row_w] (row b's payload is its first lens[b] bytes); lens
// i64[nb]; out u8[nb, out_w] with out_w >= block_bound(row_w) and row_w <
// 2**31; out_lens i64[nb]; stats i64[nb, 2] (warp steps and hits per
// block). One CTA of one warp per block on *stream*, a u16 table for row_w
// <= 65536, else int32; does not synchronise; returns cudaGetLastError()
// (or the error of raising the shared-memory limit).
extern "C" int lz4t_greedy_encode(const void* work, int64_t nb,
                                  int64_t row_w, const void* lens,
                                  int64_t out_w, void* out, void* out_lens,
                                  void* stats, void* stream) {
  if (nb <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return row_w <= kU16Rows
             ? launch_greedy<uint16_t>(work, nb, row_w, lens, out_w, out,
                                       out_lens, stats, st)
             : launch_greedy<int32_t>(work, nb, row_w, lens, out_w, out,
                                      out_lens, stats, st);
}

// work u8[nb, row_w] ([history | payload] rows, hist_len bytes of history);
// lens i64[nb]; chains i32[nb, row_w - hist_len] (build_chains, read as
// u32); out u8[nb, out_w] with out_w >= block_bound(row_w - hist_len);
// out_lens i64[nb]; meta i64[nb, 4]; redo u32[nb, redo_w] with redo_w >=
// (row_w - hist_len) / 4 + 1 (the stitch's re-walked sequences); rewalked
// i64[nb] (their count per row). One CTA of W = 32 warps per row on
// *stream*; does not synchronise; returns cudaGetLastError() (or the error
// of raising the shared-memory limit).
extern "C" int lz4t_hybrid_encode(const void* work, int64_t nb,
                                  int64_t row_w, int64_t hist_len,
                                  const void* lens, const void* chains,
                                  int64_t out_w, void* out, void* out_lens,
                                  void* meta, void* redo, int64_t redo_w,
                                  void* rewalked, void* stream) {
  if (nb <= 0) return 0;
  const int64_t B = row_w - hist_len;
  const int32_t cap = static_cast<int32_t>((B + W - 1) / W / 4 + 2);
  const int smem = W * cap * 4;
  cudaError_t err = cudaFuncSetAttribute(
      hybrid_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hybrid_walk_kernel<<<static_cast<unsigned>(nb), kLanes * W, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(work), row_w, hist_len,
      static_cast<const int64_t*>(lens),
      static_cast<const uint32_t*>(chains), out_w,
      static_cast<uint8_t*>(out), static_cast<int64_t*>(out_lens),
      static_cast<int64_t*>(meta), static_cast<uint32_t*>(redo), redo_w, cap,
      static_cast<int64_t*>(rewalked));
  return static_cast<int>(cudaGetLastError());
}
