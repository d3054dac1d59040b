// Token-parsing LZ4 block decode for Hopper (sm_90a), plain C entry points.
//
// Replaces two TPU kernels that share one interpreter, _interpret_block
// (divortio_lz4_tpu/ops/pallas_decode.py:116-230):
//   lz4t_token_decode         _make_kernel (pallas_decode.py:233, launched
//                             by decode_blocks_pallas at :312): independent
//                             blocks, each decoded into its own row after an
//                             optional shared, right-aligned 64 KB history.
//   lz4t_token_decode_linked  _make_linked_kernel (:410, launched by
//                             decode_linked_chunk_pallas at :474): chains of
//                             dependent blocks, each chain decoded into
//                             [64 KB window | out0 | out1 ...], stored rows
//                             copied through.
// Unlike the record kernels (compact_decode.cu, chain_decode.cu), nothing is
// parsed on the host: the device walks the LZ4 token stream itself.
//
// The interpreter keeps every clamp of the TPU kernel, which is its
// contract on hostile input (pallas_decode.py:160-225):
//   - lit_len is clamped to o_limit - o and to comp_len + 128 - p, then to
//     >= 0; bytes past comp_len read as zeros (the TPU rows' zero padding);
//   - the match is parsed even after the trailing literals, and counts only
//     when p < comp_len (valid);
//   - mlen = min(ml + 4, o_limit - o), and 0 unless 1 <= offset <= o, o
//     counting from the start of the io space (history or window included);
//   - in the linked entry, a stored row copies min(len, block_size) bytes
//     and a compressed row decodes with o_limit = cursor + block_size.
// So [0, out_len) and out_len equal the TPU kernel's on any input. The TPU
// writes wild 128-byte chunks past the frontier; here every write is exact
// (literal and match spans tile the output), and bytes past the decoded
// output are zeros.
//
// interpret() hands each parsed sequence to a sink: WriteSink copies it
// into the output at once (lz4t_token_decode's serial route), SpanSink
// records it as a span and writes nothing (lz4t_token_decode_linked).
//
// lz4t_token_decode does not walk a block one sequence after another. The
// first port did (one warp a block, lane 0's scalar parse, then each
// sequence's copies, a round trip through L2 per sequence): the block
// with the most sequences (8948 of a 64 KB block of the corpus) set the
// time, ~0.5 us a sequence. It runs five stages, one CTA per block each:
//   1. token_split_kernel: lane w parses segment w of the row
//      speculatively (from byte w * ceil(n / 32), without the cursor's
//      clamps: the token positions do not depend on the cursor while its
//      o_limit clamp does not bind), listing its token positions.
//   2. token_stitch_kernel: in segment order, the true cursor x entering
//      segment w is exact from there on if it is in w's list; else the
//      warp walks on from x until it is, or x leaves the segment.
//   3. token_heads_kernel, 1024 threads: every sequence's header, its
//      cursor by a CTA scan, the conformance check (no literal or match
//      clamp binds and every match's offset is in [1, om]: then the
//      parallel result is interpret()'s), and every literal byte.
//   4. token_matches_kernel, one warp: the matches in groups of 32
//      sequences, group by group: those whose source ends at or before
//      the group's first output byte read only final bytes and are copied
//      in parallel; the group's other matches in order, each with
//      out[om + i] = io[om - offset + i % offset], the exact LZ4 overlap
//      copy (its reads lie in [om - offset, om), final before it starts).
//   5. token_serial_kernel: a block that failed the check (only hostile
//      or truncated rows do) decodes with interpret() and WriteSink, the
//      first port's walk; every other CTA returns at once.
// What bounds it: stage 4's chain of groups, one after another, on the
// blocks with the most sequences (the busiest of the 64 MiB frame's 1024
// blocks holds 8948, ~280 groups), and the instruction latency of each
// group's steps on an SM that runs a few warps; then the stitch's walk on
// rows whose segments do not meet the true walk (up to 997 sequences a
// block there). On the 64 MiB frame's blocks (NVIDIA H100 80GB HBM3,
// 700 W; chip_decode_steps.py): 2.04-2.07 ms (the first port's walk:
// 4.72-4.77), of which matches 1.47, stitch 0.30, split parse 0.16,
// heads 0.10. Neither a ring of recent output in shared memory (stage 4
// read its own bytes from L2) nor copying late matches in rounds was
// faster (PERF.md).
//
// lz4t_token_decode_linked does not walk a chain in order: a linked frame
// is one chain, and one warp walking its 2M sequences left 131 of the 132
// SMs idle. It resolves the matches in parallel (span_resolve.cuh):
//   A. token_rows_kernel (lz4t_token_slots, one CTA) gives each row its
//      span slots, 1 for a stored row and len / 3 + 1 for a compressed one
//      (every sequence but the last consumes a token and two offset
//      bytes), by a prefix sum; the host reads their total, the call's one
//      sync, and sizes the span scratch to it. The kernel also reads
//      row_off and out_off as their running maxima, clamped into the row
//      and output arrays, so no two chains share a row or an output byte
//      (the offsets are non-decreasing on every batch the port builds).
//      token_parse_kernel, one warp per row: the row alone, at a row-local
//      cursor with limit block_size, into spans (o, wire p, lit, mlen,
//      offset), without writing output. The parse never reads output.
//      token_fix_kernel, one warp per chain, scans the rows' lengths into
//      cursors. A row parsed alone equals the serial parse while cursor +
//      n <= 64 KB + cap (the cap clamp cannot bind), so only the first row
//      that would pass its chain's region is parsed again, with the room
//      left; every row after it decodes to 0 bytes, as in the serial walk.
//      The offset > o clamp never fires in the linked entry (o >= 65536 >
//      offset) and is kept.
//   B. token_spans_kernel, one warp per 32 span slots: literal bytes go
//      straight to the output; match byte i takes parent o - offset +
//      i % offset, the kernel's own periodic source, so an offset-1 run of
//      any length is one hop to its literal. A span with over 1 KB in the
//      segment (a 4 MB literal run of incompressible bytes, a long zero
//      run) goes to a list that token_long_kernel spreads over the grid
//      in 4 KB chunks, so no warp walks megabytes alone.
//   C, D. pointer doubling and gather (span_resolve.cuh).
//
// What bounds the linked entry: the pointer-doubling rounds, then the
// parse, which is the dependent latency of each sequence on one warp,
// rows in parallel: with one row per 4 MB block the parse took 104.7 ms,
// so the host stages a scanned block as its ~64 KB pieces
// (parallel/device.py, stage_token_chains). On the 64 MiB default frame
// (978 rows; NVIDIA H100 80GB HBM3, 700 W; profiled stages): 7.08 ms,
// of which rounds 2.63, parse 2.38, spans 0.72, long spans 0.30, gather
// 0.21, fix 0.15, init 0.11, row slots 0.004; scratch 370 MB, 98 MB of
// it span slots. ptxas (sm_90a), no spills: token_rows_kernel 32
// registers (512 B shared), token_parse_kernel 38, token_fix_kernel 44,
// token_spans_kernel 40, token_long_kernel 40; lz4t_token_decode's
// token_split_kernel 19, token_stitch_kernel 26, token_heads_kernel 32
// (12548 B shared), token_matches_kernel 47 (384 B shared),
// token_serial_kernel 52.

#include <cuda_runtime.h>
#include <stdint.h>

#include "span_resolve.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int64_t kWin = 65536;       // history / window ahead of the output
constexpr int64_t kHalfSlack = 128;   // SLACK // 2 of the TPU kernel

__host__ __device__ __forceinline__ int64_t min64(int64_t a,
                                                  int64_t b) {
  return a < b ? a : b;
}

__host__ __device__ __forceinline__ int64_t max64(int64_t a,
                                                  int64_t b) {
  return a > b ? a : b;
}

__host__ __device__ __forceinline__ int64_t clamp64(int64_t x,
                                                    int64_t lo,
                                                    int64_t hi) {
  return min64(max64(x, lo), hi);
}

// A compressed row; bytes at and past len read as zeros.
struct Comp {
  const uint8_t* p;
  int64_t len;
  __device__ __forceinline__ uint32_t at(int64_t i) const {
    return i < len ? __ldg(p + i) : 0u;
  }
};

// The io space of a block or chain: [0, base) is the read-only history
// (seed, or zeros when null), [base, ...) the output.
struct Io {
  const uint8_t* seed;
  int64_t base;
  uint8_t* out;
  __device__ __forceinline__ uint8_t read(int64_t x) const {
    if (x >= base) return out[x - base];   // written by this warp: no __ldg
    return seed != nullptr ? __ldg(seed + x) : 0;
  }
  __device__ __forceinline__ void write(int64_t x, uint8_t v) const {
    out[x - base] = v;
  }
};

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

// A 0xFF-run length extension starting at *p (every lane reads the same
// bytes); returns the sum of its bytes.
__device__ __forceinline__ int64_t read_ext(const Comp& c, int64_t* p) {
  int64_t sum = 0;
  uint32_t v;
  do {
    v = c.at(*p);
    *p += 1;
    sum += v;
  } while (v == 255);
  return sum;
}

// One parsed sequence goes to the sink as (o, lit_at, lit, offset, mlen):
// lit literal bytes at output position o from the row's byte lit_at, then
// mlen match bytes at o + lit, each from (o + lit) - offset + i % offset.

// Copies every sequence into the io space at once.
struct WriteSink {
  Io io;
  __device__ __forceinline__ void sequence(const Comp& c, int64_t o,
                                           int64_t lit_at, int64_t lit,
                                           int64_t offset, int64_t mlen,
                                           int lane) const {
    for (int64_t i = lane; i < lit; i += kLanes)
      io.write(o + i, static_cast<uint8_t>(c.at(lit_at + i)));
    __syncwarp();   // the literals are visible to the match's reads
    const int64_t om = o + lit;
    const int64_t from = om - offset;
    const uint32_t off32 = static_cast<uint32_t>(offset > 0 ? offset : 1);
    for (int64_t i = lane; i < mlen; i += kLanes)
      io.write(om + i, io.read(from + static_cast<uint32_t>(i) % off32));
    __syncwarp();   // the match is visible to the next sequence
  }
};

// Records every sequence that writes a byte as a span (o - o_base, lit_at,
// lit, mlen) and its offset; lane 0 stores. cap is the row's slot count
// (token_rows_kernel), which holds every span the row can give; the
// k < cap test keeps a store inside the row's slots all the same.
struct SpanSink {
  uint4* spans;
  uint16_t* offs;
  int64_t cap;
  int64_t o_base;
  int64_t k;
  __device__ __forceinline__ void sequence(const Comp&, int64_t o,
                                           int64_t lit_at, int64_t lit,
                                           int64_t offset, int64_t mlen,
                                           int lane) {
    if (lit == 0 && mlen == 0) return;
    if (lane == 0 && k < cap) {
      spans[k] = make_uint4(static_cast<uint32_t>(o - o_base),
                            static_cast<uint32_t>(lit_at),
                            static_cast<uint32_t>(lit),
                            static_cast<uint32_t>(mlen));
      offs[k] = static_cast<uint16_t>(offset);
    }
    ++k;
  }
};

// _interpret_block: parse c from output position o_start, never past
// o_limit, handing each sequence to the sink. Every lane of the warp calls
// it; returns the final output cursor.
template <class Sink>
__device__ int64_t interpret(const Comp& c, Sink& sink, int64_t o_start,
                             int64_t o_limit, int lane) {
  int64_t p = 0;
  int64_t o = o_start;
  while (p < c.len) {
    const uint32_t token = c.at(p);
    p += 1;
    int64_t lit = token >> 4;
    if (lit == 15) lit += read_ext(c, &p);
    lit = max64(min64(min64(lit, o_limit - o), c.len + kHalfSlack - p), 0);
    const int64_t lit_at = p;
    p += lit;
    const int64_t om = o + lit;

    const bool valid = p < c.len;
    const int64_t offset = c.at(p) | (c.at(p + 1) << 8);
    int64_t p2 = p + 2;
    int64_t ml = token & 15;
    if (valid && ml == 15) ml += read_ext(c, &p2);
    int64_t mlen = valid ? min64(ml + 4, o_limit - om) : 0;
    if (offset < 1 || offset > om) mlen = 0;
    sink.sequence(c, o, lit_at, lit, offset, mlen, lane);
    if (valid) p = p2;
    o = om + mlen;
  }
  return o;
}

// ---------------------------------------------------------------------------
// lz4t_token_decode: independent blocks, one warp a block
// ---------------------------------------------------------------------------

constexpr int kSegs = 32;              // segments a row: one lane each
constexpr uint32_t kSat = 1u << 25;    // lengths saturate here in the scan
constexpr int kUnroll = 8;             // match bytes a lane copies at once
constexpr uint32_t kNone = 0xFFFFFFFFu;

// A compressed row in 32-bit positions (row_w < 2**23: the wrapper
// checks); bytes at and past n read as zeros.
struct Row {
  const uint8_t* p;
  uint32_t n;
  __device__ __forceinline__ uint32_t at(uint32_t i) const {
    return i < n ? __ldg(p + i) : 0u;
  }
  // A 0xFF-run length extension starting at *q; the sum of its bytes
  // stays below 2**32 (at most 255 a byte of the row and one past it).
  __device__ __forceinline__ uint32_t ext(uint32_t* q) const {
    uint32_t sum = 0, v;
    do {
      v = at(*q);
      *q += 1;
      sum += v;
    } while (v == 255);
    return sum;
  }
};

// The sequence whose token is at p, parsed without the output cursor's
// clamps: interpret()'s token positions do not depend on the cursor while
// its o_limit clamp does not bind. lit keeps the clamp to n + 128 - p,
// which does not depend on it either.
struct Head {
  uint32_t next;     // the next token's position (>= n: the row ends)
  uint32_t lit, lit_at, offset, ml;
  bool valid;        // a match follows the literals
};

__device__ __forceinline__ Head head_at(const Row& c, uint32_t p) {
  Head h;
  const uint32_t token = c.at(p);
  p += 1;
  uint32_t lit = token >> 4;
  if (lit == 15) lit += c.ext(&p);
  h.lit = min(lit, c.n + static_cast<uint32_t>(kHalfSlack) - p);
  h.lit_at = p;
  p += h.lit;
  h.valid = p < c.n;
  h.offset = c.at(p) | (c.at(p + 1) << 8);
  uint32_t p2 = p + 2;
  h.ml = token & 15;
  if (h.valid && h.ml == 15) h.ml += c.ext(&p2);
  h.next = h.valid ? p2 : p;
  return h;
}

__device__ __forceinline__ uint32_t warp_incl_sum(uint32_t v, int lane) {
  for (int d = 1; d < kLanes; d <<= 1) {
    const uint32_t u = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Byte x of the io space [history | output row], x below the group's
// bytes or inside the final ones (written by this warp: no __ldg).
__device__ __forceinline__ uint8_t io_read(const uint8_t* hist, uint32_t base,
                                           const uint8_t* out, uint32_t x) {
  if (x >= base) return out[x - base];
  return hist != nullptr ? __ldg(hist + x) : 0;
}

// The inputs, outputs and scratch of lz4t_token_decode's four stages,
// one warp a block each. meta u32[nb, kMeta] carries a block's state from
// stage to stage: per segment its list's length and its walk's exit, then
// the sequences, the sequences the stitch walked again, the serial flag.
constexpr int kMeta = 2 * kSegs + 3;
constexpr int kNSeq = 2 * kSegs, kRedo = kNSeq + 1, kSerial = kNSeq + 2;

struct Blocks {
  const uint8_t* comp;
  int64_t row_w;
  const int64_t* lens;
  const uint8_t* hist;
  int64_t block_size;
  uint8_t* out;
  int64_t* out_lens;
  uint32_t* lists;     // [nb, kSegs, list_w] speculative token positions
  int64_t list_w;
  uint32_t* starts;    // [nb, starts_w] the true token positions, in order
  int64_t starts_w;
  uint32_t* meta;      // [nb, kMeta]
  int32_t* stats;      // [nb, 4] or null

  __device__ __forceinline__ Row row(int64_t b) const {
    return Row{comp + b * row_w,
               static_cast<uint32_t>(clamp64(lens[b], 0, row_w))};
  }
  __device__ __forceinline__ uint32_t base() const {
    return hist != nullptr ? static_cast<uint32_t>(kWin) : 0u;
  }
  __device__ __forceinline__ uint32_t* list(int64_t b, int w) const {
    return lists + (b * kSegs + w) * list_w;
  }
};

// Stage 1, the split parse: lane w walks segment w of the row (S =
// ceil(n / 32) bytes from w * S) without the cursor's clamps, recording
// every token position it visits until one is at or past the segment's
// end. The positions are 3 bytes apart at least (a token, then two offset
// bytes, unless the row ends), so a list holds at most ceil(S / 3) <=
// list_w of them; lane 0's is exact.
__global__ void __launch_bounds__(kLanes)
token_split_kernel(Blocks bk) {
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const Row c = bk.row(b);
  const uint32_t S = (c.n + kSegs - 1) / kSegs;
  uint32_t* mine = bk.list(b, lane);
  uint32_t p = lane * S, k = 0;
  const uint32_t hi = p + S;
  while (p < c.n && p < hi) {
    mine[k++] = p;
    p = head_at(c, p).next;
  }
  uint32_t* meta = bk.meta + b * kMeta;
  meta[lane] = k;
  meta[kSegs + lane] = p;
}

// Stage 2, the stitch, in segment order: the true cursor x entering
// segment w is exact from there on if it is in w's list (the warp looks
// for it 32 entries at a time); else the warp walks on from x, appending
// to starts, until x is in the list or leaves the segment. Never wrong,
// only slower on rows whose walks do not meet.
__global__ void __launch_bounds__(kLanes)
token_stitch_kernel(Blocks bk) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const Row c = bk.row(b);
  const uint32_t S = (c.n + kSegs - 1) / kSegs;
  uint32_t* meta = bk.meta + b * kMeta;
  uint32_t* fin = bk.starts + b * bk.starts_w;
  uint32_t x = meta[kSegs], total = 0, redo = 0;
  for (int w = 0; w < kSegs; ++w) {
    const uint32_t* lst = bk.list(b, w);
    const uint32_t n_w = meta[w];
    uint32_t j = 0;
    if (w > 0) {
      const uint32_t hi = (w + 1) * S;
      if (x >= c.n) break;
      if (x >= hi) continue;           // a literal run passed the segment
      for (;;) {
        bool found = false;
        for (;;) {                     // the first entry >= x, from j on
          const uint32_t v = j + lane < n_w ? lst[j + lane] : kFull;
          const unsigned eq = __ballot_sync(kFull, v == x);
          const unsigned lt = __ballot_sync(kFull, v < x);
          if (eq) {
            j += __ffs(eq) - 1;
            found = true;
            break;
          }
          j += __popc(lt);
          if (lt != kFull) break;
        }
        if (found) break;
        if (lane == 0) fin[total] = x;
        ++total;
        ++redo;
        x = head_at(c, x).next;
        if (x >= hi || x >= c.n) {
          j = n_w;                     // the list is dropped
          break;
        }
      }
      if (j < n_w) x = meta[kSegs + w];
    } else {
      x = meta[kSegs];
    }
    for (uint32_t i = lane; j + i < n_w; i += kLanes)
      fin[total + i] = lst[j + i];
    total += n_w - j;
  }
  if (lane == 0) {
    meta[kNSeq] = total;
    meta[kRedo] = redo;
    meta[kSerial] = 0;
  }
}

// Stage 3, every sequence of a block at once, 1024 a pass: its header
// (interpret()'s, without the cursor's clamps), its cursor by a CTA scan
// of lit + mlen, the conformance check (no clamp of interpret() binds, so
// its cursor, and the token positions after each sequence, are the ones
// used here; a block that fails it is left to stage 5), then the
// literals, which read only the row, as one run of bytes over the CTA.
// starts[k] becomes sequence k's match position om, and mlens and offs
// (the dropped lists' space) take its match length and offset.
constexpr int kHeadThreads = resolve::kScanThreads;

__global__ void __launch_bounds__(kHeadThreads)
token_heads_kernel(Blocks bk, uint32_t* __restrict__ mlens) {
  __shared__ uint32_t s_lend[kHeadThreads], s_o[kHeadThreads],
      s_at[kHeadThreads];
  __shared__ int bad;
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const Row c = bk.row(b);
  uint8_t* ob = bk.out + b * bk.block_size;
  const int64_t base = bk.base();
  const int64_t o_limit = base + bk.block_size;
  uint32_t* meta = bk.meta + b * kMeta;
  uint32_t* fin = bk.starts + b * bk.starts_w;
  uint32_t* ml = mlens + b * bk.starts_w;
  uint32_t* offs = bk.list(b, 0);
  const uint32_t n_seq = meta[kNSeq];
  if (t == 0) bad = 0;
  // every thread reads bad after the loop, which an empty row (a stored
  // block is staged with length 0) skips: without this barrier a thread
  // could read what the SM's shared memory last held, leave its part of
  // the row's zero tail unwritten and so leave torch.empty's bytes there
  __syncthreads();
  int64_t o = base;
  for (uint32_t k0 = 0; k0 < n_seq; k0 += kHeadThreads) {
    const uint32_t k = k0 + t;
    const bool live = k < n_seq;
    Head h{};
    if (live) h = head_at(c, fin[k]);
    const uint32_t mlen = live && h.valid ? h.ml + 4 : 0;
    const uint32_t lit = live ? h.lit : 0;
    int64_t tot, ltot;
    const int64_t span = static_cast<int64_t>(lit) + min(mlen, kSat);
    const int64_t oc = o + resolve::cta_scan<false>(span, &tot) - span;
    const int64_t om = oc + lit;
    if (live && !(om <= o_limit &&
                  (mlen == 0 || (h.offset >= 1 && h.offset <= om &&
                                 mlen <= o_limit - om))))
      bad = 1;
    const uint32_t lend =
        static_cast<uint32_t>(resolve::cta_scan<false>(lit, &ltot));
    if (bad) break;    // uniform: cta_scan ends at a barrier
    if (live) {
      fin[k] = static_cast<uint32_t>(om);
      ml[k] = mlen;
      offs[k] = h.offset;
    }
    s_lend[t] = lend;
    s_o[t] = static_cast<uint32_t>(oc - base);
    s_at[t] = h.lit_at;
    __syncthreads();
    for (uint32_t j = t; j < ltot; j += kHeadThreads) {
      uint32_t lo = 0, hi = kHeadThreads - 1;   // the first lend > j
      while (lo < hi) {
        const uint32_t mid = (lo + hi) >> 1;
        if (s_lend[mid] <= j)
          lo = mid + 1;
        else
          hi = mid;
      }
      const uint32_t i = j - (lo > 0 ? s_lend[lo - 1] : 0);
      ob[s_o[lo] + i] = static_cast<uint8_t>(c.at(s_at[lo] + i));
    }
    __syncthreads();   // s_* are written again by the next pass
    o += tot;
  }
  if (bad) {
    if (t == 0) meta[kSerial] = 1;
    return;
  }
  const int64_t n = o - base;
  for (int64_t i = n + t; i < bk.block_size; i += kHeadThreads) ob[i] = 0;
  if (t == 0) bk.out_lens[b] = n;
}

// Stage 4, the matches, in groups of 32 sequences, one a lane, group by
// group: the matches whose source ends at or before the group's first
// output byte g0 read only final bytes (every literal, and the groups
// before) and are copied in parallel, as one run of bytes over the warp;
// then the group's other matches in order.
__global__ void __launch_bounds__(kLanes)
token_matches_kernel(Blocks bk, const uint32_t* __restrict__ mlens) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  __shared__ uint32_t g_om[kLanes], g_off[kLanes], g_mend[kLanes];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* hist = bk.hist;
  uint8_t* ob = bk.out + b * bk.block_size;
  const uint32_t base = bk.base();
  const uint32_t* meta = bk.meta + b * kMeta;
  const uint32_t* fin = bk.starts + b * bk.starts_w;
  const uint32_t* ml = mlens + b * bk.starts_w;
  const uint32_t* offs = bk.list(b, 0);
  const uint32_t n_seq = meta[kNSeq];
  const bool serial = meta[kSerial] != 0;
  uint32_t in_order = 0;
  for (uint32_t k0 = 0; k0 < n_seq && !serial; k0 += kLanes) {
    const uint32_t k = k0 + lane;
    const bool live = k < n_seq;
    const uint32_t om = live ? fin[k] : 0;
    const uint32_t mlen = live ? ml[k] : 0;
    const uint32_t off = live ? offs[k] : 0;
    const bool valid = mlen > 0;
    // the group's first output byte: the end of the sequence before it
    const uint32_t g0 = k0 == 0 ? base : fin[k0 - 1] + ml[k0 - 1];
    const bool early = valid && om - off + min(mlen, off) <= g0;
    const uint32_t mend = warp_incl_sum(early ? mlen : 0, lane);
    g_om[lane] = om;
    g_off[lane] = off;
    g_mend[lane] = mend;
    __syncwarp();
    // kUnroll bytes a lane at a time: all their loads, then all their
    // stores (q: the sequence that owns byte j)
    const uint32_t n_em = __shfl_sync(kFull, mend, kLanes - 1);
    for (uint32_t j0 = lane, q = 0; j0 < n_em; j0 += kLanes * kUnroll) {
      uint32_t to[kUnroll];
      uint8_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t j = j0 + u * kLanes;
        to[u] = kNone;
        if (j < n_em) {
          while (g_mend[q] <= j) ++q;
          const uint32_t i = j - (q > 0 ? g_mend[q - 1] : 0);
          const uint32_t d = g_off[q];
          to[u] = g_om[q] - base + i;
          v[u] = io_read(hist, base, ob, g_om[q] - d + (i < d ? i : i % d));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (to[u] != kNone) ob[to[u]] = v[u];
    }
    __syncwarp();
    // the other matches, in order: byte i takes from + i % offset, which
    // lies in [from, om) and is final, so one match needs no barrier
    const unsigned late = __ballot_sync(kFull, valid && !early);
    in_order += __popc(late);
    for (unsigned m = late; m; m &= m - 1) {
      const int s = __ffs(m) - 1;
      const uint32_t s_om = __shfl_sync(kFull, om, s);
      const uint32_t d = __shfl_sync(kFull, off, s);
      const uint32_t n = __shfl_sync(kFull, mlen, s);
      const uint32_t from = s_om - d;
      const uint32_t r32 = kLanes % d;
      uint32_t t = lane % d;            // i % d for i = lane
      for (uint32_t i = lane; i < n; i += kLanes) {
        ob[s_om - base + i] = io_read(hist, base, ob, from + t);
        t += r32;
        if (t >= d) t -= d;
      }
      __syncwarp();
    }
  }
  if (lane == 0 && bk.stats != nullptr) {
    int32_t* st = bk.stats + 4 * b;
    st[0] = static_cast<int32_t>(n_seq);
    st[1] = static_cast<int32_t>(meta[kRedo]);
    st[2] = static_cast<int32_t>(in_order);
    st[3] = serial;
  }
}

// Stage 5, the serial route of the blocks stage 3 refused (others return
// at once): interpret() over the whole row, as the first port ran every
// block. It rewrites every byte it decodes.
__global__ void __launch_bounds__(kLanes)
token_serial_kernel(Blocks bk) {
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  if (!bk.meta[b * kMeta + kSerial]) return;
  const Row c = bk.row(b);
  uint8_t* ob = bk.out + b * bk.block_size;
  WriteSink sink{{bk.hist, bk.base(), ob}};
  const int64_t n =
      interpret(Comp{c.p, c.n}, sink, bk.base(), bk.base() + bk.block_size,
                lane) - bk.base();
  zero_fill(ob + n, bk.block_size - n, lane);
  if (lane == 0) bk.out_lens[b] = n;
}

// The linked entry's inputs (see lz4t_token_decode_linked).
struct Chains {
  const uint8_t* comp;
  int64_t comp_total;
  const int64_t* comp_off;
  const uint8_t* stored;
  int64_t n_rows;
  const int64_t* row_off;
  int64_t n_chains;
  const int64_t* out_off;
  int64_t out_total;
  int64_t block_size;

  // Row r's wire bytes, clamped into comp (none when they end before they
  // start).
  __device__ __forceinline__ Comp row(int64_t r) const {
    const int64_t w0 = clamp64(comp_off[r], 0, comp_total);
    const int64_t e = clamp64(comp_off[r + 1], 0, comp_total);
    return Comp{comp + w0, max64(e, w0) - w0};
  }
};

// Device scratch of the linked entry. The i64 parts lie in one buffer,
// rows i64[5 * n_rows + 2 * n_chains + 3], in this order.
struct Scratch {
  uint4* spans;        // [n_slots] (o, lit_at, lit, mlen)
  uint16_t* offs;      // [n_slots]
  int64_t* slot0;      // [n_rows + 1] row r's slots [slot0[r], slot0[r + 1])
  int64_t* ro;         // [n_chains + 1] row_off's running maximum, clamped
  int64_t* oo;         // [n_chains + 1] out_off's
  int64_t* nspans;     // [n_rows] spans the row recorded
  int64_t* nloc;       // row length parsed alone
  int64_t* row_base;   // output position of the row's first byte, or -1
  int64_t* row_o0;     // its chain's first output byte

  // The row that owns slot j (every row owns at least one).
  __device__ __forceinline__ int64_t row_of(int64_t j, int64_t n_rows) const {
    int64_t lo = 0, hi = n_rows - 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi + 1) >> 1;
      if (slot0[mid] <= j)
        lo = mid;
      else
        hi = mid - 1;
    }
    return lo;
  }
};

Scratch scratch_of(void* rows, int64_t n_rows, int64_t n_chains,
                   void* spans, void* offs) {
  int64_t* p = static_cast<int64_t*>(rows);
  Scratch sc;
  sc.spans = static_cast<uint4*>(spans);
  sc.offs = static_cast<uint16_t*>(offs);
  sc.slot0 = p;
  sc.ro = sc.slot0 + n_rows + 1;
  sc.oo = sc.ro + n_chains + 1;
  sc.nspans = sc.oo + n_chains + 1;
  sc.nloc = sc.nspans + n_rows;
  sc.row_base = sc.nloc + n_rows;
  sc.row_o0 = sc.row_base + n_rows;
  return sc;
}

using resolve::cta_scan;
using resolve::kScanThreads;   // token_rows_kernel's one CTA

// Stage A, before the parse: every row's span slots, 1 for a stored row,
// len / 3 + 1 for a compressed one. interpret() ends when p reaches len,
// and every sequence but the last moves p by at least 3 (the token, then
// two offset bytes), so a row gives at most (len - 1) / 3 + 1 sequences,
// at any o_limit. Then row_off and out_off as their running maxima.
__global__ void __launch_bounds__(kScanThreads)
token_rows_kernel(Chains ch, Scratch sc) {
  int64_t base = 0, total;
  for (int64_t b = 0; b < ch.n_rows; b += kScanThreads) {
    const int64_t r = b + threadIdx.x;
    int64_t n = 0;
    if (r < ch.n_rows) n = ch.stored[r] ? 1 : ch.row(r).len / 3 + 1;
    const int64_t inc = cta_scan<false>(n, &total);
    if (r < ch.n_rows) sc.slot0[r] = base + inc - n;
    base += total;
  }
  if (threadIdx.x == 0) sc.slot0[ch.n_rows] = base;
  int64_t r_hi = 0, o_hi = 0;
  for (int64_t b = 0; b <= ch.n_chains; b += kScanThreads) {
    const int64_t c = b + threadIdx.x;
    const bool in = c <= ch.n_chains;
    int64_t r_tot, o_tot;
    const int64_t r = cta_scan<true>(
        in ? clamp64(ch.row_off[c], 0, ch.n_rows) : 0, &r_tot);
    const int64_t o = cta_scan<true>(
        in ? clamp64(ch.out_off[c], 0, ch.out_total) : 0, &o_tot);
    if (in) {
      sc.ro[c] = max64(r, r_hi);
      sc.oo[c] = max64(o, o_hi);
    }
    r_hi = max64(r_hi, r_tot);
    o_hi = max64(o_hi, o_tot);
  }
}

__device__ __forceinline__ SpanSink sink_of(const Scratch& sc, int64_t r) {
  const int64_t s = sc.slot0[r];
  return SpanSink{sc.spans + s, sc.offs + s, sc.slot0[r + 1] - s, kWin, 0};
}

// Stage A: row r alone at cursor kWin with limit block_size.
constexpr int kParseWarps = 4;

__global__ void __launch_bounds__(kParseWarps * kLanes)
token_parse_kernel(Chains ch, Scratch sc) {
  const int lane = threadIdx.x & 31;
  const int64_t r = blockIdx.x * static_cast<int64_t>(kParseWarps) +
                    (threadIdx.x >> 5);
  if (r >= ch.n_rows) return;
  const Comp c = ch.row(r);
  SpanSink sink = sink_of(sc, r);
  int64_t n;
  if (ch.stored[r]) {
    n = min64(c.len, ch.block_size);
    sink.sequence(c, kWin, 0, n, 0, 0, lane);
  } else {
    n = interpret(c, sink, kWin, kWin + ch.block_size, lane) - kWin;
  }
  if (lane == 0) {
    sc.nspans[r] = min64(sink.k, sink.cap);
    sc.nloc[r] = n;
    sc.row_base[r] = -1;
  }
}

// Stage A, last step: chain ci's cursors, its one clipped row parsed
// again with the room left, and out_lens.
__global__ void __launch_bounds__(kLanes)
token_fix_kernel(Chains ch, Scratch sc, int64_t* __restrict__ out_lens) {
  const int64_t ci = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t r0 = sc.ro[ci];
  const int64_t r1 = sc.ro[ci + 1];
  const int64_t o0 = sc.oo[ci];
  const int64_t cap = sc.oo[ci + 1] - o0;
  int64_t done = 0;   // bytes of the region decoded so far
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t room = cap - done;
    int64_t n = sc.nloc[r];
    if (n > room) {
      int64_t k = 0;
      if (room > 0) {
        const Comp c = ch.row(r);
        SpanSink sink = sink_of(sc, r);
        if (ch.stored[r]) {
          n = room;
          sink.sequence(c, kWin, 0, n, 0, 0, lane);
        } else {
          n = interpret(c, sink, kWin, kWin + room, lane) - kWin;
        }
        k = min64(sink.k, sink.cap);
      } else {
        n = 0;
      }
      if (lane == 0) sc.nspans[r] = k;
    }
    if (lane == 0) {
      sc.row_base[r] = o0 + done;
      sc.row_o0[r] = o0;
      out_lens[r] = n;
    }
    done += n;
  }
}

// A live span, placed: bytes [0, lit) take comp[wi0 + i] (zeros at and
// past wend), byte i >= lit takes output position from + (i - lit) %
// period; g0 is the output position of byte 0, o0 its chain's first byte.
struct Placed {
  int64_t g0, tot, lit, wi0, wend, o0, from, period;
};

constexpr int64_t kLong = 1024;    // a warp writes spans up to this itself
constexpr int64_t kChunk = 4096;   // bytes of a longer span per CTA turn

// Stage B for bytes i0 + t, i0 + t + step, ... < i1 of span s.
__device__ __forceinline__ void span_bytes(const uint8_t* comp,
                                           const resolve::Seg& seg,
                                           const Placed& s, int64_t i0,
                                           int64_t i1, int t, int step) {
  const uint32_t period = static_cast<uint32_t>(s.period);
  for (int64_t i = i0 + t; i < i1; i += step) {
    const int64_t g = s.g0 + i;
    if (i < s.lit) {
      const int64_t wi = s.wi0 + i;
      seg.out[g] = wi < s.wend ? __ldg(comp + wi) : 0;
    } else {
      const uint32_t m = static_cast<uint32_t>(i - s.lit);
      resolve::take(seg, g, s.o0, s.from + m % period, seg.seed);
    }
  }
}

// Stage B over one segment: a warp takes 32 span slots, then writes the
// bytes of each live span that fall in the segment, 32 at a time; a span
// with more than kLong of them goes to the long list (token_long_kernel)
// while it has room.
__global__ void __launch_bounds__(resolve::kThreads)
token_spans_kernel(Chains ch, Scratch sc, int64_t n_slots,
                   resolve::Seg seg, Placed* longs, int32_t* n_long,
                   int64_t long_cap) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t base = (blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) +
                       (threadIdx.x >> 5)) * 32;
       base < n_slots; base += warps * 32) {
    const int64_t j = base + lane;
    bool v = false;
    Placed p{0, 0, 0, 0, 0, 0, 0, 1};
    if (j < n_slots) {
      const int64_t r = sc.row_of(j, ch.n_rows);
      const int64_t rb = sc.row_base[r];
      const int64_t k = j - sc.slot0[r];
      if (rb >= 0 && k < sc.nspans[r]) {
        const uint4 sp = sc.spans[j];
        const Comp c = ch.row(r);
        p.g0 = rb + sp.x;
        p.lit = sp.z;
        p.tot = p.lit + sp.w;
        p.wi0 = (c.p - ch.comp) + sp.y;
        p.wend = (c.p - ch.comp) + c.len;
        p.o0 = sc.row_o0[r];
        p.period = max(static_cast<uint32_t>(sc.offs[j]), 1u);
        p.from = p.g0 + p.lit - p.period;   // parent of match byte 0
        v = p.tot > 0 && p.g0 < seg.s1 && p.g0 + p.tot > seg.s0;
      }
    }
    unsigned mask = __ballot_sync(kFull, v);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      Placed q;
      q.g0 = __shfl_sync(kFull, p.g0, src);
      q.tot = __shfl_sync(kFull, p.tot, src);
      q.lit = __shfl_sync(kFull, p.lit, src);
      q.wi0 = __shfl_sync(kFull, p.wi0, src);
      q.wend = __shfl_sync(kFull, p.wend, src);
      q.o0 = __shfl_sync(kFull, p.o0, src);
      q.from = __shfl_sync(kFull, p.from, src);
      q.period = __shfl_sync(kFull, p.period, src);
      // only the span's bytes inside the segment
      const int64_t i0 = max64(seg.s0 - q.g0, 0);
      const int64_t i1 = min64(q.tot, seg.s1 - q.g0);
      if (i1 - i0 > kLong) {
        int idx = 0;
        if (lane == 0) idx = atomicAdd(n_long, 1);
        idx = __shfl_sync(kFull, idx, 0);
        if (idx < long_cap) {
          if (lane == 0) longs[idx] = q;
          continue;
        }
      }
      span_bytes(ch.comp, seg, q, i0, i1, lane, kLanes);
    }
  }
}

// Stage B for the long list: chunk c of entry e goes to CTA (e + c) mod
// the grid, so the whole card shares every long span.
__global__ void __launch_bounds__(resolve::kThreads)
token_long_kernel(Chains ch, resolve::Seg seg,
                  const Placed* __restrict__ longs,
                  const int32_t* __restrict__ n_long, int64_t long_cap) {
  const int64_t n = min64(*n_long, long_cap);
  const int64_t grid = gridDim.x;
  for (int64_t e = 0; e < n; ++e) {
    const Placed q = longs[e];
    const int64_t i0 = max64(seg.s0 - q.g0, 0);
    const int64_t i1 = min64(q.tot, seg.s1 - q.g0);
    const int64_t chunks = (i1 - i0 + kChunk - 1) / kChunk;
    for (int64_t c = (blockIdx.x - e % grid + grid) % grid; c < chunks;
         c += grid) {
      const int64_t a = i0 + c * kChunk;
      span_bytes(ch.comp, seg, q, a, min64(a + kChunk, i1), threadIdx.x,
                 blockDim.x);
    }
  }
}

Chains chains_of(const void* comp, int64_t comp_total, const void* comp_off,
                 const void* stored, int64_t n_rows, const void* row_off,
                 int64_t n_chains, const void* out_off, int64_t out_total,
                 int64_t block_size) {
  return Chains{static_cast<const uint8_t*>(comp), comp_total,
                static_cast<const int64_t*>(comp_off),
                static_cast<const uint8_t*>(stored), n_rows,
                static_cast<const int64_t*>(row_off), n_chains,
                static_cast<const int64_t*>(out_off), out_total, block_size};
}

}  // namespace

// Independent blocks: comp u8[nb, row_w] (row b's stream is its first
// lens[b] bytes, the rest read as zeros), row_w < 2**23; lens i64[nb];
// hist u8[65536] right-aligned history shared by every block, or null for
// none; out u8[nb, block_size], block_size <= 2**24; out_lens i64[nb].
// Scratch: lists u32[nb, 32, list_w] with list_w >= ceil(ceil(row_w / 32)
// / 3), starts and mlens u32[nb, starts_w] with starts_w >= ceil(row_w /
// 3), meta u32[nb, 67]; stats i32[nb, 4] (sequences, sequences the stitch
// walked again, matches whose source reaches into their group, serial
// route) or null. Queues the five stages, one CTA per block each, on
// *stream*; does not synchronise; returns cudaGetLastError().
extern "C" int lz4t_token_decode(const void* comp, int64_t nb, int64_t row_w,
                                 const void* lens, const void* hist,
                                 int64_t block_size, void* out,
                                 void* out_lens, void* lists, int64_t list_w,
                                 void* starts, int64_t starts_w, void* mlens,
                                 void* meta, void* stats, void* stream) {
  if (nb <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Blocks bk{static_cast<const uint8_t*>(comp), row_w,
                  static_cast<const int64_t*>(lens),
                  static_cast<const uint8_t*>(hist), block_size,
                  static_cast<uint8_t*>(out), static_cast<int64_t*>(out_lens),
                  static_cast<uint32_t*>(lists), list_w,
                  static_cast<uint32_t*>(starts), starts_w,
                  static_cast<uint32_t*>(meta), static_cast<int32_t*>(stats)};
  const unsigned grid = static_cast<unsigned>(nb);
  uint32_t* ml = static_cast<uint32_t*>(mlens);
  token_split_kernel<<<grid, kLanes, 0, st>>>(bk);
  token_stitch_kernel<<<grid, kLanes, 0, st>>>(bk);
  token_heads_kernel<<<grid, kHeadThreads, 0, st>>>(bk, ml);
  token_matches_kernel<<<grid, kLanes, 0, st>>>(bk, ml);
  token_serial_kernel<<<grid, kLanes, 0, st>>>(bk);
  return static_cast<int>(cudaGetLastError());
}

// Chains of dependent rows, first step: comp u8[comp_total], row r's wire
// bytes comp[comp_off[r]:comp_off[r+1]] (comp_off i64[n_rows + 1]);
// stored u8[n_rows] flags; chain c owns rows row_off[c]..row_off[c+1] and
// output out[out_off[c]:out_off[c+1]] (row_off, out_off i64[n_chains +
// 1], read as their running maxima). Fills rows i64[5 * n_rows + 2 *
// n_chains + 3] with each row's span slots, whose total, rows[n_rows],
// sizes lz4t_token_decode_linked's span scratch, and the chains' clamped
// offsets. One CTA on *stream*; does not synchronise; returns
// cudaGetLastError().
extern "C" int lz4t_token_slots(const void* comp, int64_t comp_total,
                                const void* comp_off, const void* stored,
                                int64_t n_rows, const void* row_off,
                                int64_t n_chains, const void* out_off,
                                int64_t out_total, void* rows, void* stream) {
  const Chains ch = chains_of(comp, comp_total, comp_off, stored, n_rows,
                              row_off, n_chains, out_off, out_total, 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  token_rows_kernel<<<1, kScanThreads, 0, st>>>(
      ch, scratch_of(rows, n_rows, n_chains, nullptr, nullptr));
  return static_cast<int>(cudaGetLastError());
}

// Chains of dependent rows, the decode, after lz4t_token_slots on the same
// inputs and rows: seed u8[65536] the window every chain starts from, or
// null for zeros; out u8[out_total]; out_lens i64[n_rows], zeroed;
// block_size < 2**31. Every byte of out is written. Scratch: spans
// u32[n_slots, 4] and offs u16[n_slots] (n_slots = rows[n_rows]), code
// i32[seg_len], flags i32[ceil(out_total / seg_len) * rounds] zeroed,
// longs 64 B x long_cap (the long list of one segment at a time), n_long
// i32[ceil(out_total / seg_len)] zeroed. Queues the rest of stage A, then
// stages B-D segment by segment, on *stream*; does not synchronise;
// returns cudaGetLastError().
extern "C" int lz4t_token_decode_linked(
    const void* comp, int64_t comp_total, const void* comp_off,
    const void* stored, int64_t n_rows, const void* row_off,
    int64_t n_chains, const void* out_off, int64_t out_total,
    const void* seed, int64_t block_size, void* out, void* out_lens,
    void* rows, void* spans, void* offs, int64_t n_slots, void* code,
    int64_t seg_len, void* flags, int rounds, void* longs, void* n_long,
    int64_t long_cap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Chains ch = chains_of(comp, comp_total, comp_off, stored, n_rows,
                              row_off, n_chains, out_off, out_total,
                              block_size);
  const Scratch sc = scratch_of(rows, n_rows, n_chains, spans, offs);
  uint8_t* o = static_cast<uint8_t*>(out);
  int32_t* cd = static_cast<int32_t*>(code);
  const uint8_t* sd = static_cast<const uint8_t*>(seed);
  if (n_rows > 0)
    token_parse_kernel<<<static_cast<unsigned>(
                             (n_rows + kParseWarps - 1) / kParseWarps),
                         kParseWarps * kLanes, 0, st>>>(ch, sc);
  if (n_chains > 0)
    token_fix_kernel<<<static_cast<unsigned>(n_chains), kLanes, 0, st>>>(
        ch, sc, static_cast<int64_t*>(out_lens));
  int32_t* rflags = static_cast<int32_t*>(flags);
  Placed* lg = static_cast<Placed*>(longs);
  int32_t* nl = static_cast<int32_t*>(n_long);
  for (int64_t s0 = 0; s0 < out_total;
       s0 += seg_len, rflags += rounds, ++nl) {
    const int64_t n = min64(seg_len, out_total - s0);
    const resolve::Seg seg{o, cd, s0, s0 + n, sd, 0};
    resolve::init_kernel<<<resolve::blocks_for(n), resolve::kThreads, 0,
                           st>>>(o, cd, s0, n);
    if (n_slots > 0) {
      token_spans_kernel<<<resolve::blocks_for(n_slots), resolve::kThreads,
                           0, st>>>(ch, sc, n_slots, seg, lg, nl, long_cap);
      token_long_kernel<<<resolve::kMaxBlocks, resolve::kThreads, 0, st>>>(
          ch, seg, lg, nl, long_cap);
    }
    resolve::resolve_segment(o, cd, s0, n, rflags, rounds, st);
  }
  return static_cast<int>(cudaGetLastError());
}
