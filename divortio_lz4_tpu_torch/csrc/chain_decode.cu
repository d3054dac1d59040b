// Chain and wide-block LZ4 record decode for Hopper (sm_90a), plain C entry
// points.
//
// Replaces two TPU kernels that run the same record body:
//   lz4t_chain_decode  _make_wave_kernel (divortio_lz4_tpu/ops/
//                      wave_decode.py:60, launched by decode_chain_waves at
//                      :245): linked frames and independent 1-4 MB blocks.
//   lz4t_wire_decode   _make_wire_kernel (divortio_lz4_tpu/ops/
//                      pallas_split_decode.py:565, launched by
//                      decode_blocks_wire at :1160): independent 256 KB
//                      blocks.
// The host parser has already cut every LZ4 sequence into records of at
// most 128 output bytes: (src, off | ll<<16 | ml<<24, dst). A record
// writes, at output position dst, ll literal bytes read from the
// compressed image at src, then ml match bytes read from the output at
// dst + ll - off.
//
// A CHAIN is a dependent run of records with its own compressed image,
// output region and 64 KB seed window (dictionary or zeros): the whole body
// of a linked frame, or one independent block. Addresses are the chain's
// io space [64 KB seed | output]; matches reach back into the seed window
// and the chain's own earlier output only.
//
// The record body, do_record: 128 threads, one per byte of a record's
// span; every thread reads its byte, the CTA meets at a barrier, every
// thread writes its byte, and the CTA meets again: the TPU kernels'
// read-all-then-write order (wave_decode.py:134-145,
// pallas_split_decode.py:630-648). Every TPU clamp is kept (tot, off >= 1,
// msrc >= 0, dst and src clipped to the chain), so hostile records stay
// inside their own chain. chain_decode_kernel walks a chain with it.
//
// Neither entry walks a chain in order: a linked frame is one chain, and
// one CTA walking 2.7M records of a 64 MiB frame left 131 of the 132 SMs
// idle (0.24 us a record, two barriers and a read-back each); one CTA
// walking each 256 KB block of the 64 MiB corpus took 8.3 ms. Both
// resolve the matches in parallel instead (span_resolve.cuh), over one
// set of kernels that read either record form (Batch):
//   A. chain_conform_kernel, one thread per record, applies do_record's
//      clamps and clears a chain's flag unless (a) every record starts at
//      or after the end of the one before it and (b) its match source ends
//      at or before its own start (msrc + tot - ll <= dst). Then every byte
//      is written once and every match reads final bytes, so the parallel
//      result is the serial order's. The host parser's chains always
//      conform (records tile the chain; a record's match never reaches
//      into itself, csrc/host_kernels.cpp lz4t_parse_records2).
//   B. chain_spans_kernel, one warp per 32 records, writes each conforming
//      record's literal bytes into the output and its match bytes' parents
//      (msrc + i) into the codes;
//   C, D. pointer doubling and gather (span_resolve.cuh).
// lz4t_wire_decode runs the same stages on the padded form, every block a
// chain with its own history row as its seed window, after
// wire_dst_kernel, one CTA a block, gives each record its dst: the
// running sum of ll + ml over the block (the serial walk's own sum).
// A chain that does not conform can only hold random words: it decodes
// with the serial walk (chain_decode_kernel, one CTA per chain, launched
// last over every chain; a conforming chain's CTA returns at once). So do
// all chains when the chains' records or outputs overlap.
//
// What bounds it on this card: the pointer-doubling rounds, each a stream
// of the segment's codes plus a dependent read per unresolved byte. On the
// 64 MiB default frame (2.72M records; NVIDIA H100 80GB HBM3, 700 W;
// profiled stages): 3.65 ms, of which 10 working rounds 2.65 ms, spans
// 0.42, gather 0.20, init 0.11, conform 0.02. On the 64 MiB corpus's 256
// blocks of 256 KB (2.68M records; chip_decode_steps.py): 3.41-3.48 ms
// (the serial walk per block: 8.28-8.35), of which 11 rounds 2.48,
// spans 0.48, gather 0.22, init 0.11, dst scan 0.05, conform 0.04 (the
// 256 KB blocks cut no round off the linked frame's 10-11). For a
// non-conforming chain, the dependent latency of each record on one SM
// (~0.24 us a record). ptxas (sm_90a), no spills: chain_spans_kernel 58
// registers, chain_conform_kernel 31, chain_check_kernel 30,
// chain_decode_kernel 32 (6 KB smem), wire_dst_kernel 32 (256 B smem);
// span_resolve.cuh's round_kernel 18, gather_kernel 28, init_kernel 28.

#include <cuda_runtime.h>
#include <stdint.h>

#include "span_resolve.cuh"

namespace {

constexpr int kThreads = 128;     // one thread per byte of a record's span
constexpr int kSpan = 128;        // output bytes one record covers at most
constexpr int64_t kWin = 65536;   // seed window ahead of a chain's output
constexpr int kRecChunk = 512;    // records staged in shared memory per pass
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Chain {
  const uint8_t* wire;  // compressed image (read-only)
  int64_t wire_len;
  const uint8_t* seed;  // kWin bytes, or null for zeros
  uint8_t* out;         // output region [0, cap)
  int64_t cap;
};

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

// Byte p of the chain's io space [seed | output].
__device__ __forceinline__ uint8_t io_at(const Chain& c, int64_t p) {
  if (p >= kWin) return c.out[p - kWin];
  return c.seed != nullptr ? __ldg(c.seed + p) : 0;
}

__device__ void zero_out(const Chain& c, int t) {
  uint8_t* o = c.out;
  const int64_t misalign = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(o) & 15);
  const int64_t head = min64(c.cap, (16 - misalign) & 15);
  const int64_t body_end = head + ((c.cap - head) & ~int64_t{15});
  for (int64_t i = t; i < head; i += kThreads) o[i] = 0;
  for (int64_t i = head + 16 * t; i < body_end; i += 16 * kThreads)
    *reinterpret_cast<uint4*>(o + i) = make_uint4(0, 0, 0, 0);
  for (int64_t i = body_end + t; i < c.cap; i += kThreads) o[i] = 0;
}

// One record with every TPU clamp applied, in io positions: tot bytes at
// dst, the first ll from the image at s, the rest from msrc on.
struct Rec {
  int64_t dst;
  int64_t msrc;
  int64_t s;
  int tot;
  int ll;
};

__device__ __forceinline__ Rec clamp_record(uint32_t src, uint32_t w1,
                                            int64_t dst_raw, int64_t cap,
                                            int64_t wire_len) {
  Rec r;
  const int off = max(static_cast<int>(w1 & 0xFFFF), 1);
  const int ll = (w1 >> 16) & 0xFF;
  const int ml = w1 >> 24;
  r.dst = min64(dst_raw, cap) + kWin;
  r.tot = static_cast<int>(min64(ll + ml, min64(kSpan, kWin + cap - r.dst)));
  r.ll = min(ll, r.tot);
  r.msrc = max64(r.dst + r.ll - off, 0);
  r.s = max64(min64(src, wire_len - kSpan), 0);
  return r;
}

// The record body both walks share. dst_raw is the record's output
// position in the chain; every thread of the CTA calls it.
__device__ __forceinline__ void do_record(const Chain& c, uint32_t src,
                                          uint32_t w1, int64_t dst_raw,
                                          int t) {
  const Rec r = clamp_record(src, w1, dst_raw, c.cap, c.wire_len);
  uint8_t v = 0;
  if (t < r.tot) {
    if (t < r.ll)
      v = r.s + t < c.wire_len ? __ldg(c.wire + r.s + t) : 0;
    else
      v = io_at(c, r.msrc + t - r.ll);
  }
  __syncthreads();
  if (t < r.tot) c.out[r.dst - kWin + t] = v;
  __syncthreads();
}

// Chain ci's offsets clamped into the buffers, as every kernel here clamps
// them, so no offset reaches outside wire, recs or out.
struct Bounds {
  int64_t w0, wlen, r0, r1, o0, cap;
};

// The records of a batch, in one of two forms that every kernel here
// reads through bounds(), chain_of() and word():
//   chain form (rec_off set): chain c owns wire[wire_off[c]:wire_off[c+1]],
//     records [rec_off[c], rec_off[c+1]) of 3 words (src, w1, dst) and
//     out[out_off[c]:out_off[c+1]];
//   padded form (rec_off null, lz4t_wire_decode): chain c is block c, with
//     wire row c of wire_cap bytes, record slots [c * cap, c * cap +
//     counts[c]) of 2 words (src, w1), dst[r] from wire_dst_kernel's scan,
//     and output row c of block_size bytes.
struct Batch {
  const uint8_t* wire;
  int64_t wire_total;
  const uint32_t* recs;
  int64_t n_rec;          // records (chain form) or record slots (padded)
  int64_t n_chains;
  int64_t out_total;
  const int64_t* wire_off;
  const int64_t* rec_off;
  const int64_t* out_off;
  int64_t wire_cap, cap, block_size;
  const int32_t* counts;
  uint32_t* dst;

  __device__ __forceinline__ bool padded() const { return rec_off == nullptr; }

  __device__ __forceinline__ Bounds bounds(int64_t ci) const {
    Bounds b;
    if (padded()) {
      b.w0 = ci * wire_cap;
      b.wlen = wire_cap;
      b.r0 = ci * cap;
      b.r1 = b.r0 + clamp64(counts[ci], 0, cap);
      b.o0 = ci * block_size;
      b.cap = block_size;
      return b;
    }
    b.w0 = clamp64(wire_off[ci], 0, wire_total);
    b.wlen = clamp64(wire_off[ci + 1], b.w0, wire_total) - b.w0;
    b.r0 = clamp64(rec_off[ci], 0, n_rec);
    b.r1 = clamp64(rec_off[ci + 1], b.r0, n_rec);
    b.o0 = clamp64(out_off[ci], 0, out_total);
    b.cap = clamp64(out_off[ci + 1], b.o0, out_total) - b.o0;
    return b;
  }

  // The chain of record (slot) r: in the chain form the last chain whose
  // first record is at or before r (the chains lie in order:
  // chain_check_kernel).
  __device__ __forceinline__ int64_t chain_of(int64_t r) const {
    if (padded()) return r / cap;
    int64_t lo = 0, hi = n_chains - 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi + 1) >> 1;
      if (clamp64(rec_off[mid], 0, n_rec) <= r)
        lo = mid;
      else
        hi = mid - 1;
    }
    return lo;
  }

  // Word k (0 src, 1 w1, 2 dst) of record r.
  __device__ __forceinline__ uint32_t word(int64_t r, int k) const {
    if (padded()) return k < 2 ? recs[2 * r + k] : dst[r];
    return recs[3 * r + k];
  }

  __device__ __forceinline__ Rec record(int64_t r, const Bounds& b) const {
    return clamp_record(word(r, 0), word(r, 1), word(r, 2), b.cap, b.wlen);
  }
};

// The padded form's dst: block b's running sum of ll + ml over its
// records (the cumsum of _expand_wire_records,
// pallas_split_decode.py:557-561), one CTA a block. A dst past block_size
// is stored as block_size, which clamp_record reads alike, so the sum
// never wraps its u32.
__global__ void __launch_bounds__(resolve::kScanThreads)
wire_dst_kernel(Batch bt) {
  const Bounds b = bt.bounds(blockIdx.x);
  int64_t base = 0, total;
  for (int64_t r0 = b.r0; r0 < b.r1; r0 += resolve::kScanThreads) {
    const int64_t r = r0 + threadIdx.x;
    int64_t n = 0;
    if (r < b.r1) {
      const uint32_t w1 = bt.recs[2 * r + 1];
      n = ((w1 >> 16) & 0xFF) + (w1 >> 24);
    }
    const int64_t inc = resolve::cta_scan<false>(n, &total);
    if (r < b.r1)
      bt.dst[r] = static_cast<uint32_t>(min64(base + inc - n, bt.block_size));
    base += total;
  }
}

// flags[0] = 1 when a chain's records or output start before the end of
// the chain before it: every chain then decodes serially (chain form).
__global__ void __launch_bounds__(resolve::kThreads)
chain_check_kernel(Batch bt, int32_t* flags) {
  for (int64_t ci = 1 + blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
       ci < bt.n_chains; ci += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const Bounds a = bt.bounds(ci - 1), b = bt.bounds(ci);
    if (b.r0 < a.r1 || b.o0 < a.o0 + a.cap) flags[0] = 1;
  }
}

// Stage A: flags[1 + c] = 1 when chain c does not conform.
__global__ void __launch_bounds__(resolve::kThreads)
chain_conform_kernel(Batch bt, int32_t* flags) {
  if (flags[0]) return;
  for (int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       r < bt.n_rec; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t c = bt.chain_of(r);
    const Bounds b = bt.bounds(c);
    if (r < b.r0 || r >= b.r1) continue;
    const Rec a = bt.record(r, b);
    bool ok = a.tot == a.ll || a.msrc + (a.tot - a.ll) <= a.dst;
    if (r > b.r0) {
      const Rec p = bt.record(r - 1, b);
      ok = ok && a.dst >= p.dst + p.tot;
    }
    if (!ok) flags[1 + c] = 1;
  }
}

// Stage B over one segment: a warp takes 32 records, then writes each
// conforming record's bytes that fall in the segment, 32 at a time.
__global__ void __launch_bounds__(resolve::kThreads)
chain_spans_kernel(Batch bt, const int32_t* __restrict__ flags,
                   resolve::Seg seg) {
  if (flags[0]) return;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t base = (blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) +
                       (threadIdx.x >> 5)) * 32;
       base < bt.n_rec; base += warps * 32) {
    const int64_t r = base + lane;
    bool v = false;
    int64_t g0 = 0, gs0 = 0, o0 = 0, wi0 = 0, wend = 0;
    unsigned long long seed = 0;
    int tot = 0, ll = 0;
    if (r < bt.n_rec) {
      const int64_t c = bt.chain_of(r);
      const Bounds b = bt.bounds(c);
      if (r >= b.r0 && r < b.r1 && !flags[1 + c]) {
        const Rec a = bt.record(r, b);
        o0 = b.o0;
        g0 = b.o0 + a.dst - kWin;
        gs0 = b.o0 + a.msrc - kWin;
        wi0 = b.w0 + a.s;
        wend = b.w0 + b.wlen;
        seed = reinterpret_cast<unsigned long long>(
            resolve::seed_of(seg, c));
        tot = a.tot;
        ll = a.ll;
        v = tot > 0 && g0 < seg.s1 && g0 + tot > seg.s0;
      }
    }
    unsigned mask = __ballot_sync(kFull, v);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const int64_t sg0 = __shfl_sync(kFull, g0, src);
      const int64_t sgs0 = __shfl_sync(kFull, gs0, src);
      const int64_t so0 = __shfl_sync(kFull, o0, src);
      const int64_t swi0 = __shfl_sync(kFull, wi0, src);
      const int64_t swend = __shfl_sync(kFull, wend, src);
      const uint8_t* sseed =
          reinterpret_cast<const uint8_t*>(__shfl_sync(kFull, seed, src));
      const int stot = __shfl_sync(kFull, tot, src);
      const int sll = __shfl_sync(kFull, ll, src);
      for (int i = lane; i < stot; i += 32) {
        const int64_t g = sg0 + i;
        if (!resolve::inside(seg, g)) continue;
        if (i < sll) {
          const int64_t wi = swi0 + i;
          seg.out[g] = wi < swend ? __ldg(bt.wire + wi) : 0;
        } else {
          resolve::take(seg, g, so0, sgs0 + (i - sll), sseed);
        }
      }
    }
  }
}

// The serial walk, for the chains stage A routed here (flags[1 + ci]) or
// every chain (flags[0]); other CTAs return at once.
__global__ void __launch_bounds__(kThreads)
chain_decode_kernel(Batch bt, const uint8_t* __restrict__ seed,
                    int64_t seed_stride, uint8_t* out,
                    const int32_t* __restrict__ flags) {
  __shared__ uint32_t srec[3 * kRecChunk];
  const int64_t ci = blockIdx.x;
  const int t = threadIdx.x;
  if (!flags[0] && !flags[1 + ci]) return;
  const Bounds b = bt.bounds(ci);
  Chain c;
  c.wire = bt.wire + b.w0;
  c.wire_len = b.wlen;
  c.seed = seed != nullptr ? seed + ci * seed_stride : nullptr;
  c.out = out + b.o0;
  c.cap = b.cap;
  zero_out(c, t);

  for (int64_t c0 = b.r0; c0 < b.r1; c0 += kRecChunk) {
    const int n = static_cast<int>(min64(b.r1 - c0, kRecChunk));
    __syncthreads();  // the zeroing, or the previous chunk, is done
    for (int i = t; i < 3 * n; i += kThreads)
      srec[i] = bt.word(c0 + i / 3, i % 3);
    __syncthreads();
    for (int k = 0; k < n; ++k)
      do_record(c, srec[3 * k], srec[3 * k + 1], srec[3 * k + 2], t);
  }
}

// Stages A-D segment by segment, then the serial walk, for either form.
int queue_stages(const Batch& bt, const uint8_t* seed, int64_t seed_stride,
                 uint8_t* out, int32_t* code, int64_t seg_len, int32_t* f,
                 int rounds, cudaStream_t st) {
  if (bt.n_rec > 0)
    chain_conform_kernel<<<resolve::blocks_for(bt.n_rec), resolve::kThreads,
                           0, st>>>(bt, f);
  int32_t* rflags = f + 1 + bt.n_chains;
  for (int64_t s0 = 0; s0 < bt.out_total; s0 += seg_len, rflags += rounds) {
    const int64_t n = min64(seg_len, bt.out_total - s0);
    const resolve::Seg seg{out, code, s0, s0 + n, seed, seed_stride};
    resolve::init_kernel<<<resolve::blocks_for(n), resolve::kThreads, 0,
                           st>>>(out, code, s0, n);
    if (bt.n_rec > 0)
      chain_spans_kernel<<<resolve::blocks_for(bt.n_rec),
                           resolve::kThreads, 0, st>>>(bt, f, seg);
    resolve::resolve_segment(out, code, s0, n, rflags, rounds, st);
  }
  chain_decode_kernel<<<static_cast<unsigned>(bt.n_chains), kThreads, 0,
                        st>>>(bt, seed, seed_stride, out, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Chains: wire u8[wire_total]; wire_off, rec_off, out_off i64[nc + 1]
// (chain c owns wire[wire_off[c]:wire_off[c+1]], records
// recs[rec_off[c]:rec_off[c+1]] and out[out_off[c]:out_off[c+1]]); recs
// u32[n_rec, 3]; out u8[out_total], every byte written; seed u8[65536]
// shared by every chain, or null for zeros. Scratch: code i32[seg_len];
// flags i32[1 + nc + ceil(out_total / seg_len) * rounds], zeroed (layout
// in ops/resolve.py, ResolveRun). Queues stages A-D segment by segment,
// then the serial walk, on *stream*; does not synchronise; returns
// cudaGetLastError().
extern "C" int lz4t_chain_decode(const void* wire, int64_t wire_total,
                                 const void* wire_off, const void* recs,
                                 int64_t n_rec, const void* rec_off,
                                 const void* out_off, int64_t n_chains,
                                 const void* seed, void* out,
                                 int64_t out_total, void* code,
                                 int64_t seg_len, void* flags, int rounds,
                                 void* stream) {
  if (n_chains <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Batch bt{};
  bt.wire = static_cast<const uint8_t*>(wire);
  bt.wire_total = wire_total;
  bt.recs = static_cast<const uint32_t*>(recs);
  bt.n_rec = n_rec;
  bt.n_chains = n_chains;
  bt.out_total = out_total;
  bt.wire_off = static_cast<const int64_t*>(wire_off);
  bt.rec_off = static_cast<const int64_t*>(rec_off);
  bt.out_off = static_cast<const int64_t*>(out_off);
  int32_t* f = static_cast<int32_t*>(flags);
  chain_check_kernel<<<resolve::blocks_for(n_chains), resolve::kThreads, 0,
                       st>>>(bt, f);
  return queue_stages(bt, static_cast<const uint8_t*>(seed), 0,
                      static_cast<uint8_t*>(out), static_cast<int32_t*>(code),
                      seg_len, f, rounds, st);
}

// Padded blocks: wire u8[nb, wire_cap]; recs u32[nb, cap, 2], block b's
// first counts[b] rows are its records (src, off | ll<<16 | ml<<24);
// counts i32[nb]; hist u8[nb, 65536] (block b's seed window) or null for
// zeros; out u8[nb, block_size], block_size < 2**31, every byte written.
// Scratch: dst u32[nb, cap]; code i32[seg_len]; flags i32[1 + nb +
// ceil(nb * block_size / seg_len) * rounds], zeroed. Queues the dst scan,
// then stages A-D and the serial walk as lz4t_chain_decode does, on
// *stream*; does not synchronise; returns cudaGetLastError().
extern "C" int lz4t_wire_decode(const void* wire, int64_t nb,
                                int64_t wire_cap, const void* recs,
                                int64_t cap, const void* counts,
                                const void* hist, int64_t block_size,
                                void* out, void* dst, void* code,
                                int64_t seg_len, void* flags, int rounds,
                                void* stream) {
  if (nb <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Batch bt{};
  bt.wire = static_cast<const uint8_t*>(wire);
  bt.wire_total = nb * wire_cap;
  bt.recs = static_cast<const uint32_t*>(recs);
  bt.n_rec = nb * cap;
  bt.n_chains = nb;
  bt.out_total = nb * block_size;
  bt.wire_cap = wire_cap;
  bt.cap = cap;
  bt.block_size = block_size;
  bt.counts = static_cast<const int32_t*>(counts);
  bt.dst = static_cast<uint32_t*>(dst);
  if (cap > 0)
    wire_dst_kernel<<<static_cast<unsigned>(nb), resolve::kScanThreads, 0,
                      st>>>(bt);
  return queue_stages(bt, static_cast<const uint8_t*>(hist), kWin,
                      static_cast<uint8_t*>(out), static_cast<int32_t*>(code),
                      seg_len, static_cast<int32_t*>(flags), rounds, st);
}
