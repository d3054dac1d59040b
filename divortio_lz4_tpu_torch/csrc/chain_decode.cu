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
// Design: one CTA per chain, 128 threads, one thread per byte of a
// record's span. A chain's output (up to a whole linked frame) does not fit
// in shared memory, so it lives in device memory and matches read it back
// from there; the records are staged into shared memory kRecChunk at a
// time. Per record, every thread reads its byte, the CTA meets at a
// barrier, every thread writes its byte, and the CTA meets again: the TPU
// kernels' read-all-then-write order (wave_decode.py:134-145,
// pallas_split_decode.py:630-648), and __syncthreads() makes the global
// writes visible to the CTA before the next record reads them. Every TPU
// clamp is kept (tot, off >= 1, msrc >= 0, dst and src clipped to the
// chain), so hostile records stay inside their own chain: a wild write
// would silently corrupt a neighbouring chain. The output region is zeroed
// first, so bytes no record writes are zeros.
//
// What bounds it on this card: the dependent latency of each record (two
// CTA barriers, a device-memory read of the match source, a store), not
// bytes. A linked frame is one chain, so one SM walks all of its records;
// independent blocks decode in parallel, one CTA each. A shared-memory ring
// of the last 64 KB, a warp per record without CTA barriers, and several
// chains per CTA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // one thread per byte of a record's span
constexpr int kSpan = 128;        // output bytes one record covers at most
constexpr int64_t kWin = 65536;   // seed window ahead of a chain's output
constexpr int kRecChunk = 512;    // records staged in shared memory per pass

struct Chain {
  const uint8_t* wire;  // compressed image (read-only)
  int64_t wire_len;
  const uint8_t* seed;  // kWin bytes, or null for zeros
  uint8_t* out;         // output region [0, cap)
  int64_t cap;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
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

// The record body both kernels share. dst_raw is the record's output
// position in the chain; every thread of the CTA calls it.
__device__ __forceinline__ void do_record(const Chain& c, uint32_t src,
                                          uint32_t w1, int64_t dst_raw,
                                          int t) {
  const int off = max(static_cast<int>(w1 & 0xFFFF), 1);
  int ll = (w1 >> 16) & 0xFF;
  const int ml = w1 >> 24;
  const int64_t dst = min64(dst_raw, c.cap) + kWin;
  const int tot = static_cast<int>(
      min64(ll + ml, min64(kSpan, kWin + c.cap - dst)));
  ll = min(ll, tot);
  const int64_t msrc = max64(dst + ll - off, 0);
  const int64_t s = max64(min64(src, c.wire_len - kSpan), 0);
  uint8_t v = 0;
  if (t < tot) {
    if (t < ll)
      v = s + t < c.wire_len ? __ldg(c.wire + s + t) : 0;
    else
      v = io_at(c, msrc + t - ll);
  }
  __syncthreads();
  if (t < tot) c.out[dst - kWin + t] = v;
  __syncthreads();
}

// Chain ci's offsets are clamped into the buffers like its records, so no
// offset reaches outside wire, recs or out.
__global__ void __launch_bounds__(kThreads)
chain_decode_kernel(const uint8_t* __restrict__ wire, int64_t wire_total,
                    const int64_t* __restrict__ wire_off,
                    const uint32_t* __restrict__ recs, int64_t n_rec,
                    const int64_t* __restrict__ rec_off,
                    const int64_t* __restrict__ out_off, int64_t out_total,
                    const uint8_t* __restrict__ seed, uint8_t* out) {
  __shared__ uint32_t srec[3 * kRecChunk];
  const int64_t ci = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t w0 = clamp64(wire_off[ci], 0, wire_total);
  const int64_t o0 = clamp64(out_off[ci], 0, out_total);
  Chain c;
  c.wire = wire + w0;
  c.wire_len = clamp64(wire_off[ci + 1], w0, wire_total) - w0;
  c.seed = seed;
  c.out = out + o0;
  c.cap = clamp64(out_off[ci + 1], o0, out_total) - o0;
  zero_out(c, t);

  const int64_t r0 = clamp64(rec_off[ci], 0, n_rec);
  const int64_t r1 = clamp64(rec_off[ci + 1], r0, n_rec);
  for (int64_t c0 = r0; c0 < r1; c0 += kRecChunk) {
    const int n = static_cast<int>(min64(r1 - c0, kRecChunk));
    __syncthreads();  // the zeroing, or the previous chunk, is done
    for (int i = t; i < 3 * n; i += kThreads) srec[i] = recs[3 * c0 + i];
    __syncthreads();
    for (int k = 0; k < n; ++k)
      do_record(c, srec[3 * k], srec[3 * k + 1], srec[3 * k + 2], t);
  }
}

__global__ void __launch_bounds__(kThreads)
wire_decode_kernel(const uint8_t* __restrict__ wire, int64_t wire_cap,
                   const uint2* __restrict__ recs, int64_t cap,
                   const int32_t* __restrict__ counts,
                   const uint8_t* __restrict__ hist, int64_t block_size,
                   uint8_t* out) {
  __shared__ uint2 srec[kRecChunk];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  Chain c;
  c.wire = wire + b * wire_cap;
  c.wire_len = wire_cap;
  c.seed = hist != nullptr ? hist + b * kWin : nullptr;
  c.out = out + b * block_size;
  c.cap = block_size;
  zero_out(c, t);

  // dst is the running sum of ll+ml over the block's records: the cumsum
  // of _expand_wire_records (pallas_split_decode.py:557-561).
  const int64_t n_rec = clamp64(counts[b], 0, cap);
  const uint2* brecs = recs + b * cap;
  int64_t dst = 0;
  for (int64_t c0 = 0; c0 < n_rec; c0 += kRecChunk) {
    const int n = static_cast<int>(min64(n_rec - c0, kRecChunk));
    __syncthreads();
    for (int i = t; i < n; i += kThreads) srec[i] = brecs[c0 + i];
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const uint2 r = srec[k];
      do_record(c, r.x, r.y, dst, t);
      dst += ((r.y >> 16) & 0xFF) + (r.y >> 24);
    }
  }
}

}  // namespace

// Chains: wire u8[wire_total]; wire_off, rec_off, out_off i64[nc + 1]
// (chain c owns wire[wire_off[c]:wire_off[c+1]], records
// recs[rec_off[c]:rec_off[c+1]] and out[out_off[c]:out_off[c+1]]); recs
// u32[n_rec, 3]; out u8[out_total]; seed u8[65536] shared by every chain,
// or null for zeros. Launches one CTA per chain on *stream*, does not
// synchronise, and returns cudaGetLastError().
extern "C" int lz4t_chain_decode(const void* wire, int64_t wire_total,
                                 const void* wire_off, const void* recs,
                                 int64_t n_rec, const void* rec_off,
                                 const void* out_off, int64_t n_chains,
                                 const void* seed, void* out,
                                 int64_t out_total, void* stream) {
  if (n_chains <= 0) return 0;
  chain_decode_kernel<<<static_cast<unsigned>(n_chains), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wire), wire_total,
      static_cast<const int64_t*>(wire_off),
      static_cast<const uint32_t*>(recs), n_rec,
      static_cast<const int64_t*>(rec_off),
      static_cast<const int64_t*>(out_off), out_total,
      static_cast<const uint8_t*>(seed), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Padded blocks: wire u8[nb, wire_cap]; recs u32[nb, cap, 2] (8-byte
// aligned), block b's first counts[b] rows are its records (src, off |
// ll<<16 | ml<<24); counts i32[nb]; hist u8[nb, 65536] or null; out u8[nb,
// block_size]. One CTA per block on *stream*; returns cudaGetLastError().
extern "C" int lz4t_wire_decode(const void* wire, int64_t nb,
                                int64_t wire_cap, const void* recs,
                                int64_t cap, const void* counts,
                                const void* hist, int64_t block_size,
                                void* out, void* stream) {
  if (nb <= 0) return 0;
  wire_decode_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wire), wire_cap,
      static_cast<const uint2*>(recs), cap,
      static_cast<const int32_t*>(counts),
      static_cast<const uint8_t*>(hist), block_size,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
