// Compact-record LZ4 block decode for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel _make_wire_kernel_compact
// (divortio_lz4_tpu/ops/pallas_split_decode.py:689, launched by
// decode_blocks_wire_compact at :868). The host parser has already cut
// every LZ4 sequence into records of at most 128 output bytes. Record
// (w0, w1) = (src | ll<<16 | ml<<24, dst | off<<16) writes, at output
// position dst, ll literal bytes read from the block's compressed bytes at
// src, then ml match bytes read from the output at dst + ll - off.
//
// Design: one CTA per LZ4 block, 128 threads, one thread per byte of a
// record. The block's io row [64 KB history (dictionary only) |
// block_size] lives in shared memory, and the block's records are staged
// into shared memory kRecChunk at a time with coalesced loads. Per record,
// every thread reads its byte into a register, the CTA meets at a barrier,
// every thread writes its byte, and the CTA meets again. That is the TPU
// kernel's read-all-then-write order (:740-751), so hostile records that
// overlap themselves still decode deterministically. All of the TPU
// kernel's clamps are kept (:731-736, and dst = min(dst, out_cap) +
// out_base at :761), so garbage records stay inside their own row: a wild
// write here would silently corrupt a neighbouring block. Unlike the TPU
// kernel there is no wild store past a record's end. Output bytes past a
// block's out_len are written as zeros.
//
// What bounds it on this card: not bytes. A 64 KB block moves 64 KB out,
// its compressed bytes in and 8 B per record, a few hundred MB per
// 64 MiB frame against 3.35 TB/s. Each record instead costs two
// block-wide barriers and a dependent shared-memory round trip, and the
// densest blocks carry ~8K records. Throughput comes from CTAs in flight:
// the 68 KB footprint without a dictionary fits 3 CTAs per SM, the 132 KB
// footprint with one fits 1. Staging the wire bytes in shared memory, a
// warp per record without block barriers, and several blocks per CTA are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // one thread per byte of a record's span
constexpr int kSpan = 128;      // output bytes one record covers at most
constexpr int kHist = 65536;    // dictionary window ahead of the payload
constexpr int kRecChunk = 512;  // records staged in shared memory per pass

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads)
compact_decode_kernel(const uint8_t* __restrict__ wire, int64_t wire_cap,
                      const uint2* __restrict__ recs, int64_t n_rec,
                      const int64_t* __restrict__ rec_off,
                      const int64_t* __restrict__ out_lens,
                      const uint8_t* __restrict__ hist, int out_base,
                      int block_size, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint2* srec = reinterpret_cast<uint2*>(smem);
  uint8_t* io = smem + kRecChunk * sizeof(uint2);

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int bs_limit = out_base + block_size;
  const uint8_t* wrow = wire + b * wire_cap;
  // The TPU kernel reads two 128-lane rows from src: (wire_nr - 2) * 128.
  const int src_max = static_cast<int>(wire_cap) - 2 * kSpan;

  // Seed the io row: history (or zeros) below out_base, zeros above.
  for (int i = t * 16; i < bs_limit; i += kThreads * 16) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (hist != nullptr && i < out_base)
      v = *reinterpret_cast<const uint4*>(hist + b * kHist + i);
    *reinterpret_cast<uint4*>(io + i) = v;
  }

  const int64_t r0 = clamp64(rec_off[b], 0, n_rec);
  const int64_t r1 = clamp64(rec_off[b + 1], r0, n_rec);
  for (int64_t c = r0; c < r1; c += kRecChunk) {
    const int n = static_cast<int>(clamp64(r1 - c, 0, kRecChunk));
    __syncthreads();  // the seed, or the previous chunk, is done
    for (int i = t; i < n; i += kThreads) srec[i] = recs[c + i];
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

  const int olen = static_cast<int>(clamp64(out_lens[b], 0, block_size));
  uint8_t* orow = out + b * block_size;
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
// 16-byte aligned like hist). Launches on *stream*, does not synchronise,
// and returns cudaGetLastError().
extern "C" int lz4t_compact_decode(const void* wire, int64_t nb,
                                   int64_t wire_cap, const void* recs,
                                   int64_t n_rec, const void* rec_off,
                                   const void* out_lens, const void* hist,
                                   int64_t block_size, void* out,
                                   void* stream) {
  if (nb <= 0) return 0;
  const int out_base = hist != nullptr ? kHist : 0;
  const size_t smem = kRecChunk * sizeof(uint2) + out_base + block_size;
  cudaError_t err = cudaFuncSetAttribute(
      compact_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_decode_kernel<<<static_cast<unsigned>(nb), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wire), wire_cap,
      static_cast<const uint2*>(recs), n_rec,
      static_cast<const int64_t*>(rec_off),
      static_cast<const int64_t*>(out_lens),
      static_cast<const uint8_t*>(hist), out_base,
      static_cast<int>(block_size), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
