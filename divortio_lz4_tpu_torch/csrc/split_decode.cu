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
// Design: one warp per block, kWarps blocks per CTA, the row in global
// memory (a 256 KB block with its 64 KB history passes the 227 KB
// shared-memory limit). Each lane holds 4 of a record's at most 128 bytes;
// __syncwarp() separates the record's reads from its writes, and its writes
// from the next record's reads.
//
// What bounds it on this card: the serial record chain of each block, one
// dependent read and write per record, not bytes; blocks run in parallel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;
constexpr int kPerLane = 4;          // kLanes * kPerLane = 128-byte records
constexpr int64_t kSpan = kLanes * kPerLane;

__device__ __forceinline__ int64_t clip64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// dst[0, n) = src[0, n), the warp's lanes together (16 bytes a lane where
// both rows are 16-byte aligned).
__device__ void copy_row(uint8_t* dst, const uint8_t* src, int64_t n,
                         int lane) {
  int64_t i = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src))
       & 15) == 0) {
    const int64_t body = n & ~int64_t{15};
    for (int64_t j = 16 * lane; j < body; j += 16 * kLanes)
      *reinterpret_cast<uint4*>(dst + j) =
          __ldg(reinterpret_cast<const uint4*>(src + j));
    i = body;
  }
  for (int64_t j = i + lane; j < n; j += kLanes) dst[j] = __ldg(src + j);
}

__global__ void __launch_bounds__(kLanes * kWarps)
split_decode_kernel(const uint8_t* __restrict__ lit, int64_t nb,
                    int64_t io_w, const int32_t* __restrict__ recs,
                    int64_t cap, const int32_t* __restrict__ counts,
                    int64_t out_base, int64_t out_cap,
                    uint8_t* __restrict__ out) {
  const int lane = threadIdx.x % kLanes;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps +
                    threadIdx.x / kLanes;
  if (b >= nb) return;  // the whole warp leaves together
  const uint8_t* image = lit + b * io_w;
  uint8_t* row = out + b * out_cap;
  copy_row(row, image + out_base, out_cap, lane);
  __syncwarp();

  const int32_t* r = recs + b * cap * 2;
  const int64_t n = clip64(counts[b], 0, cap);
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

}  // namespace

// lit u8[nb, io_w] (literal images, io_w >= out_base + out_cap); recs
// i32[nb, cap, 2]; counts i32[nb] (records run per block, clipped to
// [0, cap]); out u8[nb, out_cap]. One warp per block on *stream*; does not
// synchronise; returns cudaGetLastError().
extern "C" int lz4t_split_decode(const void* lit, int64_t nb, int64_t io_w,
                                 const void* recs, int64_t cap,
                                 const void* counts, int64_t out_base,
                                 int64_t out_cap, void* out, void* stream) {
  if (nb <= 0) return 0;
  const int64_t grid = (nb + kWarps - 1) / kWarps;
  split_decode_kernel<<<static_cast<unsigned>(grid), kLanes * kWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lit), nb, io_w,
      static_cast<const int32_t*>(recs), cap,
      static_cast<const int32_t*>(counts), out_base, out_cap,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
