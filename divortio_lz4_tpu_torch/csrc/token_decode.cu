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
// Design: one CTA of one warp per block (lz4t_token_decode) or per chain
// (lz4t_token_decode_linked). Every lane parses the same token stream in
// lockstep (broadcast loads of the compressed bytes); the warp copies a
// literal run, then a match, 32 bytes a step. A match reads only
// [o - offset, o), which is complete before it starts, so out[o + i] =
// io[o - offset + i % offset] is the exact LZ4 overlap copy for every
// offset and needs no ordering inside the match; __syncwarp() orders one
// sequence's writes before the next one's reads. Outputs live in device
// memory. The TPU's rows per grid step, packed SMEM stream copies, i32
// widening, lane rolls, pow2 M buckets and chunking exist for Mosaic and
// are not ported; a chain is one CTA with no window carried between calls.
//
// What bounds it on this card: the dependent latency of each sequence (the
// token and length reads, a barrier, match reads of output written just
// before), not bytes. Independent blocks run in parallel; a linked chain
// decodes on one SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int64_t kWin = 65536;       // history / window ahead of the output
constexpr int64_t kHalfSlack = 128;   // SLACK // 2 of the TPU kernel

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

// _interpret_block: decode c into io from o_start, never past o_limit.
// Every lane of the warp calls it; returns the final output cursor.
__device__ int64_t interpret(const Comp& c, const Io& io, int64_t o_start,
                             int64_t o_limit, int lane) {
  int64_t p = 0;
  int64_t o = o_start;
  while (p < c.len) {
    const uint32_t token = c.at(p);
    p += 1;
    int64_t lit = token >> 4;
    if (lit == 15) lit += read_ext(c, &p);
    lit = max64(min64(min64(lit, o_limit - o), c.len + kHalfSlack - p), 0);
    for (int64_t i = lane; i < lit; i += kLanes)
      io.write(o + i, static_cast<uint8_t>(c.at(p + i)));
    p += lit;
    o += lit;

    const bool valid = p < c.len;
    const int64_t offset = c.at(p) | (c.at(p + 1) << 8);
    int64_t p2 = p + 2;
    int64_t ml = token & 15;
    if (valid && ml == 15) ml += read_ext(c, &p2);
    int64_t mlen = valid ? min64(ml + 4, o_limit - o) : 0;
    if (offset < 1 || offset > o) mlen = 0;
    __syncwarp();   // the literals are visible to the match's reads
    const int64_t from = o - offset;
    const uint32_t off32 = static_cast<uint32_t>(offset > 0 ? offset : 1);
    for (int64_t i = lane; i < mlen; i += kLanes)
      io.write(o + i, io.read(from + static_cast<uint32_t>(i) % off32));
    __syncwarp();   // the match is visible to the next sequence
    if (valid) p = p2;
    o += mlen;
  }
  return o;
}

__global__ void __launch_bounds__(kLanes)
token_decode_kernel(const uint8_t* __restrict__ comp, int64_t row_w,
                    const int64_t* __restrict__ lens,
                    const uint8_t* __restrict__ hist, int64_t block_size,
                    uint8_t* out, int64_t* __restrict__ out_lens) {
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const Comp c{comp + b * row_w, clamp64(lens[b], 0, row_w)};
  const Io io{hist, hist != nullptr ? kWin : 0, out + b * block_size};
  const int64_t o = interpret(c, io, io.base, io.base + block_size, lane);
  const int64_t n = o - io.base;
  zero_fill(out + b * block_size + n, block_size - n, lane);
  if (lane == 0) out_lens[b] = n;
}

// Chain ci's offsets are clamped into the buffers, so no offset reaches
// outside comp, the row arrays or out.
__global__ void __launch_bounds__(kLanes)
token_decode_linked_kernel(const uint8_t* __restrict__ comp,
                           int64_t comp_total,
                           const int64_t* __restrict__ comp_off,
                           const uint8_t* __restrict__ stored,
                           int64_t n_rows,
                           const int64_t* __restrict__ row_off,
                           const int64_t* __restrict__ out_off,
                           int64_t out_total,
                           const uint8_t* __restrict__ seed,
                           int64_t block_size, uint8_t* out,
                           int64_t* __restrict__ out_lens) {
  const int64_t ci = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t r0 = clamp64(row_off[ci], 0, n_rows);
  const int64_t r1 = clamp64(row_off[ci + 1], r0, n_rows);
  const int64_t o0 = clamp64(out_off[ci], 0, out_total);
  const int64_t cap = clamp64(out_off[ci + 1], o0, out_total) - o0;
  const Io io{seed, kWin, out + o0};
  int64_t cursor = kWin;
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t w0 = clamp64(comp_off[r], 0, comp_total);
    const Comp c{comp + w0, clamp64(comp_off[r + 1], w0, comp_total) - w0};
    const int64_t limit = min64(cursor + block_size, kWin + cap);
    int64_t n;
    if (stored[r]) {
      // A stored row's wire bytes are the plaintext.
      n = min64(c.len, limit - cursor);
      for (int64_t i = lane; i < n; i += kLanes)
        io.write(cursor + i, static_cast<uint8_t>(c.at(i)));
      __syncwarp();
    } else {
      n = interpret(c, io, cursor, limit, lane) - cursor;
    }
    if (lane == 0) out_lens[r] = n;
    cursor += n;
  }
  zero_fill(out + o0 + (cursor - kWin), cap - (cursor - kWin), lane);
}

}  // namespace

// Independent blocks: comp u8[nb, row_w] (row b's stream is its first
// lens[b] bytes, the rest read as zeros); lens i64[nb]; hist u8[65536]
// right-aligned history shared by every block, or null for none; out
// u8[nb, block_size]; out_lens i64[nb]. One CTA per block on *stream*;
// does not synchronise; returns cudaGetLastError().
extern "C" int lz4t_token_decode(const void* comp, int64_t nb, int64_t row_w,
                                 const void* lens, const void* hist,
                                 int64_t block_size, void* out,
                                 void* out_lens, void* stream) {
  if (nb <= 0) return 0;
  token_decode_kernel<<<static_cast<unsigned>(nb), kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), row_w,
      static_cast<const int64_t*>(lens), static_cast<const uint8_t*>(hist),
      block_size, static_cast<uint8_t*>(out),
      static_cast<int64_t*>(out_lens));
  return static_cast<int>(cudaGetLastError());
}

// Chains of dependent rows: comp u8[comp_total], row r's wire bytes
// comp[comp_off[r]:comp_off[r+1]] (comp_off i64[n_rows + 1]); stored
// u8[n_rows] flags; chain c owns rows row_off[c]..row_off[c+1] and output
// out[out_off[c]:out_off[c+1]] (row_off, out_off i64[n_chains + 1]); seed
// u8[65536] the window every chain starts from, or null for zeros;
// out_lens i64[n_rows]. One CTA per chain on *stream*; does not
// synchronise; returns cudaGetLastError().
extern "C" int lz4t_token_decode_linked(
    const void* comp, int64_t comp_total, const void* comp_off,
    const void* stored, int64_t n_rows, const void* row_off,
    int64_t n_chains, const void* out_off, int64_t out_total,
    const void* seed, int64_t block_size, void* out, void* out_lens,
    void* stream) {
  if (n_chains <= 0) return 0;
  token_decode_linked_kernel<<<static_cast<unsigned>(n_chains), kLanes, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), comp_total,
      static_cast<const int64_t*>(comp_off),
      static_cast<const uint8_t*>(stored), n_rows,
      static_cast<const int64_t*>(row_off),
      static_cast<const int64_t*>(out_off), out_total,
      static_cast<const uint8_t*>(seed), block_size,
      static_cast<uint8_t*>(out), static_cast<int64_t*>(out_lens));
  return static_cast<int>(cudaGetLastError());
}
