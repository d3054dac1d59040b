// Hashed match-chain builder for Hopper (sm_90a), plain C entry points.
//
// Replaces no TPU kernel: the JAX package leaves build_dist_chains
// (divortio_lz4_tpu/ops/hybrid_encode.py) to XLA, one hashed lax.sort a
// row, and the port ran it as ~950 int64 torch ops a 128-row chunk
// (ops/hybrid_encode.py:_cand_rows, kept there as the plain version). This
// is the split encoder's chain builder, build_dist_chains(hashed=True): for
// every position of every [history | payload] row, the scored best of the
// PREDS = (1, 2, 3, 4, 6, 8) sort predecessors in its hash bucket, written
// as a u16 distance per payload position (0 = none). The result equals the
// torch ops element for element.
//
//   A. chain_keys_kernel, one CTA a row, walks the row in tiles of kTile
//      positions. Per tile: the bytes [t0 - 4, t0 + kTile + 256 + 4) in
//      shared memory (zeros past N, as pad(b, (0, 3)) and the zero fill of
//      the fingerprints give), the local prefix sum
//      L[i] = sum_{j < i} b[t0 + j] * B1_INV^j (a wrapping u32 scan), and
//      for each position p = t0 + k the u32 word, the invalid and interior
//      bits, the range hashes of d = 8 ... 256 bytes, their three tiers,
//      the payload pay = wc8 | fp16 | fp64 | fp256 and the sort key
//      h << (ibits + 2) | invalid << (ibits + 1) | interior << ibits | p
//      (hbits + ibits + 2 = 32 bits). The torch ops' range hash is
//      (c1[p + d] - c1[p]) * B1^p with c1 the row's prefix sum of
//      b[j] * B1_INV^j; B1 * B1_INV = 1 (mod 2^32), so it equals
//      (L[k + d] - L[k]) * B1^k, which needs no carry. Where p + d > N
//      the torch ops read 0 for c1[p + d], and the hash is
//      -(G + L[k]) * B1^k with G = c1[t0] * B1^t0, which the CTA carries
//      from tile to tile: G' = (G + L[kTile]) * B1^kTile.
//   S. One segmented radix sort of the u32 keys a row (cub), on bits
//      [ibits, 32) only: a radix sort is stable and kernel A writes each
//      row's keys in position order, so keys that tie in those bits keep
//      the order of their low bits, p, and the result is the full keys'
//      order (the keys are unique). 2 or 3 passes instead of 5 or 6.
//   B. chain_pick_kernel, one thread a sorted slot: the slot's and its
//      eight predecessors' keys and payloads (gathered through p = key &
//      mask) in shared memory, the six predecessors scored exactly as the
//      torch loop does (bucket, good predecessor, word check, tiers, score
//      sc * 16 + (15 - k), strict >), and the best one's distance written
//      straight into the caller's u16 chain row at p - hist_len. The torch
//      ops end in two forms, by N: up to 2^16 they scatter si - cand, above
//      it they scatter cand and check it against WINDOW_SIZE and the
//      receive range. A scored candidate already lies 1 ... WINDOW_SIZE - 1
//      positions back, so both read "the distance where a candidate exists
//      and p is in [hist_len, s_end - MF_LIMIT), else 0", which is what
//      the kernel writes, at every N.
//
// What bounds it on this card: bytes a position through the sort and the
// gathers, all in u32: A reads 1 B and writes 8 (key, payload), each sort
// pass reads the keys twice and writes them once (12 B), B reads 4 B of
// key and gathers 4 B of payload and writes 2 B at a scattered address.
// The torch ops moved ~500 full [R, N] int64 tensors a chunk (~4 KB a
// position) in ~950 launches; this is two kernels and the sort's passes.
// Kernel A walks a row on one CTA (the carry G is sequential); a 128-row
// chunk fills 128 of the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_segmented_radix_sort.cuh>

namespace {

constexpr uint32_t kB1 = 0x9E3779B1u;
constexpr uint32_t kB1Inv = 0x0E8B2F51u;   // kB1^-1 mod 2^32
constexpr int64_t kMinMatch = 4;
constexpr int64_t kMfLimit = 12;
constexpr int64_t kWindow = 65536;

constexpr int kThreadsA = 1024;
constexpr int kTile = 4096;                 // positions a tile
constexpr int kHalo = 256;                  // the widest range hash
constexpr int kSpan = kTile + kHalo;        // prefix terms a tile
constexpr int kItems = (kSpan + kThreadsA - 1) / kThreadsA;
constexpr int kThreadsB = 256;
constexpr int kBack = 8;                    // the farthest predecessor

__device__ __forceinline__ uint32_t upow(uint32_t b, uint32_t e) {
  uint32_t r = 1;
  while (e) {
    if (e & 1) r *= b;
    b *= b;
    e >>= 1;
  }
  return r;
}

__device__ __forceinline__ uint32_t word_at(const uint8_t* s) {
  return s[0] | (uint32_t(s[1]) << 8) | (uint32_t(s[2]) << 16) |
         (uint32_t(s[3]) << 24);
}

__global__ void __launch_bounds__(kThreadsA)
chain_keys_kernel(const uint8_t* __restrict__ work, int64_t R, int64_t N,
                  int64_t hist_len, const int64_t* __restrict__ lens,
                  const int64_t* __restrict__ hist_start, int ibits,
                  uint32_t* __restrict__ keys, uint32_t* __restrict__ pay,
                  int* __restrict__ offsets) {
  __shared__ uint8_t sb[4 + kSpan + 4];     // bytes t0 - 4 ... t0 + kSpan + 3
  __shared__ uint32_t L[kSpan + 1];
  __shared__ uint32_t warp_sum[kThreadsA / 32];
  const int64_t r = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* row = work + r * N;
  const int64_t s_end = hist_len + lens[r];
  const int64_t hs = hist_start[r];
  const int hbits = 30 - ibits;
  if (t == 0) {
    offsets[r] = static_cast<int>(r * N);
    if (r == R - 1) offsets[R] = static_cast<int>(R * N);
  }
  const uint32_t inv_first = upow(kB1Inv, t * kItems);  // this thread's terms
  const uint32_t pw_first = upow(kB1, t);               // its positions
  const uint32_t pw_step = upow(kB1, kThreadsA);
  const uint32_t pw_tile = upow(kB1, kTile);
  uint32_t G = 0;                                       // c1[t0] * B1^t0
  for (int64_t t0 = 0; t0 < N; t0 += kTile) {
    for (int i = t; i < 4 + kSpan + 4; i += kThreadsA) {
      const int64_t p = t0 - 4 + i;
      sb[i] = (p >= 0 && p < N) ? row[p] : 0;
    }
    __syncthreads();
    // L: each thread sums kItems terms, then a block scan of the sums
    uint32_t v[kItems];
    uint32_t acc = 0, pw = inv_first;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t * kItems + j;
      acc += i < kSpan ? sb[4 + i] * pw : 0u;
      v[j] = acc;
      pw *= kB1Inv;
    }
    uint32_t incl = acc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t x = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if ((t & 31) >= o) incl += x;
    }
    if ((t & 31) == 31) warp_sum[t >> 5] = incl;
    __syncthreads();
    if (t < 32) {
      uint32_t s = warp_sum[t];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t x = __shfl_up_sync(0xFFFFFFFFu, s, o);
        if (t >= o) s += x;
      }
      warp_sum[t] = s;
    }
    __syncthreads();
    const uint32_t base = incl - acc + (t >= 32 ? warp_sum[(t >> 5) - 1] : 0u);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t * kItems + j;
      if (i < kSpan) L[i + 1] = base + v[j];
    }
    if (t == 0) L[0] = 0;
    __syncthreads();

    const uint32_t neg_g = 0u - G;
    uint32_t pwk = pw_first;                  // B1^k
    for (int k = t; k < kTile; k += kThreadsA, pwk *= pw_step) {
      const int64_t p = t0 + k;
      if (p >= N) break;
      const uint8_t* s = sb + k;              // s[4] is byte p
      const uint32_t w = word_at(s + 4);
      bool interior = false;
#pragma unroll
      for (int m = 1; m <= 4; ++m)
        interior |= p >= m && word_at(s + 4 - m) == w;
      const bool invalid = p + kMinMatch > s_end || p < hs;
      const uint32_t lk = L[k];
      auto rh = [&](int d) -> uint32_t {
        return ((p + d <= N ? L[k + d] : neg_g) - lk) * pwk;
      };
      const uint32_t t16 = rh(8) * kB1 + rh(16);
      const uint32_t t64 = rh(32) * kB1 + rh(64);
      const uint32_t t256 = rh(128) * kB1 + rh(256);
      const uint32_t wc8 = (w * 0x85EBCA77u) >> 24;
      const uint32_t fp16 = (t16 * 0x9E3779B1u) >> 23;
      const uint32_t fp64 = (t64 * 0x85EBCA77u) >> 24;
      const uint32_t fp256 = (t256 * 0xC2B2AE3Du) >> 25;
      const uint32_t h = (w * 0x9E3779B1u) >> (32 - hbits);
      const int64_t at = r * N + p;
      pay[at] = (wc8 << 24) | (fp16 << 15) | (fp64 << 7) | fp256;
      keys[at] = (h << (ibits + 2)) | (uint32_t(invalid) << (ibits + 1)) |
                 (uint32_t(interior) << ibits) | uint32_t(p);
    }
    G = (G + L[kTile]) * pw_tile;
    __syncthreads();                          // sb and L are refilled next
  }
}

__global__ void __launch_bounds__(kThreadsB)
chain_pick_kernel(const uint32_t* __restrict__ skeys,
                  const uint32_t* __restrict__ pay, int64_t N,
                  int64_t hist_len, const int64_t* __restrict__ lens,
                  int ibits, uint16_t* __restrict__ out) {
  __shared__ uint32_t sk[kBack + kThreadsB];
  __shared__ uint32_t sp[kBack + kThreadsB];
  // a row's tiles are consecutive blocks, so the blocks in flight share a
  // few rows and their gathers and scatters stay in L2
  const int64_t tiles = (N + kThreadsB - 1) / kThreadsB;
  const int64_t r = blockIdx.x / tiles;
  const int64_t j0 = (blockIdx.x % tiles) * kThreadsB;
  const uint32_t mask = (1u << ibits) - 1u;
  const uint32_t* rk = skeys + r * N;
  const uint32_t* rp = pay + r * N;
  for (int i = threadIdx.x; i < kBack + kThreadsB; i += kThreadsB) {
    const int64_t j = j0 - kBack + i;
    // before the row's first slot: the torch ops' fill (bad bit set)
    uint32_t key = 0xFFFFFFFFu, py = 0;
    if (j >= 0 && j < N) {
      key = rk[j];
      py = rp[key & mask];
    }
    sk[i] = key;
    sp[i] = py;
  }
  __syncthreads();
  const int64_t j = j0 + threadIdx.x;
  if (j >= N) return;
  const int c = kBack + threadIdx.x;
  const uint32_t skey = sk[c], spay = sp[c];
  const int64_t si = skey & mask;
  const uint32_t bucket = skey >> (ibits + 2);
  int best_key = -1;
  int64_t best = -1;
  constexpr int kPreds[6] = {1, 2, 3, 4, 6, 8};
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int k = kPreds[q];
    const uint32_t pkey = sk[c - k], ppay = sp[c - k];
    const int64_t pi = pkey & mask;
    const int64_t dist = si - pi;
    const bool ok = ((pkey >> (ibits + 1)) & 1u) == 0 &&
                    (pkey >> (ibits + 2)) == bucket &&
                    (ppay >> 24) == (spay >> 24) && dist > 0 &&
                    dist < kWindow;
    const bool m16 = ok && ((ppay >> 15) & 0x1FFu) == ((spay >> 15) & 0x1FFu);
    const bool m64 = m16 && ((ppay >> 7) & 0xFFu) == ((spay >> 7) & 0xFFu);
    const bool m256 = m64 && (ppay & 0x7Fu) == (spay & 0x7Fu);
    const int sc = 4 + 16 * m16 + 64 * m64 + 256 * m256;
    const int keysc = ok ? sc * 16 + (15 - k) : -1;
    if (keysc > best_key) {
      best_key = keysc;
      best = pi;
    }
  }
  if (si < hist_len) return;
  const int64_t mf_limit = hist_len + lens[r] - kMfLimit;
  const bool valid = best >= 0 && si - best < kWindow && si < mf_limit;
  out[r * (N - hist_len) + (si - hist_len)] =
      valid ? static_cast<uint16_t>(si - best) : uint16_t(0);
}

int index_bits(int64_t N) {
  int b = 0;
  while ((int64_t(1) << b) < N) ++b;          // (N - 1).bit_length()
  return b;
}

}  // namespace

// Bytes of cub scratch that lz4t_chain_build needs for R rows of N.
extern "C" int lz4t_chain_sort_bytes(int64_t R, int64_t N, void* bytes) {
  cub::DoubleBuffer<uint32_t> keys(nullptr, nullptr);
  size_t n = 0;
  const cudaError_t e = cub::DeviceSegmentedRadixSort::SortKeys(
      nullptr, n, keys, static_cast<int>(R * N), static_cast<int>(R),
      static_cast<const int*>(nullptr), static_cast<const int*>(nullptr) + 1,
      index_bits(N), 32);
  *static_cast<int64_t*>(bytes) = static_cast<int64_t>(n);
  return static_cast<int>(e);
}

// work u8[R, N]; lens, hist_start i64[R]; keys, keys_alt, pay u32[R * N]
// and offsets i32[R + 1] scratch; temp the sort's scratch (temp_bytes from
// lz4t_chain_sort_bytes); out u16[R, N - hist_len]. Queued on *stream*;
// returns the first launch error (0 = none).
extern "C" int lz4t_chain_build(const void* work, int64_t R, int64_t N,
                                int64_t hist_len, const void* lens,
                                const void* hist_start, void* keys,
                                void* keys_alt, void* pay, void* offsets,
                                void* temp, int64_t temp_bytes, void* out,
                                void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const int ibits = index_bits(N);
  const auto* ln = static_cast<const int64_t*>(lens);
  auto* k0 = static_cast<uint32_t*>(keys);
  auto* py = static_cast<uint32_t*>(pay);
  auto* offs = static_cast<int*>(offsets);
  chain_keys_kernel<<<static_cast<unsigned>(R), kThreadsA, 0, st>>>(
      static_cast<const uint8_t*>(work), R, N, hist_len, ln,
      static_cast<const int64_t*>(hist_start), ibits, k0, py, offs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cub::DoubleBuffer<uint32_t> sorted(k0, static_cast<uint32_t*>(keys_alt));
  size_t tb = static_cast<size_t>(temp_bytes);
  e = cub::DeviceSegmentedRadixSort::SortKeys(
      temp, tb, sorted, static_cast<int>(R * N), static_cast<int>(R), offs,
      offs + 1, ibits, 32, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t tiles = (N + kThreadsB - 1) / kThreadsB;
  chain_pick_kernel<<<static_cast<unsigned>(R * tiles), kThreadsB, 0, st>>>(
      sorted.Current(), py, N, hist_len, ln, ibits,
      static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
