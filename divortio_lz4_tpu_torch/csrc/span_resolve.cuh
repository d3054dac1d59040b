// Parallel match resolution for Hopper (sm_90a): the stages that
// chain_decode.cu (records) and token_decode.cu (LZ4 tokens) share.
// Included by both sources; each builds into its own library, so
// everything here has internal linkage. _build.py hashes every csrc/*.cuh
// into each library's name, so an edit here rebuilds both.
//
// A chain's output is resolved in segments [s0, s1) of the whole output
// buffer, in order (ops/resolve.py is the plain PyTorch rendition):
//   B. every output byte gets one source: a literal byte, a seed byte, a
//      zero or an earlier position (its parent). The span kernels of the
//      two sources write literal, seed and zero bytes straight into out
//      (they are final) and leave code[g - s0] = ROOT; a byte whose parent
//      lies in an earlier segment, which is final, copies it at once. Only
//      a parent inside the segment is stored, as a segment-local int32.
//   C. pointer doubling, in place: a byte whose parent c is a root gets
//      the final code -(c + 2); any other parent pointer takes its
//      parent's code (a parent, or a final code: then the byte is final
//      too). Every entry always names an ancestor of its byte, so the
//      races between threads of a round are harmless, and a final byte is
//      never read again. Round k returns at once unless round k - 1 found
//      a parent pointer (flags[k - 1]), so the host launches
//      rounds_for(n) rounds without a sync and the device stops after
//      about ceil(log2(depth)) + 1 of them.
//   D. gather: out[p] = out[r] for every final code -(r + 2); r is a root,
//      so reads and writes never meet.
// What bounds it: each round streams the segment's codes (4 B a byte) and
// reads one code per byte still holding a parent pointer, mostly from L2;
// 10-11 rounds on the 64 MiB default frame, 2.7 ms in all on an H100.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace resolve {

constexpr int64_t kWin = 65536;   // seed window ahead of a chain's output
constexpr int32_t kRoot = -1;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Seg {
  uint8_t* out;          // the whole output buffer
  int32_t* code;         // code[g - s0] for g in [s0, s1)
  int64_t s0, s1;
  // chain c's kWin seed bytes at seed + c * seed_stride (stride 0: one
  // seed shared by every chain), or null for zeros
  const uint8_t* seed;
  int64_t seed_stride;
};

// Chain c's seed window, or null for zeros.
__device__ __forceinline__ const uint8_t* seed_of(const Seg& s, int64_t c) {
  return s.seed != nullptr ? s.seed + c * s.seed_stride : nullptr;
}

__device__ __forceinline__ bool inside(const Seg& s, int64_t g) {
  return g >= s.s0 && g < s.s1;
}

// Output byte g (inside the segment) of the chain whose output starts at
// o0 and whose seed window is *seed* (seed_of) takes the byte at global
// position gs < g; gs < o0 names the seed's byte kWin - (o0 - gs).
__device__ __forceinline__ void take(const Seg& s, int64_t g, int64_t o0,
                                     int64_t gs, const uint8_t* seed) {
  if (gs < o0) {
    s.out[g] = seed != nullptr ? __ldg(seed + (gs - o0 + kWin)) : 0;
  } else if (gs < s.s0) {
    s.out[g] = s.out[gs];
  } else {
    s.code[g - s.s0] = static_cast<int32_t>(gs - s.s0);
  }
}

constexpr int kScanThreads = 1024;   // the CTA of cta_scan

// Inclusive scan over the CTA (kScanThreads threads) of one value >= 0 per
// thread, by sum or by max; *total gets the whole CTA's result.
template <bool kMax>
__device__ int64_t cta_scan(int64_t v, int64_t* total) {
  __shared__ int64_t part[kScanThreads / 32];
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = kMax ? (v > u ? v : u) : v + u;
  }
  if (lane == 31) part[w] = v;
  __syncthreads();
  if (w == 0) {
    int64_t x = part[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t u = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = kMax ? (x > u ? x : u) : x + u;
    }
    part[lane] = x;
  }
  __syncthreads();
  if (w > 0) {
    const int64_t u = part[w - 1];
    v = kMax ? (v > u ? v : u) : v + u;
  }
  *total = part[kScanThreads / 32 - 1];
  __syncthreads();   // part is written again by the next call
  return v;
}

inline unsigned blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b < kMaxBlocks ? b : kMaxBlocks));
}

__global__ void __launch_bounds__(kThreads)
init_kernel(uint8_t* out, int32_t* code, int64_t s0, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n; i += stride) {
    code[i] = kRoot;
    out[s0 + i] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
round_kernel(int32_t* code, int64_t n, int32_t* flags, int k) {
  if (k > 0 && *reinterpret_cast<volatile int32_t*>(flags + k - 1) == 0)
    return;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int changed = 0;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n; i += stride) {
    const int32_t c = code[i];
    if (c < 0) continue;
    const int32_t up = __ldcg(code + c);   // L2: the freshest ancestor
    code[i] = up == kRoot ? -(c + 2) : up;
    changed = 1;
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) flags[k] = 1;
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(uint8_t* out, const int32_t* __restrict__ code, int64_t s0,
              int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n; i += stride) {
    const int32_t c = code[i];
    if (c <= -2) out[s0 + i] = out[s0 - 2 - c];
  }
}

// Stages C and D of one segment of n bytes; flags[0, rounds) zeroed.
inline void resolve_segment(uint8_t* out, int32_t* code, int64_t s0,
                            int64_t n, int32_t* flags, int rounds,
                            cudaStream_t stream) {
  const unsigned grid = blocks_for(n);
  for (int k = 0; k < rounds; ++k)
    round_kernel<<<grid, kThreads, 0, stream>>>(code, n, flags, k);
  gather_kernel<<<grid, kThreads, 0, stream>>>(out, code, s0, n);
}

}  // namespace resolve
}  // namespace
