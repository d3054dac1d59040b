// Host C++ functions of the port, plain C entry points for ctypes.
//
// Copied from divortio_lz4_tpu/native/lz4_kernels.cpp, with the helpers
// they need and nothing else; the semantics and error codes are unchanged:
//   lz4t_xxhash32            (lz4_kernels.cpp:46)   xxHash32 of a buffer
//   lz4t_scan_pieces         (:714)  sequence-boundary piece scan
//   lz4t_parse_records       (:796)  placed-literal record parse
//   lz4t_parse_records2      (:896)  wire-direct record parse
//   lz4t_chain_serialize16   (:1218) greedy select + serialize over a u16
//   lz4t_chain_serialize16m  (:1225) chain, plain and with splice meta
//   lz4t_chain_serialize     (:1025) the same over a packed i32 chain
//   lz4t_warm_table          (:119)  dictionary warm-up of the hash table
//   lz4t_compress_frame_body (:260)  the host frame encoder's block loop,
//                                    over compress_block_core (:136)
//   lz4t_compress_frame_body_mt (:308) its independent frames on threads
//   lz4t_xxh32_round4        (:88)   the streaming hasher's bulk stripes
//   lz4t_compress_block      (:241)  one block, the stream's host codec
//   lz4t_decompress_block    (:408)  one block with a dictionary
//   lz4t_decompress_frame_body (:547) the host frame decoder's block loop
//   lz4t_decompress_frame_body_mt (:607) its independent frames on threads
// The port's own, with no counterpart there:
//   lz4t_pack_chain_records  the chain decode's record words
//                            (ops/wave_decode.py build_chain_arrays)
//   lz4t_compact_parse, lz4t_compact_pack  the compact decode's staging of
//                            a batch of blocks on threads
//                            (ops/split_decode.py stage_compact_batch)
// Built with g++ at first use by divortio_lz4_tpu_torch/_build.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// xxHash32
// ---------------------------------------------------------------------------

static const uint32_t P1 = 2654435761u;
static const uint32_t P2 = 2246822519u;
static const uint32_t P3 = 3266489917u;
static const uint32_t P4 = 668265263u;
static const uint32_t P5 = 374761393u;

static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t xxh_round(uint32_t acc, uint32_t lane) {
  acc += lane * P2;
  return rotl32(acc, 13) * P1;
}

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);  // little-endian hosts only (x86/ARM LE)
  return v;
}

uint32_t lz4t_xxhash32(const uint8_t* buf, int64_t len, uint32_t seed) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  uint32_t h32;
  if (len >= 16) {
    const uint8_t* limit = end - 16;
    uint32_t v1 = seed + P1 + P2;
    uint32_t v2 = seed + P2;
    uint32_t v3 = seed;
    uint32_t v4 = seed - P1;
    do {
      v1 = xxh_round(v1, read32(p));
      v2 = xxh_round(v2, read32(p + 4));
      v3 = xxh_round(v3, read32(p + 8));
      v4 = xxh_round(v4, read32(p + 12));
      p += 16;
    } while (p <= limit);
    h32 = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h32 = seed + P5;
  }
  h32 += (uint32_t)len;
  while (p + 4 <= end) {
    h32 += read32(p) * P3;
    h32 = rotl32(h32, 17) * P4;
    p += 4;
  }
  while (p < end) {
    h32 += (*p) * P5;
    h32 = rotl32(h32, 11) * P1;
    p += 1;
  }
  h32 ^= h32 >> 15;
  h32 *= P2;
  h32 ^= h32 >> 13;
  h32 *= P3;
  h32 ^= h32 >> 16;
  return h32;
}

// Bulk stripe processing for the streaming hasher: consumes nwords/4 full
// stripes, updating v[0..3] in place.
void lz4t_xxh32_round4(uint32_t* v, const uint32_t* words, int64_t nwords) {
  uint32_t v1 = v[0], v2 = v[1], v3 = v[2], v4 = v[3];
  int64_t n = (nwords / 4) * 4;
  for (int64_t i = 0; i < n; i += 4) {
    v1 = xxh_round(v1, words[i]);
    v2 = xxh_round(v2, words[i + 1]);
    v3 = xxh_round(v3, words[i + 2]);
    v4 = xxh_round(v4, words[i + 3]);
  }
  v[0] = v1; v[1] = v2; v[2] = v3; v[3] = v4;
}

// ---------------------------------------------------------------------------
// LZ4 block constants and error codes
// ---------------------------------------------------------------------------

static const int MIN_MATCH = 4;
static const int LAST_LITERALS = 5;
static const int MF_LIMIT = 12;

// Translated to "LZ4: ..." ValueErrors by host.py.
static const int64_t ERR_OUTPUT_SMALL = -1;   // "Output Buffer Too Small"
static const int64_t ERR_MALFORMED = -2;      // "Malformed Input"
static const int64_t ERR_OFFSET0 = -3;        // "Invalid Offset 0"
static const int64_t ERR_DICT_OOB = -4;       // "Dictionary Offset Out of Bounds"
static const int64_t ERR_BLOCK_CK = -5;       // "Block Checksum Error"

// ---------------------------------------------------------------------------
// Piece scan
// ---------------------------------------------------------------------------

// Split a block's sequence stream at sequence boundaries into pieces each
// producing >= target output bytes (except the last). O(wire) length
// arithmetic only. Returns the piece count, ERR_MALFORMED on truncated
// length runs, ERR_OFFSET0 on zero offsets, or -6 when max_pieces would
// overflow.
int64_t lz4t_scan_pieces(const uint8_t* src, int64_t src_len, int64_t target,
                         int64_t* wire_off, int64_t* wire_len,
                         int64_t* out_len, int64_t max_pieces) {
  int64_t p = 0, o = 0, ps = 0, po = 0, np_ = 0;
  while (p < src_len) {
    uint32_t tok = src[p++];
    int64_t lit = tok >> 4;
    if (lit == 15) {
      uint32_t v;
      do {
        if (p >= src_len) return ERR_MALFORMED;
        v = src[p++];
        lit += v;
      } while (v == 255);
    }
    if (p + lit > src_len) return ERR_MALFORMED;
    p += lit;
    o += lit;
    if (p >= src_len) break;  // trailing-literals sequence ends the stream
    if (p + 2 > src_len) return ERR_MALFORMED;
    uint32_t off = (uint32_t)src[p] | ((uint32_t)src[p + 1] << 8);
    if (off == 0) return ERR_OFFSET0;
    p += 2;
    int64_t ml = tok & 15;
    if (ml == 15) {
      uint32_t v;
      do {
        if (p >= src_len) return ERR_MALFORMED;
        v = src[p++];
        ml += v;
      } while (v == 255);
    }
    o += ml + 4;
    if (o - po >= target && p < src_len) {
      if (np_ >= max_pieces - 1) return -6;
      wire_off[np_] = ps;
      wire_len[np_] = p - ps;
      out_len[np_] = o - po;
      np_++;
      ps = p;
      po = o;
    }
  }
  wire_off[np_] = ps;
  wire_len[np_] = p - ps;
  out_len[np_] = o - po;
  return np_ + 1;
}

// ---------------------------------------------------------------------------
// Placed-literal record parse
// ---------------------------------------------------------------------------
// Parse one block's sequence stream into (a) a PLACED-LITERAL image of the
// output (literal bytes memcpy'd to their final output offsets; match gaps
// left untouched) and (b) match records for the all-vector Pallas copy
// kernel (ops/pallas_split_decode.py): recs[2k] = offset | (mlen << 16),
// recs[2k+1] = dst (output byte offset of the match).
//
// This is the round-3 decode split: the O(wire) serial parse and the
// bandwidth-bound literal placement run here at host memcpy speed; the
// device kernel does ONLY 128-lane match copies (the actual serial
// dependency out[j] = out[j-offset]).
//
// RECORD CONTRACT (shaped by measured Mosaic behavior — the interleaved
// kernel loses its ILP to control-flow barriers, so its body must be
// straight-line: NO in-kernel periodize loop, NO chunk loop):
//   * every record has mlen <= 128 AND its full source range already
//     written when it executes (records run in array order);
//   * far matches (offset >= 128) longer than 128 split into 128-byte
//     records — record k's source ends at dst+128k+128-offset <= dst+128k,
//     written by records < k;
//   * overlap matches (offset < 128) whose source lies inside the
//     materialized suffix (this sequence's literals, or a contiguous run
//     of host-materialized bytes before them) are MATERIALIZED here — the
//     byte loop below IS LZ4 overlap propagation; RLE and periodic intros
//     emit no records at all;
//   * remaining overlap matches become LOG-DOUBLING chains: copy `offset`
//     bytes at offset, then 2*offset at 2*offset, ... — each record's
//     source is complete when it runs, and offsets reach >= 128 in
//     log2(128/offset) records, after which the tail splits as far
//     matches (period multiples keep out[j] = out[j-k*offset] valid).
//
// Validation matches lz4t_decompress_block (reference semantics
// blockDecompress.js:55-272, same error taxonomy). Returns the record
// count, or a negative error code.
int64_t lz4t_parse_records(const uint8_t* src, int64_t src_len, uint8_t* lit,
                           int64_t out_cap, uint32_t* recs, int64_t rec_cap,
                           int64_t dict_len, int64_t* out_len_out) {
  int64_t p = 0, o = 0, nrec = 0;
  int64_t mat_start = 0;  // start of the contiguous materialized suffix
  while (p < src_len) {
    uint32_t token = src[p++];
    int64_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint32_t b;
      do {
        if (p >= src_len) return ERR_MALFORMED;
        b = src[p++];
        lit_len += b;
      } while (b == 255);
    }
    if (o + lit_len > out_cap) return ERR_OUTPUT_SMALL;
    if (p + lit_len > src_len) return ERR_MALFORMED;
    if (lit_len) std::memcpy(lit + o, src + p, (size_t)lit_len);
    o += lit_len;
    p += lit_len;
    if (p >= src_len) break;  // trailing-literals sequence

    if (p + 2 > src_len) return ERR_MALFORMED;
    int64_t offset = src[p] | (src[p + 1] << 8);
    p += 2;
    if (offset == 0) return ERR_OFFSET0;
    if (offset > o + dict_len) return ERR_DICT_OOB;

    int64_t match_len = token & 0x0F;
    if (match_len == 15) {
      uint32_t b;
      do {
        if (p >= src_len) return ERR_MALFORMED;
        b = src[p++];
        match_len += b;
      } while (b == 255);
    }
    match_len += MIN_MATCH;
    if (o + match_len > out_cap) return ERR_OUTPUT_SMALL;

    if (offset < 128 && o - offset >= mat_start) {
      // Host-materialized overlap propagation (source is host-known).
      for (int64_t t = 0; t < match_len; t++) lit[o + t] = lit[o + t - offset];
      o += match_len;
      continue;  // suffix stays contiguous
    }
    int64_t off = offset, rem = match_len;
    while (off < 128 && rem > 0) {
      // Doubling chain: copy `off` bytes at offset `off`, then double.
      int64_t take = rem < off ? rem : off;
      if (nrec >= rec_cap) return -6;
      recs[2 * nrec] = (uint32_t)off | ((uint32_t)take << 16);
      recs[2 * nrec + 1] = (uint32_t)o;
      nrec++;
      o += take;
      rem -= take;
      off *= 2;
    }
    while (rem > 0) {
      int64_t take = rem < 128 ? rem : 128;
      if (nrec >= rec_cap) return -6;
      recs[2 * nrec] = (uint32_t)off | ((uint32_t)take << 16);
      recs[2 * nrec + 1] = (uint32_t)o;
      nrec++;
      o += take;
      rem -= take;
    }
    mat_start = o;  // device-copied bytes break the materialized suffix
  }
  *out_len_out = o;
  return nrec;
}

// ---------------------------------------------------------------------------
// Wire-direct record parse
// ---------------------------------------------------------------------------

// Each record covers up to 128 contiguous output bytes: a literal slice
// copied from the wire plus, optionally, a match copy from prior output:
//   recs[2k]   = src  (wire byte offset of the literal slice)
//   recs[2k+1] = offset | ll<<16 | ml<<24      (ll, ml <= 128, ll+ml <= 128)
// The record's output start is the running sum of (ll+ml). A record's match
// source [dst+ll-offset, dst+ll-offset+ml) is fully written when it runs:
// far matches (offset >= 128) split into <= 128-byte chunks whose first
// absorbs the literal tail; overlap matches (offset < 128) emit literal
// records then a log-doubling chain (off, 2*off, ...). Validation follows
// the reference decoder's error taxonomy. Returns the record count, or a
// negative error code; *out_len_out = decoded size.
int64_t lz4t_parse_records2(const uint8_t* src, int64_t src_len,
                            int64_t out_cap, uint32_t* recs, int64_t rec_cap,
                            int64_t dict_len, int64_t* out_len_out) {
  int64_t p = 0, o = 0, nrec = 0;
  while (p < src_len) {
    uint32_t token = src[p++];
    int64_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint32_t b;
      do {
        if (p >= src_len) return ERR_MALFORMED;
        b = src[p++];
        lit_len += b;
      } while (b == 255);
    }
    if (o + lit_len > out_cap) return ERR_OUTPUT_SMALL;
    if (p + lit_len > src_len) return ERR_MALFORMED;
    int64_t lp = p;  // literal slice's wire position
    o += lit_len;
    p += lit_len;
    if (p >= src_len) {
      // trailing-literals sequence: pure literal records
      while (lit_len > 0) {
        int64_t take = lit_len < 128 ? lit_len : 128;
        if (nrec >= rec_cap) return -6;
        recs[2 * nrec] = (uint32_t)lp;
        recs[2 * nrec + 1] = 1u | ((uint32_t)take << 16);
        nrec++;
        lp += take;
        lit_len -= take;
      }
      break;
    }

    if (p + 2 > src_len) return ERR_MALFORMED;
    int64_t offset = src[p] | (src[p + 1] << 8);
    p += 2;
    if (offset == 0) return ERR_OFFSET0;
    if (offset > o + dict_len) return ERR_DICT_OOB;

    int64_t match_len = token & 0x0F;
    if (match_len == 15) {
      uint32_t b;
      do {
        if (p >= src_len) return ERR_MALFORMED;
        b = src[p++];
        match_len += b;
      } while (b == 255);
    }
    match_len += MIN_MATCH;
    if (o + match_len > out_cap) return ERR_OUTPUT_SMALL;
    o += match_len;

    int64_t ll = lit_len, ml = match_len;
    if (nrec + (ll >> 7) + (ml >> 7) + 10 > rec_cap) return -6;
    if (ll + ml <= 128 && offset >= ll + ml) {
      // the common case: one combined record per sequence
      recs[2 * nrec] = (uint32_t)lp;
      recs[2 * nrec + 1] =
          (uint32_t)offset | ((uint32_t)ll << 16) | ((uint32_t)ml << 24);
      nrec++;
      continue;
    }
    if (offset >= 128) {
      // literal chunks; the last (<= 128 B) absorbs the match head —
      // offset >= 128 >= ll'+take keeps the source fully prior
      while (ll > 128) {
        recs[2 * nrec] = (uint32_t)lp;
        recs[2 * nrec + 1] = 1u | (128u << 16);
        nrec++;
        lp += 128;
        ll -= 128;
      }
      int64_t take = ml < 128 - ll ? ml : 128 - ll;
      recs[2 * nrec] = (uint32_t)lp;
      recs[2 * nrec + 1] =
          (uint32_t)offset | ((uint32_t)ll << 16) | ((uint32_t)take << 24);
      nrec++;
      ml -= take;
      while (ml > 0) {
        take = ml < 128 ? ml : 128;
        recs[2 * nrec] = 0;
        recs[2 * nrec + 1] = (uint32_t)offset | ((uint32_t)take << 24);
        nrec++;
        ml -= take;
      }
      continue;
    }
    // overlap match (offset < 128): literal records, then a doubling chain
    while (ll > 0) {
      int64_t take = ll < 128 ? ll : 128;
      recs[2 * nrec] = (uint32_t)lp;
      recs[2 * nrec + 1] = 1u | ((uint32_t)take << 16);
      nrec++;
      lp += take;
      ll -= take;
    }
    int64_t off = offset;
    while (off < 128 && ml > 0) {
      int64_t take = ml < off ? ml : off;
      recs[2 * nrec] = 0;
      recs[2 * nrec + 1] = (uint32_t)off | ((uint32_t)take << 24);
      nrec++;
      ml -= take;
      off <<= 1;
    }
    while (ml > 0) {
      int64_t take = ml < 128 ? ml : 128;
      recs[2 * nrec] = 0;
      recs[2 * nrec + 1] = (uint32_t)off | ((uint32_t)take << 24);
      nrec++;
      ml -= take;
    }
  }
  *out_len_out = o;
  return nrec;
}

// ---------------------------------------------------------------------------
// Chain record words
// ---------------------------------------------------------------------------

// The chain decode's record words from a frame's wire-direct records (the
// blocks' lz4t_parse_records2 output back to back, counts[b] records of
// block b): words[k] = (src + base[b], w1, dst), dst being the running sum
// of ll + ml, restarted at 0 on every block with first[b] != 0 (a chain's
// first block). All in u32, wrapping as the callers' u32 fields do.
void lz4t_pack_chain_records(const uint32_t* recs, const int64_t* counts,
                             const int64_t* base, const uint8_t* first,
                             int64_t nblocks, uint32_t* words) {
  uint32_t dst = 0;
  for (int64_t b = 0; b < nblocks; b++) {
    if (first[b]) dst = 0;
    const uint32_t add = (uint32_t)base[b];
    const int64_t n = counts[b];
    for (int64_t j = 0; j < n; j++) {
      const uint32_t w1 = recs[1];
      words[0] = recs[0] + add;
      words[1] = w1;
      words[2] = dst;
      dst += ((w1 >> 16) & 0xFF) + (w1 >> 24);
      recs += 2;
      words += 3;
    }
  }
}

// ---------------------------------------------------------------------------
// Compact batch staging
// ---------------------------------------------------------------------------

// The compact decode's host staging of a batch of independent blocks in
// two calls. lz4t_compact_parse runs on nthreads threads, each over a
// contiguous range of blocks (blocks[b] = data offset in buf, size,
// stored flag). Per block it copies the wire bytes into row b of
// wire[nb, wire_cap] and zeroes the rest of the row, parses the block
// with lz4t_parse_records2 (a stored block: 128-byte literal slices) and
// packs its records in place into the compact words
//   w0 = src | ll<<16 | ml<<24,   w1 = min(dst, 0xFFFF) | offset<<16,
// dst being the running sum of ll + ml within the block. It writes
// out_lens[b] and rec_off[nb + 1], and returns the record count N with
// the words held under *handle, or the error code of the lowest-indexed
// bad block (nothing held; -7: out of memory). lz4t_compact_pack then
// copies the words into words[N, 2] and frees the handle (words == NULL
// only frees it).
struct CompactStage {
  int32_t nthreads;
  std::vector<uint32_t*> recs;   // per thread: its blocks' words in order
  std::vector<int64_t> n;        // per thread: its records
  std::vector<int64_t> at;       // per thread: its first record's index
};

static void compact_free(CompactStage* st) {
  for (uint32_t* r : st->recs) std::free(r);
  delete st;
}

int64_t lz4t_compact_parse(const uint8_t* buf, const int64_t* blocks,
                           int64_t nb, int64_t out_cap, int64_t dict_len,
                           uint8_t* wire, int64_t wire_cap, int64_t* rec_off,
                           int64_t* out_lens, int32_t nthreads,
                           void** handle) {
  *handle = nullptr;
  if (nthreads > nb) nthreads = (int32_t)nb;
  if (nthreads < 1) nthreads = 1;
  CompactStage* st = new CompactStage();
  st->nthreads = nthreads;
  st->recs.assign(nthreads, nullptr);
  st->n.assign(nthreads, 0);
  st->at.assign(nthreads, 0);
  std::vector<int64_t> errs(nthreads, 0);

  auto worker = [&](int t) {
    const int64_t b0 = nb * t / nthreads, b1 = nb * (t + 1) / nthreads;
    int64_t cap = 0, used = 0;
    uint32_t* recs = nullptr;
    for (int64_t b = b0; b < b1; b++) {
      const int64_t off = blocks[3 * b], size = blocks[3 * b + 1];
      const bool stored = blocks[3 * b + 2] != 0;
      uint8_t* row = wire + b * wire_cap;
      std::memcpy(row, buf + off, (size_t)size);
      std::memset(row + size, 0, (size_t)(wire_cap - size));
      // parse_records2_native's record bound for this block
      const int64_t need = stored ? (size + 127) / 128
                                  : (size / 3 + 1) * 9 + out_cap / 128 + 8;
      if (used + need > cap) {
        int64_t grow = cap * 2 > used + need ? cap * 2 : used + need;
        uint32_t* r = (uint32_t*)std::realloc(recs, (size_t)grow * 8);
        if (!r) { errs[t] = -7; break; }
        recs = r;
        cap = grow;
      }
      uint32_t* w = recs + 2 * used;
      int64_t nrec, out_len;
      if (stored) {
        nrec = need;
        for (int64_t k = 0; k < nrec; k++) {
          const int64_t take = size - 128 * k < 128 ? size - 128 * k : 128;
          w[2 * k] = (uint32_t)(128 * k);
          w[2 * k + 1] = 1u | ((uint32_t)take << 16);
        }
        out_len = size;
      } else {
        nrec = lz4t_parse_records2(buf + off, size, out_cap, w, need,
                                   dict_len, &out_len);
        if (nrec < 0) { errs[t] = nrec; break; }
      }
      int64_t dst = 0;
      for (int64_t k = 0; k < nrec; k++) {
        const uint32_t w1 = w[2 * k + 1];
        const uint32_t ll = (w1 >> 16) & 0xFF, ml = w1 >> 24;
        w[2 * k] |= (w1 >> 16) << 16;
        w[2 * k + 1] = (uint32_t)(dst < 0xFFFF ? dst : 0xFFFF) | (w1 << 16);
        dst += ll + ml;
      }
      rec_off[b + 1] = nrec;
      out_lens[b] = out_len;
      used += nrec;
    }
    st->recs[t] = recs;
    st->n[t] = used;
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nthreads; t++) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();

  // Threads own ascending block ranges and stop at their first bad block,
  // so the first thread with an error holds the lowest bad block.
  for (int t = 0; t < nthreads; t++) {
    if (errs[t] < 0) {
      compact_free(st);
      return errs[t];
    }
  }
  rec_off[0] = 0;
  for (int64_t b = 0; b < nb; b++) rec_off[b + 1] += rec_off[b];
  int64_t total = 0;
  for (int t = 0; t < nthreads; t++) {
    st->at[t] = total;
    total += st->n[t];
  }
  *handle = st;
  return total;
}

void lz4t_compact_pack(void* handle, uint32_t* words) {
  CompactStage* st = (CompactStage*)handle;
  if (st == nullptr) return;
  if (words != nullptr) {
    auto worker = [&](int t) {
      if (st->n[t])
        std::memcpy(words + 2 * st->at[t], st->recs[t],
                    (size_t)st->n[t] * 8);
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < st->nthreads; t++) threads.emplace_back(worker, t);
    worker(0);
    for (auto& th : threads) th.join();
  }
  compact_free(st);
}

// ---------------------------------------------------------------------------
// Chain select + serialize
// ---------------------------------------------------------------------------

// Greedy selection, exact extension and serialization over a device-built
// u16 match distance per payload position (0 = no candidate). The next
// matchable position is found by scanning for the next nonzero distance; a
// claimed match is verified on its first 4 bytes (the hashed chain may
// collide), then extended exactly up to src_len - LAST_LITERALS. work
// points at [history | payload]. meta (optional, the big-block segment
// splicer's contract): trailing-token position, trailing literal count,
// last match sequence's stream offset (-1 if none), its payload-relative
// output anchor (-1). Returns bytes written.
static inline int64_t chain_ser16_core(const uint8_t* work,
                                       int64_t hist_len, int64_t src_len,
                                       const uint16_t* dist16, uint8_t* out,
                                       int64_t* meta) {
  const int64_t mf_limit = src_len - MF_LIMIT;
  const int64_t match_limit = src_len - LAST_LITERALS;
  const uint8_t* pay = work + hist_len;
  int64_t o = 0, d = 0;
  int64_t last_d = -1, last_anchor = -1;
  if (src_len > 0 && mf_limit > 0) {
    int64_t m = 0;
    for (;;) {
      // next matchable position >= m (dist16 has >= src_len entries,
      // zero beyond mf_limit, so the strided reads never pass cap):
      // a 32-byte stride first, then a ctz jump to the first nonzero lane.
      while (m + 16 <= mf_limit) {
        uint64_t v0, v1, v2, v3;
        std::memcpy(&v0, dist16 + m, 8);
        std::memcpy(&v1, dist16 + m + 4, 8);
        std::memcpy(&v2, dist16 + m + 8, 8);
        std::memcpy(&v3, dist16 + m + 12, 8);
        if (v0 | v1 | v2 | v3) {
          if (v0) m += __builtin_ctzll(v0) >> 4;
          else if (v1) m += 4 + (__builtin_ctzll(v1) >> 4);
          else if (v2) m += 8 + (__builtin_ctzll(v2) >> 4);
          else m += 12 + (__builtin_ctzll(v3) >> 4);
          break;
        }
        m += 16;
      }
      while (m + 4 <= mf_limit) {
        uint64_t v;
        std::memcpy(&v, dist16 + m, 8);
        if (v) { m += __builtin_ctzll(v) >> 4; break; }
        m += 4;
      }
      while (m < mf_limit && dist16[m] == 0) m++;
      if (m >= mf_limit) break;
      const int64_t dist = dist16[m];

      // verify the claimed match (hashed-chain collision guard)
      {
        uint32_t wa, wb;
        std::memcpy(&wa, pay + m, 4);
        std::memcpy(&wb, pay + m - dist, 4);
        if (wa != wb) { m++; continue; }
      }

      // exact extension (first MIN_MATCH bytes verified above)
      int64_t len = MIN_MATCH;
      const uint8_t* a = pay + m;
      const uint8_t* b = a - dist;
      const int64_t lim = match_limit - m;
      while (len + 8 <= lim) {
        uint64_t x, y;
        std::memcpy(&x, a + len, 8);
        std::memcpy(&y, b + len, 8);
        if (x != y) {
          len += __builtin_ctzll(x ^ y) >> 3;
          goto emit;
        }
        len += 8;
      }
      while (len < lim && a[len] == b[len]) len++;
    emit:;
      last_d = d;
      last_anchor = o;
      int64_t lit = m - o;
      int64_t mcode = len - MIN_MATCH;
      out[d++] = (uint8_t)((lit < 15 ? lit : 15) << 4
                           | (mcode < 15 ? mcode : 15));
      if (lit >= 15) {
        int64_t rem = lit - 15;
        while (rem >= 255) { out[d++] = 255; rem -= 255; }
        out[d++] = (uint8_t)rem;
      }
      std::memcpy(out + d, pay + o, (size_t)lit);
      d += lit;
      out[d++] = (uint8_t)(dist & 0xFF);
      out[d++] = (uint8_t)(dist >> 8);
      if (mcode >= 15) {
        int64_t rem = mcode - 15;
        while (rem >= 255) { out[d++] = 255; rem -= 255; }
        out[d++] = (uint8_t)rem;
      }
      o = m + len;
      m = o;
    }
  }
  int64_t lit = src_len - o;
  if (meta) {
    meta[0] = d;        // trailing-token position (0 => all-literal)
    meta[1] = lit;      // trailing literal count
    meta[2] = last_d;
    meta[3] = last_anchor;
  }
  out[d++] = (uint8_t)((lit < 15 ? lit : 15) << 4);
  if (lit >= 15) {
    int64_t rem = lit - 15;
    while (rem >= 255) { out[d++] = 255; rem -= 255; }
    out[d++] = (uint8_t)rem;
  }
  std::memcpy(out + d, pay + o, (size_t)lit);
  return d + lit;
}

int64_t lz4t_chain_serialize16(const uint8_t* work, int64_t hist_len,
                               int64_t src_len, const uint16_t* dist16,
                               uint8_t* out) {
  return chain_ser16_core(work, hist_len, src_len, dist16, out, nullptr);
}

int64_t lz4t_chain_serialize16m(const uint8_t* work, int64_t hist_len,
                                int64_t src_len, const uint16_t* dist16,
                                uint8_t* out, int64_t* meta) {
  return chain_ser16_core(work, hist_len, src_len, dist16, out, meta);
}

// The packed form: chain[a] = (m << 16) | dist gives, for every payload
// position a, the first matchable position m >= a (0xFFFF = none) and its
// match distance (ops/hybrid_encode build_chains). The walk jumps anchor
// -> chain[anchor] -> anchor + exact extension, with no verify (the
// packed chains are exact-word). Returns bytes written.
int64_t lz4t_chain_serialize(const uint8_t* work, int64_t hist_len,
                             int64_t src_len, const int32_t* chain,
                             uint8_t* out) {
  const int64_t mf_limit = src_len - MF_LIMIT;
  const int64_t match_limit = src_len - LAST_LITERALS;
  const uint8_t* pay = work + hist_len;
  int64_t o = 0, d = 0;
  if (src_len > 0 && mf_limit > 0) {
    uint32_t e = (uint32_t)chain[0];
    int64_t m = (e >> 16) & 0xFFFF, dist = e & 0xFFFF;
    while (m < mf_limit) {
      int64_t len = MIN_MATCH;
      const uint8_t* a = pay + m;
      const uint8_t* b = a - dist;
      const int64_t lim = match_limit - m;
      while (len + 8 <= lim) {
        uint64_t x, y;
        std::memcpy(&x, a + len, 8);
        std::memcpy(&y, b + len, 8);
        if (x != y) {
          len += __builtin_ctzll(x ^ y) >> 3;
          goto emit;
        }
        len += 8;
      }
      while (len < lim && a[len] == b[len]) len++;
    emit:;
      int64_t lit = m - o;
      int64_t mcode = len - MIN_MATCH;
      out[d++] = (uint8_t)((lit < 15 ? lit : 15) << 4
                           | (mcode < 15 ? mcode : 15));
      if (lit >= 15) {
        int64_t rem = lit - 15;
        while (rem >= 255) { out[d++] = 255; rem -= 255; }
        out[d++] = (uint8_t)rem;
      }
      std::memcpy(out + d, pay + o, (size_t)lit);
      d += lit;
      out[d++] = (uint8_t)(dist & 0xFF);
      out[d++] = (uint8_t)(dist >> 8);
      if (mcode >= 15) {
        int64_t rem = mcode - 15;
        while (rem >= 255) { out[d++] = 255; rem -= 255; }
        out[d++] = (uint8_t)rem;
      }
      o = m + len;
      e = (uint32_t)chain[o];  // o <= match_limit < src_len
      m = (e >> 16) & 0xFFFF;
      dist = e & 0xFFFF;
    }
  }
  int64_t lit = src_len - o;
  out[d++] = (uint8_t)((lit < 15 ? lit : 15) << 4);
  if (lit >= 15) {
    int64_t rem = lit - 15;
    while (rem >= 255) { out[d++] = 255; rem -= 255; }
    out[d++] = (uint8_t)rem;
  }
  std::memcpy(out + d, pay + o, (size_t)lit);
  return d + lit;
}

// ---------------------------------------------------------------------------
// Greedy block compress (the host frame encoder)
// ---------------------------------------------------------------------------

static const int HASH_SHIFT = 18;
static const uint32_t HASH_MASK = 16383;
static const uint32_t HASH_MULT = 2654435761u;
static const int SKIP_TRIGGER = 6;

static inline uint32_t lz4_hash(uint32_t seq) {
  return (seq * HASH_MULT) >> HASH_SHIFT & HASH_MASK;
}

// Insert positions [0, limit-4] of buf into table (stored as pos+1).
void lz4t_warm_table(int32_t* table, const uint8_t* buf, int64_t limit) {
  for (int64_t i = 0; i + MIN_MATCH <= limit; i++) {
    table[lz4_hash(read32(buf + i))] = (int32_t)(i + 1);
  }
}

// Greedy LZ4 block compress (the reference encoder's parse: the hash table
// stores pos+1, the skip stride grows every 64 misses, matches extend
// forward to src_end-5). WILD copies literal runs as 16-byte chunks: the
// caller gives >= 16 bytes of dst slack past the block bound and >= 16
// readable bytes past the source end.
static inline int64_t compress_block_core(const uint8_t* __restrict src,
                                          uint8_t* __restrict dst,
                                          int64_t src_start, int64_t src_len,
                                          int32_t* __restrict table,
                                          int64_t dst_off, const int WILD) {
  int64_t s = src_start;
  const int64_t s_end = src_start + src_len;
  const int64_t mf_limit = s_end - MF_LIMIT;
  const int64_t match_limit = s_end - LAST_LITERALS;
  int64_t d = dst_off;
  int64_t anchor = s;
  int search_count = (1 << SKIP_TRIGGER) + 3;

  while (s < mf_limit) {
    uint32_t seq = read32(src + s);
    uint32_t h = lz4_hash(seq);
    int64_t m = (int64_t)table[h] - 1;
    table[h] = (int32_t)(s + 1);

    if (m < 0 || s == m || (s - m) >= 65536 || read32(src + m) != seq) {
      s += search_count++ >> SKIP_TRIGGER;
      continue;
    }
    search_count = (1 << SKIP_TRIGGER) + 3;

    int64_t lit_len = s - anchor;
    int64_t token_pos = d++;
    if (lit_len >= 15) {
      dst[token_pos] = 0xF0;
      int64_t l = lit_len - 15;
      while (l >= 255) { dst[d++] = 255; l -= 255; }
      dst[d++] = (uint8_t)l;
    } else {
      dst[token_pos] = (uint8_t)(lit_len << 4);
    }
    if (lit_len > 0) {
      if (WILD) {
        uint8_t* dp = dst + d;
        const uint8_t* sp2 = src + anchor;
        int64_t l = lit_len;
        do { std::memcpy(dp, sp2, 16); dp += 16; sp2 += 16; l -= 16;
        } while (l > 0);
      } else {
        std::memcpy(dst + d, src + anchor, (size_t)lit_len);
      }
      d += lit_len;
    }

    int64_t sp = s + MIN_MATCH;
    int64_t mp = m + MIN_MATCH;
    while (sp + 8 <= match_limit) {
      uint64_t a, b;
      std::memcpy(&a, src + sp, 8);
      std::memcpy(&b, src + mp, 8);
      uint64_t diff = a ^ b;
      if (diff) {
        sp += __builtin_ctzll(diff) >> 3;
        goto match_done;
      }
      sp += 8;
      mp += 8;
    }
    while (sp < match_limit && src[sp] == src[mp]) { sp++; mp++; }
  match_done:;
    {
      int64_t match_len = sp - s;
      int64_t offset = s - m;
      dst[d++] = (uint8_t)(offset & 0xFF);
      dst[d++] = (uint8_t)((offset >> 8) & 0xFF);
      int64_t code = match_len - MIN_MATCH;
      if (code >= 15) {
        dst[token_pos] |= 0x0F;
        int64_t l = code - 15;
        while (l >= 255) { dst[d++] = 255; l -= 255; }
        dst[d++] = (uint8_t)l;
      } else {
        dst[token_pos] |= (uint8_t)code;
      }
      s = sp;
      anchor = sp;
    }
  }

  {
    int64_t lit_len = s_end - anchor;
    int64_t token_pos = d++;
    if (lit_len >= 15) {
      dst[token_pos] = 0xF0;
      int64_t l = lit_len - 15;
      while (l >= 255) { dst[d++] = 255; l -= 255; }
      dst[d++] = (uint8_t)l;
    } else {
      dst[token_pos] = (uint8_t)(lit_len << 4);
    }
    if (lit_len > 0) {
      std::memcpy(dst + d, src + anchor, (size_t)lit_len);
      d += lit_len;
    }
  }
  return d - dst_off;
}

// A whole frame body in one call: per block the size word, the block or
// its stored fallback, the optional block checksum, the table cleared
// between independent blocks; then the EndMark. src spans [0, total_end),
// compression starting at input_start (a nonzero start is a dictionary
// prefix, warmed first by lz4t_warm_table). dst holds the worst-case body
// bound plus 16 bytes of slack. Returns bytes written at dst + dst_off.
int64_t lz4t_compress_frame_body(const uint8_t* __restrict src,
                                 int64_t input_start, int64_t total_end,
                                 uint8_t* __restrict dst, int64_t dst_off,
                                 int64_t block_size,
                                 int32_t* __restrict table,
                                 int32_t independent,
                                 int32_t block_checksums) {
  int64_t pos = dst_off;
  int64_t src_pos = input_start;
  while (src_pos < total_end) {
    int64_t end = src_pos + block_size;
    if (end > total_end) end = total_end;
    int64_t bsize = end - src_pos;
    int64_t size_pos = pos;
    pos += 4;
    int64_t comp = compress_block_core(src, dst, src_pos, bsize, table,
                                       pos, 1);
    if (comp > 0 && comp < bsize) {
      uint32_t w = (uint32_t)comp;
      std::memcpy(dst + size_pos, &w, 4);
      pos += comp;
    } else {
      uint32_t w = (uint32_t)bsize | 0x80000000u;
      std::memcpy(dst + size_pos, &w, 4);
      std::memcpy(dst + pos, src + src_pos, (size_t)bsize);
      pos += bsize;
    }
    if (block_checksums) {
      uint32_t ck = lz4t_xxhash32(dst + size_pos + 4,
                                  pos - (size_pos + 4), 0);
      std::memcpy(dst + pos, &ck, 4);
      pos += 4;
    }
    if (independent) std::memset(table, 0, (HASH_MASK + 1) * sizeof(int32_t));
    src_pos = end;
  }
  uint32_t zero = 0;
  std::memcpy(dst + pos, &zero, 4);  // EndMark
  pos += 4;
  return pos - dst_off;
}

// Independent frames on several threads: blocks compress at once into
// per-block scratch, then are stitched in order into the serial path's
// exact wire bytes. Block 0 uses the caller's (possibly dictionary-warmed)
// table; later blocks start from a cleared table, as the serial path's
// per-block clear leaves them.
int64_t lz4t_compress_frame_body_mt(const uint8_t* __restrict src,
                                    int64_t input_start, int64_t total_end,
                                    uint8_t* __restrict dst, int64_t dst_off,
                                    int64_t block_size,
                                    int32_t* __restrict table,
                                    int32_t block_checksums,
                                    int32_t nthreads) {
  const int64_t n = total_end - input_start;
  const int64_t nblocks = n > 0 ? (n + block_size - 1) / block_size : 0;
  if (nthreads < 2 || nblocks < 2) {
    return lz4t_compress_frame_body(src, input_start, total_end, dst,
                                    dst_off, block_size, table, 1,
                                    block_checksums);
  }
  if (nthreads > nblocks) nthreads = (int32_t)nblocks;

  // Per-block scratch at a fixed stride (worst-case bound + wild slack).
  const int64_t stride = block_size + block_size / 255 + 16 + 16;
  uint8_t* scratch = (uint8_t*)std::malloc((size_t)(nblocks * stride));
  int64_t* comp_sizes = (int64_t*)std::malloc(nblocks * sizeof(int64_t));
  if (!scratch || !comp_sizes) {
    std::free(scratch); std::free(comp_sizes);
    return lz4t_compress_frame_body(src, input_start, total_end, dst,
                                    dst_off, block_size, table, 1,
                                    block_checksums);
  }

  auto worker = [&](int t) {
    std::vector<int32_t> local(HASH_MASK + 1);
    for (int64_t b = t; b < nblocks; b += nthreads) {
      int64_t s0 = input_start + b * block_size;
      int64_t end = s0 + block_size;
      if (end > total_end) end = total_end;
      int32_t* tb;
      if (b == 0) {
        tb = table;  // dictionary-warmed state, exactly as the serial path
      } else {
        std::memset(local.data(), 0, (HASH_MASK + 1) * sizeof(int32_t));
        tb = local.data();
      }
      comp_sizes[b] = compress_block_core(src, scratch + b * stride, s0,
                                          end - s0, tb, 0, 1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nthreads; t++) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();

  // Serial stitch into the spec wire layout.
  int64_t pos = dst_off;
  for (int64_t b = 0; b < nblocks; b++) {
    int64_t s0 = input_start + b * block_size;
    int64_t end = s0 + block_size;
    if (end > total_end) end = total_end;
    int64_t bsize = end - s0;
    int64_t comp = comp_sizes[b];
    int64_t size_pos = pos;
    pos += 4;
    if (comp > 0 && comp < bsize) {
      uint32_t w = (uint32_t)comp;
      std::memcpy(dst + size_pos, &w, 4);
      std::memcpy(dst + pos, scratch + b * stride, (size_t)comp);
      pos += comp;
    } else {
      uint32_t w = (uint32_t)bsize | 0x80000000u;
      std::memcpy(dst + size_pos, &w, 4);
      std::memcpy(dst + pos, src + s0, (size_t)bsize);
      pos += bsize;
    }
    if (block_checksums) {
      uint32_t ck = lz4t_xxhash32(dst + size_pos + 4,
                                  pos - (size_pos + 4), 0);
      std::memcpy(dst + pos, &ck, 4);
      pos += 4;
    }
  }
  uint32_t zero = 0;
  std::memcpy(dst + pos, &zero, 4);  // EndMark
  pos += 4;
  std::free(scratch);
  std::free(comp_sizes);
  return pos - dst_off;
}

// One block through compress_block_core without wild copies: dst needs
// only block_bound(src_len) bytes past dst_off. Returns bytes written.
int64_t lz4t_compress_block(const uint8_t* src, uint8_t* dst,
                            int64_t src_start, int64_t src_len,
                            int32_t* table, int64_t dst_off) {
  return compress_block_core(src, dst, src_start, src_len, table, dst_off,
                             0);
}

// ---------------------------------------------------------------------------
// Block decompress
// ---------------------------------------------------------------------------

// Sequence interpreter with dictionary back-references. dst_cap is the
// full output buffer length; back-references below index 0 read the
// dictionary from its END; a match may span dictionary into output.
// Returns bytes written at dst + dst_off, or an error code.
int64_t lz4t_decompress_block(const uint8_t* src, int64_t src_off,
                              int64_t src_len, uint8_t* dst, int64_t dst_cap,
                              int64_t dst_off, const uint8_t* dict,
                              int64_t dict_len) {
  int64_t p = src_off;
  const int64_t end = src_off + src_len;
  int64_t o = dst_off;

  // Wild-copy fast path: unconditional 16-byte chunk copies may write up to
  // 15 bytes past the copy's logical end; legal while both cursors stay
  // WILD_MARGIN clear of their buffers' ends (later sequences overwrite the
  // spill). The tail of the block falls back to exact copies.
  const int64_t WILD_MARGIN = 32;
  const int64_t wild_cap = dst_cap - WILD_MARGIN;

  while (p < end) {
    uint32_t token = src[p++];
    int64_t lit_len = token >> 4;

    // --- literals ---
    if (lit_len == 15) {
      uint32_t b;
      do {
        if (p >= end) return ERR_MALFORMED;
        b = src[p++];
        lit_len += b;
      } while (b == 255);
    }
    if (o + lit_len > dst_cap) return ERR_OUTPUT_SMALL;
    if (p + lit_len > end) return ERR_MALFORMED;
    if (lit_len <= 16 && p + 16 <= end && o + 16 <= wild_cap) {
      std::memcpy(dst + o, src + p, 16);  // wild 16B covers <=16 literals
    } else if (lit_len) {
      std::memcpy(dst + o, src + p, (size_t)lit_len);
    }
    o += lit_len;
    p += lit_len;
    if (p >= end) break;

    // --- offset + match length ---
    if (p + 2 > end) return ERR_MALFORMED;
    int64_t offset = src[p] | (src[p + 1] << 8);
    p += 2;
    if (offset == 0) return ERR_OFFSET0;

    int64_t match_len = token & 0x0F;
    if (match_len == 15) {
      uint32_t b;
      do {
        if (p >= end) return ERR_MALFORMED;
        b = src[p++];
        match_len += b;
      } while (b == 255);
    }
    match_len += MIN_MATCH;
    if (o + match_len > dst_cap) return ERR_OUTPUT_SMALL;

    int64_t cs = o - offset;
    if (cs < 0) {
      // Dictionary back-reference, dict indexed from its end.
      int64_t from_dict = -cs;
      int64_t dict_start = dict_len - from_dict;
      int64_t take = from_dict < match_len ? from_dict : match_len;
      if (dict_start < 0 || dict_start + take > dict_len) return ERR_DICT_OOB;
      std::memcpy(dst + o, dict + dict_start, (size_t)take);
      o += take;
      int64_t remaining = match_len - take;
      int64_t rp = o - offset;
      while (remaining--) dst[o++] = dst[rp++];
    } else if (offset >= match_len) {
      // Non-overlapping: one wild 16B copy covers the common short match;
      // long matches take a single memcpy.
      if (match_len <= 16 && offset >= 16 && o + 16 <= wild_cap) {
        std::memcpy(dst + o, dst + cs, 16);
      } else {
        std::memcpy(dst + o, dst + cs, (size_t)match_len);
      }
      o += match_len;
    } else if (offset >= 16) {
      // Overlapping, offset >= 16: wild 16B-chunk copy propagates correctly
      // (each chunk's source bytes are written by prior chunks); period
      // doubling near the buffer end (memmove would NOT propagate).
      if (o + match_len + 16 <= wild_cap) {
        int64_t dp = o, sp = cs;
        int64_t stop = o + match_len;
        do {
          std::memcpy(dst + dp, dst + sp, 16);
          dp += 16;
          sp += 16;
        } while (dp < stop);
      } else {
        int64_t remaining = match_len;
        int64_t avail = offset;
        int64_t dp = o;
        while (remaining > 0) {
          int64_t c = avail < remaining ? avail : remaining;
          std::memcpy(dst + dp, dst + cs, (size_t)c);
          dp += c;
          remaining -= c;
          avail += c;
        }
      }
      o += match_len;
    } else if (offset == 1) {
      // RLE.
      std::memset(dst + o, dst[cs], (size_t)match_len);
      o += match_len;
    } else {
      // Short-offset overlap (2..15): period-doubling copy, O(log)
      // non-overlapping memcpys instead of a byte loop.
      int64_t remaining = match_len;
      int64_t avail = offset;
      int64_t dp = o;
      while (remaining > 0) {
        int64_t c = avail < remaining ? avail : remaining;
        std::memcpy(dst + dp, dst + cs, (size_t)c);
        dp += c;
        remaining -= c;
        avail += c;
      }
      o += match_len;
    }
  }
  return o - dst_off;
}

// A whole frame body, direct-write, in one call: size words, stored
// blocks, block checksums verified before a block is read, EndMark; the
// error order of frame.py's per-block loop. Independent blocks reference
// the dictionary only (the window resets at each block); linked blocks
// reference earlier output and the dictionary below it. Returns the
// plaintext bytes written to result, or an error code; *wire_end_out gets
// the wire position just past the EndMark.
int64_t lz4t_decompress_frame_body(const uint8_t* __restrict buf,
                                   int64_t pos, int64_t n,
                                   uint8_t* __restrict result,
                                   int64_t result_cap,
                                   const uint8_t* dict, int64_t dict_len,
                                   int32_t independent,
                                   int32_t block_checksums,
                                   int32_t verify,
                                   int64_t* wire_end_out) {
  int64_t result_pos = 0;
  while (pos < n) {
    if (pos + 4 > n) return ERR_MALFORMED;
    uint32_t word;
    std::memcpy(&word, buf + pos, 4);
    pos += 4;
    if (word == 0) break;  // EndMark
    int64_t bsize = word & 0x7FFFFFFF;
    int stored = (word & 0x80000000u) != 0;
    if (pos + bsize > n) return ERR_MALFORMED;

    if (block_checksums) {
      if (pos + bsize + 4 > n) return ERR_MALFORMED;
      if (verify) {
        uint32_t stored_ck;
        std::memcpy(&stored_ck, buf + pos + bsize, 4);
        if (stored_ck != lz4t_xxhash32(buf + pos, bsize, 0))
          return ERR_BLOCK_CK;
      }
    }

    if (stored) {
      if (result_pos + bsize > result_cap) return ERR_OUTPUT_SMALL;
      std::memcpy(result + result_pos, buf + pos, (size_t)bsize);
      result_pos += bsize;
    } else if (independent) {
      int64_t rc = lz4t_decompress_block(buf, pos, bsize,
                                         result + result_pos,
                                         result_cap - result_pos, 0,
                                         dict, dict_len);
      if (rc < 0) return rc;
      result_pos += rc;
    } else {
      int64_t rc = lz4t_decompress_block(buf, pos, bsize, result, result_cap,
                                         result_pos, dict, dict_len);
      if (rc < 0) return rc;
      result_pos += rc;
    }
    pos += bsize;
    if (block_checksums) pos += 4;
  }
  *wire_end_out = pos;
  return result_pos;
}

// Independent frames on several threads: a serial scan of the block
// table, the blocks decoded at once into scratch (each block's window is
// the dictionary only), then stitched in order; the serial path's bytes.
// block_max is the BD byte's block maximum; a block that decodes past it
// sends the frame to the serial path.
int64_t lz4t_decompress_frame_body_mt(const uint8_t* __restrict buf,
                                      int64_t pos, int64_t n,
                                      uint8_t* __restrict result,
                                      int64_t result_cap,
                                      const uint8_t* dict, int64_t dict_len,
                                      int64_t block_max,
                                      int32_t block_checksums,
                                      int32_t verify,
                                      int32_t nthreads,
                                      int64_t* wire_end_out) {
  // Serial block-table scan.
  std::vector<int64_t> offs, sizes;
  std::vector<uint8_t> stored_v;
  int64_t scan = pos;
  while (scan < n) {
    if (scan + 4 > n) return ERR_MALFORMED;
    uint32_t word;
    std::memcpy(&word, buf + scan, 4);
    scan += 4;
    if (word == 0) break;
    int64_t bsize = word & 0x7FFFFFFF;
    if (scan + bsize + (block_checksums ? 4 : 0) > n) return ERR_MALFORMED;
    offs.push_back(scan);
    sizes.push_back(bsize);
    stored_v.push_back((word & 0x80000000u) != 0);
    scan += bsize + (block_checksums ? 4 : 0);
  }
  const int64_t nblocks = (int64_t)offs.size();
  if (nthreads < 2 || nblocks < 2) {
    return lz4t_decompress_frame_body(buf, pos, n, result, result_cap, dict,
                                      dict_len, 1, block_checksums, verify,
                                      wire_end_out);
  }
  if (nthreads > nblocks) nthreads = (int32_t)nblocks;

  uint8_t* scratch = (uint8_t*)std::malloc((size_t)(nblocks * block_max));
  int64_t* dec_sizes = (int64_t*)std::malloc(nblocks * sizeof(int64_t));
  if (!scratch || !dec_sizes) {
    std::free(scratch); std::free(dec_sizes);
    return lz4t_decompress_frame_body(buf, pos, n, result, result_cap, dict,
                                      dict_len, 1, block_checksums, verify,
                                      wire_end_out);
  }

  std::vector<int64_t> errs(nthreads, 0);
  auto worker = [&](int t) {
    for (int64_t b = t; b < nblocks; b += nthreads) {
      if (block_checksums && verify) {
        uint32_t stored_ck;
        std::memcpy(&stored_ck, buf + offs[b] + sizes[b], 4);
        if (stored_ck != lz4t_xxhash32(buf + offs[b], sizes[b], 0)) {
          errs[t] = ERR_BLOCK_CK;
          return;
        }
      }
      if (stored_v[b]) {
        dec_sizes[b] = sizes[b];  // stitched straight from buf
        if (sizes[b] > block_max) { errs[t] = ERR_OUTPUT_SMALL; return; }
        continue;
      }
      int64_t rc = lz4t_decompress_block(buf, offs[b], sizes[b],
                                         scratch + b * block_max, block_max,
                                         0, dict, dict_len);
      if (rc < 0) { errs[t] = rc; return; }
      dec_sizes[b] = rc;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nthreads; t++) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();

  int64_t err = 0;
  for (int t = 0; t < nthreads; t++) if (errs[t] < 0) err = errs[t];
  if (err == ERR_OUTPUT_SMALL) {
    // A block larger than the BD block maximum: out-of-spec but the serial
    // path tolerates it when the result buffer has room — retry serially.
    std::free(scratch); std::free(dec_sizes);
    return lz4t_decompress_frame_body(buf, pos, n, result, result_cap, dict,
                                      dict_len, 1, block_checksums, verify,
                                      wire_end_out);
  }
  if (err < 0) { std::free(scratch); std::free(dec_sizes); return err; }

  int64_t result_pos = 0;
  for (int64_t b = 0; b < nblocks; b++) {
    if (result_pos + dec_sizes[b] > result_cap) {
      std::free(scratch); std::free(dec_sizes);
      return ERR_OUTPUT_SMALL;
    }
    const uint8_t* srcp = stored_v[b] ? buf + offs[b]
                                      : scratch + b * block_max;
    std::memcpy(result + result_pos, srcp, (size_t)dec_sizes[b]);
    result_pos += dec_sizes[b];
  }
  std::free(scratch);
  std::free(dec_sizes);
  *wire_end_out = scan;
  return result_pos;
}

}  // extern "C"
