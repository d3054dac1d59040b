"""engine="hybrid" encode and the split encode's chain builder.

Port of ``divortio_lz4_tpu/ops/hybrid_encode.py``.

- The candidate search (``_cand_row``, ``_dist_row``, ``_chain_row``,
  ``build_dist_chains``, ``build_chains``) and ``ops/encode_xla.py:_pows``.
  In the JAX package this phase is plain XLA, not Pallas: one sort per
  block row gives every payload position the distance of its best
  previous same-word occurrence. The split encode ships it as u16
  distances (``build_dist_chains``, 0 = none) to the host serializer
  (``lz4t_chain_serialize16``); the hybrid walk takes the packed form
  ``(next matchable position << 16) | dist`` (``build_chains``). Both
  equal the JAX builders element for element. Their port is torch ops
  (``build_dist_chains_plain``), except the split encode's hashed layout
  on the card: the port's own kernels, ``csrc/chain_build.cu`` (two
  kernels around one u32 segmented sort).
- The sequence walk, TPU kernel ``_make_kernel`` (``:366``, run by
  ``encode_blocks_hybrid``, ``pl.pallas_call`` at ``:604``): per sequence,
  jump to the next matchable position, extend the match, emit the
  sequence. ``hybrid_walk`` launches its CUDA port (``lz4t_hybrid_encode``
  in ``csrc/greedy_encode.cu``, sharing the greedy encoder's emitter) on a
  CUDA tensor or raises; on a CPU tensor it runs ``hybrid_walk_plain``, the
  same function in plain PyTorch. With exact-word chains its streams are
  byte-identical to the split encode's with ``exact=True``. The kernel walks
  each row in WALK_WARPS segments at once and stitches them;
  ``hybrid_walk_segmented_plain`` renders that algorithm for the tests.

Rows are a batch dimension (the JAX code vmaps one row). The JAX code does
its hash and fingerprint math in uint32; here every such value lives in an
int64 tensor holding a u32 and is masked to 32 bits after each multiply,
add, subtract and cumsum (torch lacks uint32 shifts and comparisons on the
CPU). ``_mul32`` splits each product so no int64 product overflows.
Position keys carry the position in their low bits, so every sort key is
unique and ``torch.sort`` reproduces ``jax.lax.sort``'s order exactly.
"""

from __future__ import annotations

import bisect
import ctypes
import functools

import numpy as np
import torch

from .._build import load_library
from .._device import resolve_device
from ..constants import (LAST_LITERALS, MF_LIMIT, MIN_MATCH, WINDOW_SIZE,
                         block_bound)
from ..tracing import count
from .emit import EXT_STEP, ext_count, extend, serialize

_M32 = 0xFFFFFFFF

# Rows per chain-builder call. The torch ops hold ~20 int64 [rows, N]
# temporaries alive at once: at 128 rows of 64 KB that is 64 MB each
# (128 MB with a 64 KB history prefix), ~1.3-2.6 GB at peak, whatever the
# frame's size; the CUDA builder three u32 [rows, N] arrays (96-192 MB).
CHAIN_CHUNK_ROWS = 128

# encode_xla.py:56-58 — odd polynomial base and its inverse mod 2**32.
_B1 = 0x9E3779B1
_B1_INV = pow(_B1, -1, 1 << 32)

# Sort-predecessors scored per position (hybrid_encode.py:224).
PREDS = (1, 2, 3, 4, 6, 8)

# Segments (warps) per row of the CUDA walk, the kernel's W (32 measured
# fastest of 8, 16 and 32, PERF.md section 6).
WALK_WARPS = 32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for u32 values held in int64 (b: tensor or int).
    Split at 16 bits so every partial product stays below 2**49."""
    lo = b & 0xFFFF
    hi = b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _pows(base: int, n: int, device) -> torch.Tensor:
    """[base**0, ..., base**(n-1)] mod 2**32 by binary exponentiation
    (encode_xla.py:74), as int64."""
    e = torch.arange(n, dtype=torch.int64, device=device)
    acc = torch.ones(n, dtype=torch.int64, device=device)
    sq = base & _M32
    for k in range(max(1, (n - 1).bit_length()) + 1):
        acc = torch.where(((e >> k) & 1) == 1, _mul32(acc, sq), acc)
        sq = (sq * sq) & _M32
    return acc


def _shifted(a: torch.Tensor, k: int, fill: int = 0) -> torch.Tensor:
    """out[:, j] = a[:, j - k], with *fill* in the first k columns."""
    pad = torch.full((a.shape[0], k), fill, dtype=a.dtype, device=a.device)
    return torch.cat([pad, a[:, :-k]], dim=1)


def _cand_rows(work: torch.Tensor, src_len: torch.Tensor, hist_len: int,
               hist_start: torch.Tensor, hashed: bool = False):
    """Batched ``_cand_row``: for every position of every row, the scored
    best previous same-word occurrence.

    work: int64[R, N] bytes ([history | payload]); src_len, hist_start:
    int64[R]. Returns (valid bool[R, N], dist int64[R, N]) over all N
    positions, exactly as hybrid_encode.py:132-313 does per row."""
    R, N = work.shape
    if N > (1 << 17):
        raise ValueError(f"row width {N} > 2**17: positions pack in 17 bits")
    dev = work.device
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    s_end = (hist_len + src_len)[:, None]
    mf_limit = s_end - MF_LIMIT

    b = work
    bp = torch.nn.functional.pad(b, (0, 3))
    w = (bp[:, :N] | (bp[:, 1:N + 1] << 8) | (bp[:, 2:N + 2] << 16)
         | (bp[:, 3:N + 3] << 24))
    invalid = (idx + MIN_MATCH > s_end) | (idx < hist_start[:, None])

    # Prefix fingerprints: h_d[p] hashes the whole range [p, p+d).
    inv1 = _pows(_B1_INV, N + 1, dev)
    pw1 = _pows(_B1, N + 1, dev)
    c1 = torch.cat([torch.zeros((R, 1), dtype=torch.int64, device=dev),
                    torch.cumsum(b * inv1[:N], dim=1) & _M32], dim=1)

    def _range_hash(d):
        hi = torch.cat([c1[:, d:],
                        torch.zeros((R, max(d - 1, 0)), dtype=torch.int64,
                                    device=dev)], dim=1)[:, :N]
        return _mul32((hi - c1[:, :N]) & _M32, pw1[:N])

    def _tier(d):
        return (_mul32(_range_hash(d // 2), 0x9E3779B1)
                + _range_hash(d)) & _M32

    t16, t64, t256 = _tier(16), _tier(64), _tier(256)

    # Run-interior positions (the word repeats within 4 bytes).
    interior = torch.zeros((R, N), dtype=torch.bool, device=dev)
    for p in (1, 2, 3, 4):
        interior[:, p:] |= w[:, p:] == w[:, :-p]

    best_key = torch.full((R, N), -1, dtype=torch.int64, device=dev)
    best_cand = torch.full((R, N), -1, dtype=torch.int64, device=dev)

    if hashed:
        ibits = (N - 1).bit_length()
        hbits = 30 - ibits
        mask = (1 << ibits) - 1
        wc8 = _mul32(w, 0x85EBCA77) >> 24                  # word check
        fp16 = _mul32(t16, 0x9E3779B1) >> 23               # 9-bit tier 16
        fp64 = _mul32(t64, 0x85EBCA77) >> 24               # 8-bit tier 64
        fp256 = _mul32(t256, 0xC2B2AE3D) >> 25             # 7-bit tier 256
        pay = (wc8 << 24) | (fp16 << 15) | (fp64 << 7) | fp256
        h = _mul32(w, 0x9E3779B1) >> (32 - hbits)
        key = ((h << (ibits + 2)) | (invalid.long() << (ibits + 1))
               | (interior.long() << ibits) | idx)
        skey, order = torch.sort(key, dim=1)
        spay = torch.gather(pay, 1, order)
        si = skey & mask
        for k in PREDS:
            pkey = _shifted(skey, k, fill=_M32)
            ppay = _shifted(spay, k)
            pi = pkey & mask
            pgood = ((pkey >> (ibits + 1)) & 1) == 0
            bucket = (pkey >> (ibits + 2)) == (skey >> (ibits + 2))
            wc_eq = (ppay >> 24) == (spay >> 24)
            dist = si - pi
            ok = pgood & bucket & wc_eq & (dist > 0) & (dist < WINDOW_SIZE)
            m16 = ok & (((ppay >> 15) & 0x1FF) == ((spay >> 15) & 0x1FF))
            m64 = m16 & (((ppay >> 7) & 0xFF) == ((spay >> 7) & 0xFF))
            m256 = m64 & ((ppay & 0x7F) == (spay & 0x7F))
            sc = 4 + m16.long() * 16 + m64.long() * 64 + m256.long() * 256
            keysc = torch.where(ok, sc * 16 + (15 - k), -1)
            better = keysc > best_key
            best_key = torch.where(better, keysc, best_key)
            best_cand = torch.where(better, pi, best_cand)
    else:
        fp13 = _mul32(t16, 0x85EBCA77) >> 19               # 13-bit tier 16
        sAB = (t64 & 0xFFFF0000) | (t256 >> 16)             # 16+16 payload
        idx2 = ((invalid.long() << 31) | (interior.long() << 30)
                | (idx << 13) | fp13)
        # Lexicographic (w, idx2) as one int64: w is shifted down by 2**31
        # so that w * 2**32 fits a signed int64 without changing the order.
        key = (w - (1 << 31)) * (1 << 32) + idx2
        _, order = torch.sort(key, dim=1)
        sw = torch.gather(w, 1, order)
        si2 = torch.gather(idx2, 1, order)
        ssAB = torch.gather(sAB, 1, order)
        si = (si2 >> 13) & 0x1FFFF
        for k in PREDS:
            # The fill has the bad bit set: slots before the first k
            # entries never take a padding candidate.
            pi2 = _shifted(si2, k, fill=_M32)
            pw = _shifted(sw, k)
            pi = (pi2 >> 13) & 0x1FFFF
            pgood = pi2 < (1 << 31)
            dist = si - pi
            ok = pgood & (pw == sw) & (dist > 0) & (dist < WINDOW_SIZE)
            m16 = (pi2 & 0x1FFF) == (si2 & 0x1FFF)
            psAB = _shifted(ssAB, k)
            m64 = m16 & ((psAB >> 16) == (ssAB >> 16))
            m256 = m64 & ((psAB & 0xFFFF) == (ssAB & 0xFFFF))
            sc = 4 + m16.long() * 16 + m64.long() * 64 + m256.long() * 256
            keysc = torch.where(ok, sc * 16 + (15 - k), -1)
            better = keysc > best_key
            best_key = torch.where(better, keysc, best_key)
            best_cand = torch.where(better, pi, best_cand)

    # Un-sort. si is a permutation of 0..N-1 per row, so a scatter over it
    # is the exact inverse of the JAX code's second sort.
    recv_ok = (idx >= hist_len) & (idx < mf_limit)
    if N <= (1 << 16):
        dist_s = torch.where(best_cand >= 0, si - best_cand, 0)
        dist = torch.empty_like(dist_s).scatter_(1, si, dist_s)
        return (dist > 0) & recv_ok, dist
    cand = torch.empty_like(best_cand).scatter_(1, si, best_cand)
    valid = (cand >= 0) & (idx - cand < WINDOW_SIZE) & recv_ok
    return valid, idx - cand


def _dist_rows(work: torch.Tensor, src_len: torch.Tensor, hist_len: int,
               hist_start: torch.Tensor, hashed: bool = False
               ) -> torch.Tensor:
    """u16 per-payload-position match distance per row (0 = no match)."""
    valid, dist = _cand_rows(work, src_len, hist_len, hist_start, hashed)
    return torch.where(valid[:, hist_len:], dist[:, hist_len:], 0) \
        .to(torch.uint16)


def build_dist_chains(work: torch.Tensor, lens: torch.Tensor, hist_len: int,
                      hist_start, hashed: bool = True,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """u16 dist-only chains: int[nb, N] work -> uint16[nb, N - hist_len].

    Same contract as the JAX ``build_dist_chains``: *hist_start* is an int
    or an int[nb] (first valid history index per row); ``hashed=True`` is
    the production hashed-bucket layout, ``hashed=False`` exact words.
    The hashed layout on a CUDA tensor runs the CUDA builder
    (``csrc/chain_build.cu``: the rows as u8, N <= 2**17) or raises; on the
    CPU, and for exact words, the torch ops (``build_dist_chains_plain``).
    *out*, a contiguous uint16[nb, N - hist_len] on work's device, takes
    the result (the kernel writes it in place). On CUDA nothing
    synchronises; ``launches`` counts the kernel's calls."""
    if hashed and work.device.type == "cuda":
        return _dist_chains_cuda(work, lens, hist_len, hist_start, out)
    chains = build_dist_chains_plain(work, lens, hist_len, hist_start,
                                     hashed)
    return chains if out is None else out.copy_(chains)


build_dist_chains.launches = 0


def build_dist_chains_plain(work: torch.Tensor, lens: torch.Tensor,
                            hist_len: int, hist_start,
                            hashed: bool = True) -> torch.Tensor:
    """build_dist_chains as int64 torch ops, on any device."""
    work = work.to(torch.int64)
    lens = lens.to(device=work.device, dtype=torch.int64)
    hs = torch.as_tensor(hist_start, dtype=torch.int64, device=work.device)
    hs = hs.expand(work.shape[0]).contiguous()
    return _dist_rows(work, lens, hist_len, hs, hashed)


@functools.lru_cache(maxsize=None)
def _chain_lib():
    lib = load_library("chain_build")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.lz4t_chain_sort_bytes.argtypes = [i64, i64, p]
    lib.lz4t_chain_sort_bytes.restype = ctypes.c_int
    lib.lz4t_chain_build.argtypes = [p, i64, i64, i64, p, p, p, p, p, p, p,
                                     i64, p, p]
    lib.lz4t_chain_build.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _sort_bytes(nb: int, n: int) -> int:
    """The cub scratch bytes of the segmented sort of nb rows of n keys."""
    size = ctypes.c_int64(0)
    rc = _chain_lib().lz4t_chain_sort_bytes(nb, n, ctypes.byref(size))
    if rc != 0:
        raise RuntimeError(f"chain_build sort query failed: cudaError {rc}")
    return size.value


_INT_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


def _dist_chains_cuda(work, lens, hist_len, hist_start, out):
    if work.dtype not in _INT_DTYPES or work.dim() != 2 \
            or not work.is_contiguous():
        raise ValueError("work must be a contiguous int[nb, N] on the card")
    work = work.to(torch.uint8)      # the values are bytes by contract
    nb, n = work.shape
    if not 0 <= hist_len <= n or n > (1 << 17) or nb * n >= (1 << 31):
        raise ValueError(f"rows of {n} bytes with hist_len={hist_len} "
                         f"(nb={nb}): the kernel takes hist_len <= N <= "
                         "2**17 and nb * N < 2**31")
    dev = work.device
    lens = lens.to(device=dev, dtype=torch.int64).contiguous()
    hs = torch.as_tensor(hist_start, dtype=torch.int64, device=dev)
    hs = hs.expand(nb).contiguous()
    if tuple(lens.shape) != (nb,):
        raise ValueError(f"lens must be an int[{nb}]")
    if out is None:
        out = torch.empty((nb, n - hist_len), dtype=torch.uint16, device=dev)
    elif (out.dtype != torch.uint16 or tuple(out.shape) != (nb, n - hist_len)
          or not out.is_contiguous() or out.device != dev):
        raise ValueError(f"out must be a contiguous uint16[{nb}, "
                         f"{n - hist_len}] on {dev}")
    if nb == 0:
        return out
    keys, keys_alt, pay = torch.empty((3, nb * n), dtype=torch.int32,
                                      device=dev)
    offsets = torch.empty(nb + 1, dtype=torch.int32, device=dev)
    temp = torch.empty(max(_sort_bytes(nb, n), 1), dtype=torch.uint8,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _chain_lib().lz4t_chain_build(
            work.data_ptr(), nb, n, hist_len, lens.data_ptr(), hs.data_ptr(),
            keys.data_ptr(), keys_alt.data_ptr(), pay.data_ptr(),
            offsets.data_ptr(), temp.data_ptr(), temp.numel(),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"chain_build kernel launch failed: cudaError {rc}")
    build_dist_chains.launches += 1
    count("chain_kernel_rows", nb)
    return out


def _chain_rows(work: torch.Tensor, src_len: torch.Tensor, hist_len: int,
                hist_start: torch.Tensor) -> torch.Tensor:
    """Batched ``_chain_row`` (hybrid_encode.py:79-129): the packed greedy
    chain, entry a = ``(m << 16) | dist`` for the first matchable payload
    position m >= a, or -1 (the u32 0xFFFFFFFF, so m reads 0xFFFF) when
    none remains. Exact-word candidates: a chain match's first MIN_MATCH
    bytes are equal by construction."""
    valid, dist = _cand_rows(work, src_len, hist_len, hist_start)
    cap = work.shape[1] - hist_len
    ip = torch.arange(cap, dtype=torch.int64, device=work.device)
    packed = torch.where(valid[:, hist_len:],
                         (ip << 16) | dist[:, hist_len:], _M32)
    # Reverse cummin in int64 (torch has no uint32 cummin): the minimum of
    # (pos << 16 | dist) over positions >= a is the nearest valid one's.
    chain = torch.cummin(packed.flip(1), 1).values.flip(1)
    # astype(int32) as JAX wraps it: values >= 2**31 map to value - 2**32.
    return torch.where(chain >= 1 << 31, chain - (1 << 32), chain) \
        .to(torch.int32)


def build_chains(work: torch.Tensor, lens: torch.Tensor, hist_len: int,
                 hist_start) -> torch.Tensor:
    """Packed chains: int[nb, hist_len + B] work -> int32[nb, B], B <=
    65536 (positions pack in 16 bits). Same contract as the JAX
    ``build_chains``; *hist_start* is an int or an int[nb]."""
    B = work.shape[1] - hist_len
    if B > hybrid_max_bs():
        raise ValueError(f"payload width {B} > {hybrid_max_bs()}: the chain "
                         "packs payload positions in 16 bits")
    work = work.to(torch.int64)
    lens = lens.to(device=work.device, dtype=torch.int64)
    hs = torch.as_tensor(hist_start, dtype=torch.int64, device=work.device)
    hs = hs.expand(work.shape[0]).contiguous()
    return _chain_rows(work, lens, hist_len, hs)


def hybrid_max_bs() -> int:
    """Largest block the walk takes: the chain packs payload positions as
    u16 (hybrid_encode.py:526)."""
    return WINDOW_SIZE


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("greedy_encode").lz4t_hybrid_encode
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, i64, i64, p, p, i64, p, p, p, p, i64, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check_walk(work, lens, chains, hist_len):
    if work.dtype != torch.uint8 or work.dim() != 2 \
            or not work.is_contiguous():
        raise ValueError("work must be a contiguous u8[nb, hist_len + B]")
    nb, B = work.shape[0], work.shape[1] - hist_len
    if hist_len < 0 or not 1 <= B <= hybrid_max_bs():
        raise ValueError(f"payload width {B} (work rows of {work.shape[1]} "
                         f"bytes, hist_len={hist_len}) is not in [1, "
                         f"{hybrid_max_bs()}]")
    if (lens.dtype != torch.int64 or tuple(lens.shape) != (nb,)
            or not lens.is_contiguous()):
        raise ValueError("lens must be a contiguous i64[nb]")
    if (chains.dtype != torch.int32 or tuple(chains.shape) != (nb, B)
            or not chains.is_contiguous()):
        raise ValueError(f"chains must be a contiguous i32[nb, {B}]")
    if lens.device != work.device or chains.device != work.device:
        raise ValueError("all inputs must be on one device")


def hybrid_walk(work: torch.Tensor, lens: torch.Tensor,
                chains: torch.Tensor, hist_len: int = 0):
    """Walk each row's packed chain (``build_chains`` of the same rows) and
    emit its LZ4 block.

    work u8[nb, hist_len + B] ([history | payload] rows); lens i64[nb]
    payload sizes; chains i32[nb, B]. Returns (out u8[nb, block_bound(B)],
    out_lens i64[nb], meta i64[nb, 4]): ``out[b, :out_lens[b]]`` is the
    block's stream and the rest of the row zero (the TPU kernel leaves
    wild writes there); an empty row encodes to nothing. meta holds the
    TPU kernel's meta lanes 1-4: the trailing token's position, the
    trailing literal count, and the last match sequence's stream offset
    and payload anchor (-1 where there is none). On CUDA the kernel is
    queued on the current stream and nothing synchronises; ``launches``
    counts those launches, and ``last_rewalked`` holds the last launch's
    i64[nb]: the sequences its stitch walked again per row."""
    _check_walk(work, lens, chains, hist_len)
    if work.device.type == "cpu":
        return hybrid_walk_plain(work, lens, chains, hist_len)
    if work.device.type != "cuda":
        raise ValueError(f"no hybrid encode for device {work.device}")
    nb, B = work.shape[0], work.shape[1] - hist_len
    dev = work.device
    ow = block_bound(B)
    out = torch.empty((nb, ow), dtype=torch.uint8, device=dev)
    out_lens = torch.empty(nb, dtype=torch.int64, device=dev)
    meta = torch.empty((nb, 4), dtype=torch.int64, device=dev)
    if nb == 0:
        return out, out_lens, meta
    rewalked = torch.empty(nb, dtype=torch.int64, device=dev)
    # a row's walk has at most B / 4 + 1 sequences: the stitch's scratch
    redo = torch.empty((nb, B // 4 + 2), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(work.data_ptr(), nb, work.shape[1], hist_len,
                lens.data_ptr(), chains.data_ptr(), ow, out.data_ptr(),
                out_lens.data_ptr(), meta.data_ptr(), redo.data_ptr(),
                redo.shape[1], rewalked.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hybrid_encode kernel launch failed: "
                           f"cudaError {rc}")
    hybrid_walk.launches += 1
    hybrid_walk.last_rewalked = rewalked
    return out, out_lens, meta


hybrid_walk.launches = 0
hybrid_walk.last_rewalked = None


def hybrid_walk_plain(work: torch.Tensor, lens: torch.Tensor,
                      chains: torch.Tensor, hist_len: int = 0):
    """hybrid_walk in plain PyTorch (any device): one batched torch step
    per sequence, recording each row's hit columns; then one vectorized
    pass writes every sequence (``emit.serialize``)."""
    _check_walk(work, lens, chains, hist_len)
    dev = work.device
    nb, B = work.shape[0], work.shape[1] - hist_len
    src_len = lens.clamp(0, B)
    byts = work.to(torch.int64)
    chain = chains.to(torch.int64) & _M32
    rows = torch.arange(nb, device=dev)
    mf_limit = src_len - MF_LIMIT
    match_limit = src_len - LAST_LITERALS
    e = chain[:, 0]
    m, dist = e >> 16, e & 0xFFFF
    anchor = torch.zeros_like(m)
    none = torch.full_like(m, -1)
    last_anchor, last_size = none, torch.zeros_like(m)
    hits = []          # per sequence: (hit, anchor, lit_len, offset, mlen)
    while bool((m < mf_limit).any()):
        live = m < mf_limit
        at = hist_len + m + MIN_MATCH
        mlen = MIN_MATCH + extend(byts, at, at - dist,
                                  hist_len + match_limit, live)
        lit = m - anchor
        hits.append((live, anchor, lit, dist, mlen))
        size = 3 + ext_count(lit) + lit + ext_count(mlen - MIN_MATCH)
        last_anchor = torch.where(live, anchor, last_anchor)
        last_size = torch.where(live, size, last_size)
        anchor = torch.where(live, m + mlen, anchor)
        e = chain[rows, anchor.clamp(max=B - 1)]
        m = torch.where(live, e >> 16, m)
        dist = torch.where(live, e & 0xFFFF, dist)
    out, out_lens = serialize(work[:, hist_len:], src_len, hits, anchor,
                              block_bound(B))
    tail = src_len - anchor
    token_pos = torch.where(src_len > 0,
                            out_lens - 1 - ext_count(tail) - tail, 0)
    last_d = torch.where(last_anchor >= 0, token_pos - last_size, none)
    return out, out_lens, torch.stack([token_pos, tail, last_d,
                                       last_anchor], 1)


def _extend_row(row, a, b, limit):
    """The first k >= 0 with a + k >= limit or row[a + k] != row[b + k]
    (b < a), in steps of EXT_STEP bytes."""
    k = 0
    while True:
        n = min(EXT_STEP, limit - (a + k))
        if n <= 0:
            return k
        neq = (row[a + k: a + k + n] != row[b + k: b + k + n]).nonzero()
        if len(neq):
            return k + int(neq[0])
        k += n


def _segmented_row(row, hist_len, chain, n, segments):
    """One row of hybrid_walk_segmented_plain: [(start anchor, re-walked
    sequences, kept sequences)] per segment, each sequence (m, mlen - 4),
    and the final anchor."""
    mf_limit, match_limit = n - MF_LIMIT, n - LAST_LITERALS
    S = -(-n // segments)

    def step(a):
        e = chain[a]
        m = e >> 16
        if m >= mf_limit:
            return None                  # no match left in the row
        at = hist_len + m + MIN_MATCH
        return m, _extend_row(row, at, at - (e & 0xFFFF),
                              hist_len + match_limit)

    def end(sq):
        return sq[0] + MIN_MATCH + sq[1]

    lists, exits = [], []
    for w in range(segments):            # the speculative walks
        a, lst = min(w * S, n), []
        hi = min(a + S, n)
        while a < hi:
            sq = step(a)
            if sq is None:
                break
            lst.append(sq)
            a = end(sq)
        lists.append(lst)
        exits.append(a)
    groups = [(0, [], lists[0])]
    x, ended = exits[0], False
    for g in range(1, segments):         # the stitch, in segment order
        start, redo, lst = x, [], lists[g]
        keep = len(lst)
        while not ended and x < exits[g]:
            j = bisect.bisect_left([m for m, _ in lst], x)
            if j < len(lst) and (min(g * S, n) if j == 0
                                 else end(lst[j - 1])) <= x:
                keep, x = j, exits[g]    # x lies in sequence j's gap
                break
            sq = step(x)
            if sq is None:
                ended = True
                break
            redo.append(sq)
            x = end(sq)
        groups.append((start, redo, lst[keep:]))
    return groups, x


def hybrid_walk_segmented_plain(work: torch.Tensor, lens: torch.Tensor,
                                chains: torch.Tensor, hist_len: int = 0,
                                segments: int = WALK_WARPS):
    """The CUDA walk's algorithm in plain PyTorch, for the tests: each row
    walked speculatively in *segments* segments, stitched in order (a
    segment's list is kept from the sequence whose gap [anchor, m] holds
    the true entry anchor, else the walk goes on from it), the groups'
    sizes summed and scanned into stream offsets. Returns hybrid_walk's
    (out, out_lens, meta), out_lens and meta from those offsets, and the
    re-walked sequences per row."""
    _check_walk(work, lens, chains, hist_len)
    dev = work.device
    nb, B = work.shape[0], work.shape[1] - hist_len
    src_len = lens.clamp(0, B)
    chain = (chains.to(torch.int64) & _M32).tolist()
    seqs, out_lens, meta, rewalked, tails = [], [], [], [], []
    for r in range(nb):
        n = int(src_len[r])
        groups, x = _segmented_row(work[r].to(torch.int64), hist_len,
                                   chain[r], n, segments)
        rows, totals = [], []
        for start, redo, kept in groups:
            at, size = start, 0
            for m, k in redo + kept:
                lit = m - at
                rows.append((at, lit, chain[r][m] & 0xFFFF, k + MIN_MATCH))
                size += 3 + _ext(lit) + lit + _ext(k)
                at = m + MIN_MATCH + k
            totals.append(size)
        base = np.cumsum([0] + totals)      # each group's stream offset
        tot, tail = int(base[-1]), n - x
        sizes = [3 + _ext(lit) + lit + _ext(ml - MIN_MATCH)
                 for _, lit, _, ml in rows]
        last_d = tot - sizes[-1] if rows else -1
        meta.append([tot, tail, last_d, rows[-1][0] if rows else -1])
        out_lens.append(tot + 1 + _ext(tail) + tail if n else 0)
        rewalked.append(sum(len(g[1]) for g in groups))
        seqs.append(rows)
        tails.append(x)
    width = max([len(s) for s in seqs] + [0])
    cols = torch.zeros((5, nb, width), dtype=torch.int64)
    for r, rows in enumerate(seqs):
        if rows:
            cols[1:, r, : len(rows)] = torch.tensor(rows).T
            cols[0, r, : len(rows)] = 1
    cols = cols.to(dev)
    hits = [(cols[0, :, c] == 1, cols[1, :, c], cols[2, :, c],
             cols[3, :, c], cols[4, :, c]) for c in range(width)]
    out, _ = serialize(work[:, hist_len:], src_len, hits,
                       torch.tensor(tails, dtype=torch.int64, device=dev),
                       block_bound(B))
    return (out, torch.tensor(out_lens, dtype=torch.int64, device=dev),
            torch.tensor(meta, dtype=torch.int64, device=dev).view(nb, 4),
            torch.tensor(rewalked, dtype=torch.int64, device=dev))


def _ext(v: int) -> int:
    """ext_count of one int."""
    return 1 + (v - 15) // 255 if v >= 15 else 0


def encode_blocks_hybrid(work: torch.Tensor, lens: torch.Tensor,
                         block_size: int, hist_len: int = 0, hist_start=0):
    """Encode a batch of blocks with the hybrid engine: exact-word packed
    chains (``build_chains``, CHAIN_CHUNK_ROWS rows a call) then one walk
    over every row (``hybrid_walk``).

    work u8[nb, hist_len + block_size]; lens i64[nb]; hist_start the first
    valid history index, an int or an int[nb]. Returns hybrid_walk's
    (out, out_lens, meta) on the inputs' device. Refuses block_size >
    hybrid_max_bs() with ValueError."""
    return hybrid_walk(work, lens,
                       _chunked_chains(work, lens, block_size, hist_len,
                                       hist_start), hist_len)


def encode_blocks_hybrid_plain(work: torch.Tensor, lens: torch.Tensor,
                               block_size: int, hist_len: int = 0,
                               hist_start=0):
    """encode_blocks_hybrid with the walk's plain version."""
    return hybrid_walk_plain(work, lens,
                             _chunked_chains(work, lens, block_size,
                                             hist_len, hist_start), hist_len)


def _chunked_chains(work, lens, block_size, hist_len, hist_start):
    nb = work.shape[0]
    if work.dim() != 2 or work.shape[1] != hist_len + block_size:
        raise ValueError(f"work rows of {work.shape[-1]} bytes do not hold "
                         f"hist_len={hist_len} + block_size={block_size}")
    hs = torch.as_tensor(hist_start, dtype=torch.int64, device=work.device)
    hs = hs.expand(nb).contiguous()
    chains = torch.empty((nb, block_size), dtype=torch.int32,
                         device=work.device)
    for i in range(0, nb, CHAIN_CHUNK_ROWS):
        rows = slice(i, min(i + CHAIN_CHUNK_ROWS, nb))
        chains[rows] = build_chains(work[rows], lens[rows], hist_len,
                                    hs[rows])
    return chains


def encode_block_hybrid_host(data, history=None, block_size=None, *,
                             device="cuda") -> np.ndarray:
    """One block in, its LZ4 stream out (numpy), for tests
    (hybrid_encode.py:617-638): *history* (the last 64 KB count) sits
    right-aligned in a 64 KB prefix; block_size defaults to len(data)
    rounded up to 1 KB."""
    dev = resolve_device(device)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    B = -(-max(n, 1024) // 1024) * 1024 if block_size is None else block_size
    use_hist = history is not None and len(history) > 0
    hist_len = WINDOW_SIZE if use_hist else 0
    hist_start = 0
    work = np.zeros((1, hist_len + B), np.uint8)
    if use_hist:
        h = np.asarray(history, np.uint8)[-WINDOW_SIZE:]
        hist_start = WINDOW_SIZE - len(h)
        work[0, hist_start:hist_len] = h
    work[0, hist_len: hist_len + n] = data
    out, out_lens, _ = encode_blocks_hybrid(
        torch.from_numpy(work).to(dev),
        torch.tensor([n], dtype=torch.int64, device=dev), B, hist_len,
        hist_start)
    return out[0, : int(out_lens[0])].cpu().numpy()
