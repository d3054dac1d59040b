"""engine="xla" block encode: sort-based match finding and a greedy parse
by pointer doubling, as torch ops.

Port of ``divortio_lz4_tpu/ops/encode_xla.py`` (``encode_block``,
``encode_blocks_batch``, ``encode_block_host``). In the JAX package this
encoder is plain XLA, not Pallas, so its port is torch ops: on a CUDA
tensor every step runs on the card. Rows are a batch dimension (the JAX
code vmaps one row). The pipeline:

1. Window words: the LE32 word at every position.
2. Candidates: one sort of (invalid, word, position); a position's
   candidate is its sort predecessor when both hold the same valid word.
   The three keys pack into one int64 (1 + 32 + 23 bits), every key is
   unique, so ``torch.sort`` gives ``lax.sort``'s order exactly; the
   unsort is a scatter over the sorted positions (a permutation).
3. Match lengths: 16 bytes checked word by word; with ``use_fingerprints``
   a binary search over a 32-bit rolling-hash prefix (LCE), an exact
   4-byte end check, and match inheritance from the previous extended
   position.
4. The greedy parse: the orbit of the payload start under next anchor,
   by pointer doubling.
5. Serialization by zone scatter and a cummax fill.

Exactness as in ``ops/decode_xla.py``: clamped gathers for
``mode="clip"``, one spare slot for ``mode="drop"``, int64 values (the
JAX int32 never wraps: every value is below 2**28), and the hash math in
uint32 held in int64 and masked after every multiply, add and cumsum
(``hybrid_encode._mul32``, ``_pows``). JAX's row width N = hist_len + cap
enters the clips and the round caps, so callers keep JAX's widths.

The two while-loops (the LCE search, the orbit) keep JAX's round caps
(``_ceil_log2(cap) + 2``, ``_ceil_log2(N) + 1``) and exit tests, read on
the host once a round. Rows run together until all have converged: a
converged search lane keeps ``lo`` (mid clamps to lo, which fails the
``mid > lo`` test) and an orbit round that gains nothing is closed, so
the rows that finished first end as JAX's vmapped loop leaves them. The
search runs over the first K lanes only, K the most positions any row of
the chunk sends to it (one more sync); lanes past a row's count are idle
in JAX (lo = hi = 16) and never read. ``encode_blocks_batch.last_rounds``
holds the last call's rounds and host syncs.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..constants import (LAST_LITERALS, MF_LIMIT, MIN_MATCH, WINDOW_SIZE,
                         block_bound)
from .decode_xla import (XLA_CHUNK_POSITIONS, _ceil_log2, _orbit, _rev_cummin,
                         _shift_up, _slot, _take)
from .hybrid_encode import _B1, _B1_INV, _M32, _mul32, _pows

# Sort key: invalid << 55 | word << 23 | position.
_POS_BITS = 23


def _ext_bytes(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v < 15, 0, 1 + (v - 15).clamp(min=0) // 255)


def _ext_payload(code: torch.Tensor) -> torch.Tensor:
    return (_ext_bytes(code) << 8) | ((code - 15).clamp(min=0) % 255)


def _encode_rows(work: torch.Tensor, src_len: torch.Tensor, hist_len: int,
                 use_fingerprints: bool, hist_start: torch.Tensor):
    """encode_xla.py:87-381 for rows: work int[R, N], src_len and
    hist_start i64[R]. Returns (out u8[R, block_bound(N - hist_len)],
    out_len i64[R], LCE rounds, orbit rounds, syncs)."""
    R, N = work.shape
    dev = work.device
    cap = N - hist_len
    W_OUT = block_bound(cap)
    b = work.long()
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    src = src_len.long()[:, None]
    s_end = hist_len + src
    mf_limit = s_end - MF_LIMIT
    match_limit = s_end - LAST_LITERALS
    syncs = 0

    # ---- 1. window words ----
    w = (b + (_shift_up(b, 1) << 8) + (_shift_up(b, 2) << 16)
         + (_shift_up(b, 3) << 24))
    invalid = (idx + MIN_MATCH > s_end) | (idx < hist_start.long()[:, None])

    # ---- 2. candidates: the nearest previous identical word ----
    key = (invalid.long() << (32 + _POS_BITS)) | (w << _POS_BITS) | idx
    del invalid
    skey = torch.sort(key, dim=1).values     # unique keys: order exact
    del key
    sbad = skey >> (32 + _POS_BITS)
    sw = (skey >> _POS_BITS) & _M32
    si = skey & ((1 << _POS_BITS) - 1)
    del skey
    same = (sw[:, 1:] == sw[:, :-1]) & (sbad[:, 1:] == 0) & (sbad[:, :-1] == 0)
    del sw, sbad
    cand_sorted = torch.full((R, N), -1, dtype=torch.int64, device=dev)
    cand_sorted[:, 1:] = torch.where(same, si[:, :-1], -1)
    del same
    cand = torch.empty_like(cand_sorted).scatter_(1, si, cand_sorted)
    del si, cand_sorted

    dist = idx - cand
    has_cand = ((cand >= 0) & (dist < WINDOW_SIZE) & (idx >= hist_len)
                & (idx < mf_limit))

    # ---- 3. exact match lengths ----
    c = cand.clamp(min=0)
    del cand
    eq4 = _shift_up(w, 4) == _take(w, c + 4)
    eq8 = _shift_up(w, 8) == _take(w, c + 8)
    eq12 = _shift_up(w, 12) == _take(w, c + 12)
    first_bad_word = torch.where(~eq4, 4, torch.where(
        ~eq8, 8, torch.where(~eq12, 12, 16)))
    del eq4, eq8, eq12
    xor_w = _take(w, idx + first_bad_word) ^ _take(w, c + first_bad_word)
    byte_eq = torch.where(
        xor_w == 0, 4, torch.where(
            (xor_w & 0xFF) != 0, 0, torch.where(
                (xor_w & 0xFF00) != 0, 1, torch.where(
                    (xor_w & 0xFF0000) != 0, 2, 3))))
    direct_len = first_bad_word + byte_eq          # in [4, 20]
    del xor_w, byte_eq, first_bad_word

    lce_rounds = 0
    if use_fingerprints:
        inv1 = _pows(_B1_INV, N + 1, dev)
        pw1 = _pows(_B1, N + 1, dev)
        # b < 2**8 and inv1 < 2**32: N terms stay below 2**63 for N < 2**23
        c1 = torch.nn.functional.pad(
            torch.cumsum(b * inv1[:N], 1) & _M32, (1, 0))
        del inv1

        need = has_cand & (direct_len >= 16)
        needi = need.long()
        slot_raw = torch.cumsum(needi, 1) - needi
        K = max(1, int(needi.sum(1).max()))     # the widest row's count
        syncs += 1
        del needi
        slot = torch.where(need, slot_raw, K)
        ca = torch.zeros((R, K + 1), dtype=torch.int64, device=dev) \
            .scatter_(1, slot, idx.expand(R, N))[:, :K]
        cc = torch.zeros((R, K + 1), dtype=torch.int64, device=dev) \
            .scatter_(1, slot, c)[:, :K]
        del slot
        pw1_a, pw1_c = pw1[ca], pw1[cc]
        c1_a, c1_c = torch.gather(c1, 1, ca), torch.gather(c1, 1, cc)

        def range_eq(length):
            f1a = _mul32((_take(c1, ca + length) - c1_a) & _M32, pw1_a)
            f1c = _mul32((_take(c1, cc + length) - c1_c) & _M32, pw1_c)
            return f1a == f1c

        max_ext = (match_limit - ca).clamp(min=0)
        used = torch.arange(K, device=dev) < need.sum(1, keepdim=True)
        lo = torch.full((R, K), 16, dtype=torch.int64, device=dev)
        hi = torch.where(used, torch.maximum(max_ext + 1, lo), lo)
        del max_ext, used
        while lce_rounds < _ceil_log2(cap) + 2:
            syncs += 1
            if not bool((hi > lo + 1).any()):
                break
            mid = torch.minimum(torch.maximum((lo + hi) >> 1, lo),
                                torch.maximum(hi - 1, lo))
            ok = range_eq(mid) & (mid > lo)
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
            lce_rounds += 1
        # Exact end check: a hash collision during the search shows as
        # unequal last 4 bytes; such a lane falls back to 16.
        end_ok = _take(w, ca + lo - 4) == _take(w, cc + lo - 4)
        lo = torch.where(end_ok | (lo <= 16), lo, 16)
        del hi, c1, pw1_a, pw1_c, c1_a, c1_c, ca, cc, end_ok
        fp_full = _take(lo, slot_raw)
        own_len = torch.where(need, fp_full.clamp(min=16), direct_len)
        del fp_full, lo, slot_raw

        # Match inheritance from the previous LCE-extended position.
        pis = torch.cummax(torch.where(need, idx, -1), 1).values
        pis_c = pis.clamp(0, N - 1)
        inh_len = torch.gather(own_len, 1, pis_c) - (idx - pis_c)
        inh_d = torch.gather(dist, 1, pis_c)
        inh_ok = ((pis >= 0) & (inh_len >= MIN_MATCH) & (idx >= hist_len)
                  & (idx < mf_limit))
        del pis, pis_c, need
        use_inh = inh_ok & (inh_len > torch.where(has_cand, own_len, 0))
        raw_len = torch.where(use_inh, inh_len, own_len)
        dist = torch.where(use_inh, inh_d, dist)
        has_match = has_cand | use_inh
        del inh_len, inh_d, inh_ok, use_inh, own_len
    else:
        raw_len = direct_len
        has_match = has_cand
    del c, direct_len, has_cand

    mlen = torch.minimum(raw_len, (match_limit - idx).clamp(min=0))
    good = has_match & (mlen >= MIN_MATCH)
    mlen = torch.where(good, mlen, 0)
    del raw_len, has_match

    # ---- 4. greedy parse: the anchor chain's orbit ----
    nm = _rev_cummin(torch.where(good, idx, N))
    del good
    nm_c = nm.clamp(max=N - 1)
    m_len_at = torch.gather(mlen, 1, nm_c)
    terminal = nm >= N
    del nm, mlen
    nxt = torch.where(terminal, idx, nm_c + m_len_at).clamp(max=N - 1)
    nxt = torch.where(idx >= s_end, idx, nxt)
    reach0 = ((idx == hist_len) & (src > 0)).to(torch.int32)
    reach, orbit_rounds = _orbit(reach0, nxt, _ceil_log2(N) + 1)
    syncs += orbit_rounds
    del nxt, reach0
    anchor = (reach > 0) & (idx >= hist_len) & (idx < s_end)
    emit_match = anchor & ~terminal
    emit_tail = anchor & terminal
    del reach, anchor, terminal

    # ---- 5. serialization ----
    lcode = torch.where(emit_match, nm_c - idx, 0)
    mcode = torch.where(emit_match, m_len_at - MIN_MATCH, 0)
    offs = torch.where(emit_match, torch.gather(dist, 1, nm_c), 0)
    del nm_c, m_len_at, dist
    tail_lit = torch.where(emit_tail, s_end - idx, 0).sum(1, keepdim=True)
    last_end = torch.where(emit_tail, idx, 0).sum(1, keepdim=True)
    del emit_tail

    ext_l = _ext_bytes(lcode)
    seq_size = torch.where(
        emit_match, 1 + ext_l + lcode + 2 + _ext_bytes(mcode), 0)
    csum = torch.cumsum(seq_size, 1)
    seq_start = csum - seq_size
    body = csum[:, -1:]
    del csum, seq_size
    tail_ext = _ext_bytes(tail_lit)
    out_len = torch.where(src > 0, body + 1 + tail_ext + tail_lit, 0)

    drop = W_OUT
    tok_pos = torch.where(emit_match, seq_start, drop)
    litx_pos = torch.where(emit_match & (lcode >= 15), seq_start + 1, drop)
    lits_pos = torch.where(emit_match & (lcode > 0), seq_start + 1 + ext_l,
                           drop)
    off_pos = torch.where(emit_match, seq_start + 1 + ext_l + lcode, drop)
    mx_pos = torch.where(emit_match & (mcode >= 15),
                         seq_start + 1 + ext_l + lcode + 2, drop)
    del seq_start, ext_l, emit_match
    token_val = (lcode.clamp(max=15) << 4) | mcode.clamp(max=15)

    # tag << 28 | payload: 1 token, 2 literal-length and 5 match-length
    # extension (bytes << 8 | remainder), 3 literals (source start),
    # 4 offset; JAX's scatters in JAX's order
    pk = torch.zeros((R, W_OUT + 1), dtype=torch.int64, device=dev)
    for pos, val in ((tok_pos, (1 << 28) | token_val),
                     (litx_pos, (2 << 28) | _ext_payload(lcode)),
                     (lits_pos, (3 << 28) | idx.expand(R, N)),
                     (off_pos, (4 << 28) | offs),
                     (mx_pos, (5 << 28) | _ext_payload(mcode)),
                     (torch.where(src > 0, body, drop),
                      (1 << 28) | (tail_lit.clamp(max=15) << 4)),
                     (torch.where(tail_lit >= 15, body + 1, drop),
                      (2 << 28) | _ext_payload(tail_lit)),
                     (torch.where(tail_lit > 0, body + 1 + tail_ext, drop),
                      (3 << 28) | last_end)):
        pk.scatter_(1, _slot(pos, W_OUT), val)
    del tok_pos, litx_pos, lits_pos, off_pos, mx_pos, token_val, lcode, \
        mcode, offs
    pk = pk[:, :W_OUT]

    jW = torch.arange(W_OUT, dtype=torch.int64, device=dev)
    fill = torch.cummax(torch.where(pk > 0, jW, -1), 1).values \
        .clamp(0, W_OUT - 1)
    pk_f = torch.gather(pk, 1, fill)
    del pk
    tag_f = pk_f >> 28
    a_f = pk_f & ((1 << 28) - 1)
    rel = jW - fill
    del pk_f, fill
    ext_val = torch.where(rel < (a_f >> 8) - 1, 255, a_f & 0xFF)
    lit_val = _take(b, a_f + rel)
    off_val = torch.where(rel == 0, a_f & 0xFF, (a_f >> 8) & 0xFF)
    out = torch.where(tag_f == 1, a_f, torch.where(
        tag_f == 2, ext_val, torch.where(
            tag_f == 3, lit_val, torch.where(
                tag_f == 4, off_val, torch.where(tag_f == 5, ext_val, 0)))))
    out = torch.where(jW < out_len, out, 0).to(torch.uint8)
    return out, out_len[:, 0], lce_rounds, orbit_rounds, syncs


def encode_blocks_batch(work: torch.Tensor, src_len: torch.Tensor,
                        hist_len: int = 0, use_fingerprints: bool = True,
                        hist_start=0):
    """Encode a batch of LZ4 blocks (``encode_blocks_batch``).

    work: int[R, N] rows = [history (hist_len) | payload], payload bytes
    past src_len zero; src_len: int[R]; hist_start: the first valid
    history index, an int or an int[R]; candidates below it never match.
    Returns (out u8[R, block_bound(N - hist_len)], out_len i64[R]) on
    work's device, zeros past out_len; an empty row encodes to nothing."""
    R, N = work.shape
    if N >= 1 << _POS_BITS:
        raise ValueError(f"row width {N} >= 2**{_POS_BITS}: positions pack "
                         f"in {_POS_BITS} bits of the sort key")
    dev = work.device
    src_len = src_len.to(device=dev, dtype=torch.int64)
    hs = torch.as_tensor(hist_start, dtype=torch.int64, device=dev) \
        .expand(R).contiguous()
    out = torch.empty((R, block_bound(N - hist_len)), dtype=torch.uint8,
                      device=dev)
    out_len = torch.empty(R, dtype=torch.int64, device=dev)
    step = max(1, XLA_CHUNK_POSITIONS // N)
    stats = {"lce": 0, "orbit": 0, "syncs": 0}
    for i in range(0, R, step):
        rows = slice(i, min(i + step, R))
        out[rows], out_len[rows], lce, orb, syncs = _encode_rows(
            work[rows], src_len[rows], hist_len, use_fingerprints, hs[rows])
        stats["lce"] = max(stats["lce"], lce)
        stats["orbit"] = max(stats["orbit"], orb)
        stats["syncs"] += syncs
    encode_blocks_batch.last_rounds = stats
    return out, out_len


encode_blocks_batch.last_rounds = None


def encode_block(work: torch.Tensor, src_len, hist_len: int = 0,
                 use_fingerprints: bool = True, hist_start=0):
    """Encode one LZ4 block (``encode_block``): work int[N], src_len an
    int. Returns (out u8[block_bound(N - hist_len)], out_len i64 scalar
    tensor)."""
    out, out_len = encode_blocks_batch(
        work[None], torch.as_tensor([int(src_len)]), hist_len,
        use_fingerprints, hist_start)
    return out[0], out_len[0]


def _bucket(n: int, floor: int = 1024) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def encode_block_host(data: np.ndarray, history: np.ndarray | None = None,
                      use_fingerprints: bool = True, *,
                      device="cuda") -> np.ndarray:
    """numpy bytes in, one LZ4 block out (``encode_block_host``): the
    payload padded to a power-of-two width, a history padded to the full
    64 KB window (right-aligned), encoded on *device*."""
    dev = resolve_device(device)
    real_hist = (np.asarray(history, np.uint8)[-WINDOW_SIZE:]
                 if history is not None else np.zeros(0, np.uint8))
    hist_len = WINDOW_SIZE if len(real_hist) > 0 else 0
    hist_start = hist_len - len(real_hist)
    data = np.asarray(data, np.uint8)
    n = len(data)
    work = np.zeros(hist_len + _bucket(n), np.uint8)
    if hist_len:
        work[hist_start:hist_len] = real_hist
    work[hist_len: hist_len + n] = data
    out, out_len = encode_block(torch.from_numpy(work).to(dev), n, hist_len,
                                use_fingerprints, hist_start)
    return out[: int(out_len)].cpu().numpy()
