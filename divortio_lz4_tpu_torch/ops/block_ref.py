"""Scalar LZ4 block kernels, the correctness oracle: the port's "python"
host backend.

A copy of ``divortio_lz4_tpu/ops/block_ref.py``: the reference encoder's
greedy parse and acceleration heuristic, byte-identical to the native
block codec (``host.compress_block_native``), and the sequence interpreter
with dictionary back-references and the "LZ4: ..." error taxonomy. O(n)
Python loops, for tests and as the semantic spec of the native functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import (
    HASH_MASK,
    HASH_MULTIPLIER,
    HASH_SHIFT,
    HASH_TABLE_SIZE,
    LAST_LITERALS,
    MF_LIMIT,
    MIN_MATCH,
    SKIP_TRIGGER,
)

_M32 = 0xFFFFFFFF


def lz4_hash(seq: int) -> int:
    """The single hash used framework-wide (blockCompress.js:53)."""
    return ((seq * HASH_MULTIPLIER) & _M32) >> HASH_SHIFT & HASH_MASK


def new_hash_table() -> np.ndarray:
    return np.zeros(HASH_TABLE_SIZE, dtype=np.int32)


def _read_u32(src, i: int) -> int:
    return int(src[i]) | (int(src[i + 1]) << 8) | (int(src[i + 2]) << 16) | (
        int(src[i + 3]) << 24)


def warm_hash_table(table: np.ndarray, buf, limit: int) -> None:
    """Insert positions [0, limit-4] of *buf* into *table* (values pos+1).

    Uses the one true hash — the reference intended this but used a mismatched
    Jenkins hash (bufferCompress.js:190-204), losing most dictionary gains.
    """
    for i in range(0, max(0, limit - MIN_MATCH) + 1):
        table[lz4_hash(_read_u32(buf, i))] = i + 1


def compress_block_ref(src, dst, src_start: int, src_len: int,
                       hash_table: np.ndarray, dst_off: int) -> int:
    """Greedy LZ4 block compress; returns bytes written at dst_off.

    Semantics (all from blockCompress.js):
    - hash-table stores pos+1, 0 = empty (:54)
    - match requires: prior pos, distance < 65536, 4-byte equality (:62-63)
    - acceleration: stride = searchCount++ >> 6, reset on match (:40,66-71)
    - forward-only extension capped at src_end-5 (:147-150)
    - token/extra-byte emission (:79-89,160-171); 2-byte LE offset (:156-157)
    - loop stops at src_end-12; tail emitted as literals (:34,177-230)
    """
    s = src_start
    s_end = src_start + src_len
    mf_limit = s_end - MF_LIMIT
    match_limit = s_end - LAST_LITERALS
    d = dst_off
    anchor = s
    search_count = (1 << SKIP_TRIGGER) + 3

    def emit_len(pos_token: int, length: int, shift: bool, d: int) -> int:
        """Write a 4-bit length with 0xFF-run overflow; returns new d."""
        if length >= 15:
            if shift:
                dst[pos_token] = 0xF0
            else:
                dst[pos_token] |= 0x0F
            rem = length - 15
            while rem >= 255:
                dst[d] = 255
                d += 1
                rem -= 255
            dst[d] = rem
            d += 1
        else:
            if shift:
                dst[pos_token] = length << 4
            else:
                dst[pos_token] |= length
        return d

    while s < mf_limit:
        seq = _read_u32(src, s)
        h = lz4_hash(seq)
        m = int(hash_table[h]) - 1
        hash_table[h] = s + 1

        if (m < 0 or s == m or (s - m) >= 65536 or _read_u32(src, m) != seq):
            step = search_count >> SKIP_TRIGGER
            search_count += 1
            s += step
            continue

        search_count = (1 << SKIP_TRIGGER) + 3

        # Literals since the last anchor.
        lit_len = s - anchor
        token_pos = d
        d += 1
        d = emit_len(token_pos, lit_len, True, d)
        if lit_len > 0:
            dst[d: d + lit_len] = src[anchor: anchor + lit_len]
            d += lit_len

        # Extend the match forward (no backward extension — matches the
        # reference, which skips it for simplicity).
        sp = s + MIN_MATCH
        mp = m + MIN_MATCH
        while sp < match_limit and src[sp] == src[mp]:
            sp += 1
            mp += 1
        match_len = sp - s
        offset = s - m

        dst[d] = offset & 0xFF
        dst[d + 1] = (offset >> 8) & 0xFF
        d += 2
        d = emit_len(token_pos, match_len - MIN_MATCH, False, d)

        s = sp
        anchor = sp

    # Trailing literal run.
    lit_len = s_end - anchor
    token_pos = d
    d += 1
    d = emit_len(token_pos, lit_len, True, d)
    if lit_len > 0:
        dst[d: d + lit_len] = src[anchor: anchor + lit_len]
        d += lit_len
    return d - dst_off


def decompress_block_ref(src, src_off: int, src_len: int, dst, dst_off: int,
                         dictionary: Optional[np.ndarray] = None) -> int:
    """LZ4 block decompress; returns bytes written at dst_off.

    Sequence interpreter with dictionary back-references
    (blockDecompress.js:55-272): dictionary is indexed from its END for
    negative copy sources; a match may span dictionary into output.
    """
    p = src_off
    end = src_off + src_len
    o = dst_off
    out_len = len(dst)
    dict_len = len(dictionary) if dictionary is not None else 0

    while p < end:
        token = int(src[p])
        p += 1

        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = int(src[p])
                p += 1
                lit_len += b
                if b != 255:
                    break

        if o + lit_len > out_len:
            raise ValueError("LZ4: Output Buffer Too Small")
        if p + lit_len > end:
            raise ValueError("LZ4: Malformed Input")
        if lit_len:
            dst[o: o + lit_len] = src[p: p + lit_len]
            o += lit_len
            p += lit_len

        if p >= end:
            break

        offset = int(src[p]) | (int(src[p + 1]) << 8)
        p += 2
        if offset == 0:
            raise ValueError("LZ4: Invalid Offset 0")

        match_len = token & 0x0F
        if match_len == 15:
            while True:
                b = int(src[p])
                p += 1
                match_len += b
                if b != 255:
                    break
        match_len += MIN_MATCH

        if o + match_len > out_len:
            raise ValueError("LZ4: Output Buffer Too Small")

        copy_src = o - offset
        if copy_src < 0:
            # Back-reference into the external dictionary, indexed from its
            # end (blockDecompress.js:145-154). The boundary is the start of
            # the output *buffer* (index 0), not dst_off: in linked-block
            # direct-write decode, earlier blocks live in the same buffer and
            # are legal match sources (bufferDecompress.js:153).
            from_dict = -copy_src
            dict_start = dict_len - from_dict
            take = min(from_dict, match_len)
            if dict_start < 0 or dict_start + take > dict_len:
                raise ValueError("LZ4: Dictionary Offset Out of Bounds")
            for k in range(take):
                dst[o] = dictionary[dict_start + k]
                o += 1
            remaining = match_len - take
            rp = o - offset
            for _ in range(remaining):
                dst[o] = dst[rp]
                o += 1
                rp += 1
        else:
            # Overlap-correct byte copy (RLE when offset < match_len).
            rp = copy_src
            for _ in range(match_len):
                dst[o] = dst[rp]
                o += 1
                rp += 1

    return o - dst_off
