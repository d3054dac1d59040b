"""Big-block encode (256 KB / 1 MB / 4 MB blocks): 64 KB segments + host
splice.

Port of the encode half of ``divortio_lz4_tpu/parallel/bigblock.py``. LZ4
match offsets never exceed 64 KB, so every 64 KB segment of a block encodes
on its own with the preceding 64 KB of plaintext as a history row
(``_segment_rows``): the device builds the segments' u16 chains with the
port's chain builder (``ops/split_encode.encode_blocks_chain``), the native
host tier serializes each segment with the splice meta
(``chain_select_serialize_meta``), and ``_splice_block`` joins a block's
segment streams into one spec-exact block stream. The frame is
byte-identical to the JAX ``compress_frame_big``.

The host helpers from ``_segment_rows`` to ``_splice_block`` are verbatim
copies of the JAX module's (it cannot be imported: its package imports
jax), all but ``_ext_len``: the JAX one compares the whole rest of the
block at every segment boundary, the port's compares in growing windows
and stops at the first mismatch, with the same result for every input.
The decode half lives in ``ops/wave_decode.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import WINDOW_SIZE, block_bound
from ..ops.split_encode import chain_select_serialize_meta, encode_blocks_chain
from ..tracing import count, span
from ..utils import host_pool

SEG = WINDOW_SIZE            # encode segment size (the u16 chain ceiling)
_EXT_FIRST = 64              # _ext_len's first compare window, bytes
_EXT_GROW = 4                # and the factor of each next window


# --------------------------------------------------------------------------
# Encode: 64 KB segment rows + host splice
# --------------------------------------------------------------------------

def _segment_rows(raw: np.ndarray, bs: int, window: Optional[np.ndarray],
                  linked: bool):
    """[64 KB history | 64 KB payload] rows for every segment of every block.

    Independent blocks clip history at the block start (dictionary window
    fills the remainder); linked blocks see prior-block plaintext too —
    identical context to what a single continuous encoder would use.
    Returns (work u8[nrows, W+SEG], lens i32, hist_start i32,
    seg_rows: list of per-block [row indices]).
    """
    W = WINDOW_SIZE
    n = len(raw)
    dict_len = len(window) if window is not None else 0
    nblocks = max(1, -(-n // bs))
    seg_rows = []
    rows = []
    lens = []
    hist_start = []
    for b in range(nblocks):
        bstart = b * bs
        bend = min(bstart + bs, n)
        nseg = max(1, -(-(bend - bstart) // SEG))
        rlist = []
        for j in range(nseg):
            sstart = bstart + j * SEG
            send = min(sstart + SEG, bend)
            row = np.zeros(W + SEG, np.uint8)
            row[W: W + (send - sstart)] = raw[sstart:send]
            floor = 0 if linked else bstart
            avail = min(sstart - floor, W)
            if avail > 0:
                row[W - avail: W] = raw[sstart - avail: sstart]
            room = W - avail
            take = min(dict_len, room)
            if take > 0:
                row[room - take: room] = window[dict_len - take:]
            rows.append(row)
            lens.append(send - sstart)
            hist_start.append(room - take)
            rlist.append(len(rows) - 1)
        seg_rows.append(rlist)
    return (np.stack(rows), np.array(lens, np.int32),
            np.array(hist_start, np.int32), seg_rows)


def _encode_segments(work: np.ndarray, lens: np.ndarray,
                     chains: np.ndarray):
    """Serialize every segment row from its fetched u16 chain (native, on
    the host pool). Returns (outs u8[nrows, OW], out_lens i64, meta
    i64[nrows, 4]) with the splice meta lanes: trailing-token position,
    trailing literal count, last-match-sequence stream offset, last-match
    output anchor (lz4t_chain_serialize16m)."""
    nrows, rowlen = work.shape
    with span("encode.serialize"):
        # serializer reads 8-byte words past hist+src: pad rows once
        wk = np.zeros((nrows, rowlen + 8), np.uint8)
        wk[:, :rowlen] = work
        OW = block_bound(SEG) + 16
        outs = np.zeros((nrows, OW), np.uint8)
        out_lens = np.zeros(nrows, np.int64)
        metas = np.zeros((nrows, 4), np.int64)

        def _ser_one(k):
            s, meta = chain_select_serialize_meta(wk[k], WINDOW_SIZE,
                                                  int(lens[k]), chains[k])
            outs[k, : len(s)] = s
            out_lens[k] = len(s)
            metas[k] = meta

        list(host_pool().map(_ser_one, range(nrows)))
    return outs, out_lens, metas


def _seq_header(lit_len: int, low_nibble: int) -> np.ndarray:
    """Token byte + 0xFF-run literal-length extension."""
    b = [(min(lit_len, 15) << 4) | low_nibble]
    if lit_len >= 15:
        rem = lit_len - 15
        while rem >= 255:
            b.append(255)
            rem -= 255
        b.append(rem)
    return np.array(b, np.uint8)


def _parse_litlen(stream: np.ndarray, p: int = 0):
    """(literal length, header byte count) of the sequence at *p*."""
    tok = int(stream[p])
    lit = tok >> 4
    q = p + 1
    if lit == 15:
        while True:
            v = int(stream[q]); q += 1; lit += v
            if v != 255:
                break
    return lit, q - p


def _parse_seq(stream: np.ndarray, p: int):
    """Parse one full (match-carrying) sequence at byte offset *p*.

    Returns dict(lit, hdr, off, mlen, end): literal count, token+lit-ext
    byte count, match offset, match length, offset past the sequence."""
    lit, hdr = _parse_litlen(stream, p)
    q = p + hdr + lit
    off = int(stream[q]) | (int(stream[q + 1]) << 8)
    q += 2
    tok = int(stream[p])
    ml = tok & 15
    if ml == 15:
        while True:
            v = int(stream[q]); q += 1; ml += v
            if v != 255:
                break
    return {"lit": lit, "hdr": hdr, "off": off, "mlen": ml + 4, "end": q}


def _emit_seq(lit_bytes: np.ndarray, off: int, mlen: int) -> np.ndarray:
    """Serialize one full sequence (token, lit ext, literals, offset,
    match ext)."""
    head = _seq_header(len(lit_bytes), min(mlen - 4, 15))
    tail = [np.array([off & 0xFF, (off >> 8) & 0xFF], np.uint8)]
    if mlen - 4 >= 15:
        rem = mlen - 4 - 15
        mx = []
        while rem >= 255:
            mx.append(255)
            rem -= 255
        mx.append(rem)
        tail.append(np.array(mx, np.uint8))
    return np.concatenate([head, lit_bytes] + tail)


def _ext_len(raw: np.ndarray, start: int, dist: int, limit: int) -> int:
    """How far plaintext continues to match itself at -dist from *start*.

    Compares in windows of ``_EXT_FIRST`` bytes, each next one
    ``_EXT_GROW`` times the last, and stops at the first window that holds
    a mismatch: the work follows the extension found, not *limit*. Adds
    the bytes compared to the counter ``splice_cmp_bytes``."""
    if limit <= 0:
        return 0
    a = raw[start: start + limit]
    b = raw[start - dist: start - dist + len(a)]
    n = len(a)
    i, w = 0, _EXT_FIRST
    while i < n:
        j = min(i + w, n)
        neq = np.flatnonzero(a[i:j] != b[i:j])
        if len(neq):
            count("splice_cmp_bytes", j)
            return i + int(neq[0])
        i, w = j, w * _EXT_GROW
    count("splice_cmp_bytes", n)
    return n


def _absorb_prefix(stream, take_total: int, seg_g: int, raw: np.ndarray):
    """Absorb up to *take_total* output bytes from a segment stream's front
    (whole sequences; literal runs cut anywhere; matches cut from the front
    down to mlen >= 4 — dist is start-relative, so a front cut is free).
    Returns (absorbed, skip, rebuilt_first_or_None)."""
    e2 = 0
    p = 0
    rebuild = None
    while e2 < take_total:
        fs = _parse_seq(stream, p)
        cover = fs["lit"] + fs["mlen"]
        if e2 + cover <= take_total:
            e2 += cover
            p = fs["end"]
            continue
        r = take_total - e2
        if r <= fs["lit"]:
            lit2 = fs["lit"] - r
            ls = seg_g + e2 + r
            rebuild = _emit_seq(raw[ls: ls + lit2], fs["off"], fs["mlen"])
        else:
            q = r - fs["lit"]
            if fs["mlen"] - q < 4:
                q = fs["mlen"] - 4
                if q <= 0:
                    break
                r = fs["lit"] + q
            rebuild = _emit_seq(raw[seg_g:seg_g], fs["off"], fs["mlen"] - q)
        e2 += r
        p = fs["end"]
        break
    return e2, p, rebuild


def _splice_block(raw: np.ndarray, bstart: int, bend: int, streams, metas,
                  seg_sizes, src_floor: int) -> np.ndarray:
    """Join per-segment sequence streams into ONE block stream.

    Two boundary repairs make the result match what a continuous encoder
    would emit (measured: without them, segmentation costs ~25 B per 64 KB
    boundary and loses the <=-reference ratio gate on highly compressible
    corpora):

    1. **Trailing-literal merge**: a segment's trailing-literal run (>= 5
       bytes by the LAST_LITERALS rule, or the whole segment when it found
       no match) merges into the next segment's first sequence — the two
       literal runs are contiguous plaintext, so only one token/length
       header is rewritten.
    2. **Boundary match extension**: each segment's FINAL match stopped at
       an artificial match limit, so it is re-extended over the boundary by
       direct plaintext comparison, absorbing first the trailing literals
       and then the next segment's leading output (whole sequences;
       partial literal runs and front-cut matches are free rewrites). The
       block-level spec rules stay intact: extension never reaches past
       block_end - 5, and the final 12-byte no-match zone belongs to the
       block's last segment, which keeps its own end rules.
    """
    parts = []
    pending = 0        # trailing literals awaiting a merge
    pend_start = 0     # their global plaintext start
    open_ext = None    # {budget, fidx, lit_bytes, off, mlen} — an extended
    #                    final match that may keep absorbing forward

    def emit_final(f):
        return _emit_seq(f["lit_bytes"], f["off"], f["mlen"])

    for j, stream in enumerate(streams):
        ssz = int(seg_sizes[j])
        if ssz == 0:
            continue
        tp, tl, lsd, lanchor = (int(x) for x in metas[j])
        seg_g = bstart + j * SEG
        body_start = 0
        rebuild_first = None
        final_fields = None

        if open_ext is not None:
            if tp == 0:
                take = min(open_ext["budget"], ssz)
                open_ext["mlen"] += take
                open_ext["budget"] -= take
                if take == ssz:
                    continue  # whole literal segment swallowed; stay open
                parts[open_ext["fidx"]] = emit_final(open_ext)
                open_ext = None
                pending = ssz - take
                pend_start = seg_g + take
                continue
            final = _parse_seq(stream, lsd)
            budget = open_ext["budget"]
            fcover = final["lit"] + final["mlen"]
            if budget < lanchor:
                # (a) stop among the early sequences
                e2, body_start, rebuild_first = _absorb_prefix(
                    stream, budget, seg_g, raw)
                open_ext["mlen"] += e2
            elif budget < lanchor + fcover:
                # (b) stop inside the final sequence: cut its literal run
                # anywhere / its match from the front (dist is relative —
                # a front cut is free down to mlen >= 4)
                r = budget - lanchor
                if r <= final["lit"]:
                    ls = seg_g + lanchor + r
                    final_fields = {
                        "lit_bytes": raw[ls: ls + final["lit"] - r],
                        "off": final["off"], "mlen": final["mlen"]}
                    absorbed = budget
                else:
                    q = min(r - final["lit"], final["mlen"] - 4)
                    final_fields = {
                        "lit_bytes": raw[seg_g:seg_g],
                        "off": final["off"], "mlen": final["mlen"] - q}
                    absorbed = lanchor + final["lit"] + q
                open_ext["mlen"] += absorbed
                body_start = lsd  # early sequences fully absorbed
            else:
                # (c) swallow the final sequence whole, then eat into the
                # trailing literals; stay open past an exhausted segment
                rem = budget - lanchor - fcover
                e_tl = min(rem, tl)
                open_ext["mlen"] += lanchor + fcover + e_tl
                open_ext["budget"] = rem - e_tl
                if e_tl == tl and open_ext["budget"] > 0:
                    continue
                parts[open_ext["fidx"]] = emit_final(open_ext)
                open_ext = None
                pending = tl - e_tl
                pend_start = seg_g + ssz - pending
                continue
            parts[open_ext["fidx"]] = emit_final(open_ext)
            open_ext = None

        if tp == 0:
            # All-literal segment: extend (or start) the pending run.
            if pending == 0:
                pend_start = seg_g
            pending += ssz
            continue

        if final_fields is None:
            final = _parse_seq(stream, lsd)
            final_fields = {
                "lit_bytes": raw[seg_g + lanchor:
                                 seg_g + lanchor + final["lit"]],
                "off": final["off"], "mlen": final["mlen"],
            }
        if pending > 0:
            lit1, hdr = _parse_litlen(stream)
            merged = pending + lit1
            if lsd == 0:
                final_fields["lit_bytes"] = raw[pend_start:
                                                pend_start + merged]
            else:
                parts.append(_seq_header(merged, int(stream[0]) & 0x0F))
                parts.append(raw[pend_start: pend_start + merged])
                parts.append(stream[hdr + lit1: lsd])
        else:
            if rebuild_first is not None:
                parts.append(rebuild_first)
            parts.append(stream[body_start:lsd])
        parts.append(emit_final(final_fields))
        fidx = len(parts) - 1

        pending = tl
        pend_start = seg_g + ssz - tl
        match_end = pend_start
        if match_end - final_fields["off"] >= src_floor:
            e = _ext_len(raw, match_end, final_fields["off"],
                         (bend - 5) - match_end)
            e_pend = min(e, pending)
            if e_pend > 0:
                final_fields["mlen"] += e_pend
                pending -= e_pend
                pend_start += e_pend
                parts[fidx] = emit_final(final_fields)
            if pending == 0 and e > e_pend:
                open_ext = dict(final_fields, budget=e - e_pend, fidx=fidx)

    if open_ext is not None:
        parts[open_ext["fidx"]] = emit_final(open_ext)
    parts.append(_seq_header(pending, 0))
    parts.append(raw[pend_start: pend_start + pending])
    return np.concatenate(parts) if parts else np.empty(0, np.uint8)


class BigEncodeState(NamedTuple):
    """One big-block frame with its segment chains queued on the device."""
    raw: np.ndarray
    bs: int
    linked: bool
    seg_rows: list           # per block, its segment row indices
    work: np.ndarray         # u8[nrows, W + SEG] segment rows
    lens: np.ndarray         # i32[nrows] segment payload sizes
    chains: torch.Tensor     # u16[nrows, SEG] on the device, queued


def queue_frame_big(raw: np.ndarray, bs: int, window: Optional[np.ndarray],
                    linked: bool, device) -> BigEncodeState:
    """Build a frame's segment rows and queue their chains on *device*
    (the dispatch half of ``compress_frame_big``)."""
    with span("encode.rows"):
        work, lens, hist_start, seg_rows = _segment_rows(raw, bs, window,
                                                         linked)
    chains = encode_blocks_chain(work, lens, SEG, WINDOW_SIZE, hist_start,
                                 device=device)
    return BigEncodeState(raw, bs, linked, seg_rows, work, lens, chains)


def splice_blocks_big(state: BigEncodeState, chains_np: np.ndarray) -> list:
    """Serialize every segment from its fetched chain and splice each
    block's segments into one block stream (``_finish_frame_big`` without
    the frame assembly). Returns the blocks' streams."""
    raw, bs, linked, seg_rows, work, lens = state[:6]
    n = len(raw)
    outs, out_lens, metas = _encode_segments(work, lens, chains_np)
    comps = []
    with span("encode.splice"):
        for b, rlist in enumerate(seg_rows):
            bstart = b * bs
            bend = min(bstart + bs, n)
            comps.append(_splice_block(
                raw, bstart, bend,
                [outs[r][: int(out_lens[r])] for r in rlist],
                [metas[r] for r in rlist],
                [lens[r] for r in rlist],
                src_floor=0 if linked else bstart))
    return comps

