"""Split-engine encode at every block size: 64 KB segments + host splice.

Port of the encode half of ``divortio_lz4_tpu/parallel/bigblock.py``. LZ4
match offsets never exceed 64 KB, so every 64 KB segment of a block encodes
on its own with the preceding 64 KB of plaintext as its history
(``history_rows``): the device builds the segments' u16 chains with the
port's chain builder (``ops/split_encode.encode_blocks_chain``), the native
host tier serializes each segment with the splice meta
(``serialize_rows``, ``chain_select_serialize_meta``), and
``_splice_block`` joins a block's segment streams into one spec-exact
block stream. A 64 KB block is one segment, whose stream is the block's:
the same rows and serializer give the JAX package's small-block split
frames (``_compress_independent_split``, ``_compress_linked_split``), and
bigger blocks its ``compress_frame_big`` frames, byte for byte.
``history_rows`` also builds the whole-block rows of the row encoders
(``parallel/device._queue_compress_rows``).

The splice helpers from ``_seq_header`` to ``_splice_block`` are verbatim
copies of the JAX module's (it cannot be imported: its package imports
jax), all but ``_ext_len``: the JAX one compares the whole rest of the
block at every segment boundary, the port's compares in growing windows
and stops at the first mismatch, with the same result for every input.
The decode half lives in ``ops/wave_decode.py``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import WINDOW_SIZE
from ..ops.split_encode import chain_select_serialize_meta, encode_blocks_chain
from ..tracing import count, span
from ..utils import host_pool

SEG = WINDOW_SIZE            # encode segment size (the u16 chain ceiling)
_EXT_FIRST = 64              # _ext_len's first compare window, bytes
_EXT_GROW = 4                # and the factor of each next window


# --------------------------------------------------------------------------
# Encode: [history | payload] rows, serializer, host splice
# --------------------------------------------------------------------------

class Rows(NamedTuple):
    """A frame's ``[history | payload]`` rows (``history_rows``)."""
    flat: np.ndarray        # u8[nrows * (hist_len + row) + 8]: rows, slack
    work: np.ndarray        # u8[nrows, hist_len + row], a view of flat
    lens: np.ndarray        # i32[nrows] payload sizes
    hist_len: int           # 64 KB, or 0 where no row has history
    hist_start: np.ndarray  # i32[nrows] first valid history index


def history_rows(raw: np.ndarray, bs: int, row: int,
                 window: Optional[np.ndarray], linked: bool) -> Rows:
    """The rows every device encoder reads: *row* payload bytes each
    (64 KB segments for the split route, whole blocks for the row
    encoders), tiling the plaintext, so that block b owns rows
    ``[b * bs/row, (b+1) * bs/row)``; an empty payload is one empty row.

    A row's history is the 64 KB of plaintext before it, counted from the
    frame start for linked blocks and from its block's start for
    independent ones; a row is at least 64 KB wide, so that is all 64 KB
    or nothing. A row without it gets the dictionary *window*
    right-aligned instead (the context a continuous encoder sees), and
    ``hist_start`` is the first valid history index. The history columns
    are left out (``hist_len`` 0) when no row can have history:
    independent blocks of one row each, no dictionary. The rows sit in
    one flat buffer with 8 trailing bytes, so a serializer can read its 8
    slack bytes past any row."""
    W = WINDOW_SIZE
    n = len(raw)
    per = bs // row
    nrows = max(1, -(-n // row))
    k = np.arange(nrows)
    lens = np.minimum(n - k * row, row).astype(np.int32)
    hist_len = W if linked or per > 1 or window is not None else 0
    # every byte is written once: plaintext, dictionary or zero
    flat = np.empty(nrows * (hist_len + row) + 8, np.uint8)
    flat[-8:] = 0
    work = flat[:-8].reshape(nrows, hist_len + row)
    full = n // row
    work[:full, hist_len:] = raw[: full * row].reshape(full, row)
    if full < nrows:
        work[full, hist_len: hist_len + n - full * row] = raw[full * row:]
        work[full, hist_len + n - full * row:] = 0
    cont = k > 0 if linked else k % per > 0   # history is plaintext
    take = min(len(window), W) if window is not None and hist_len else 0
    if hist_len:
        # the history of a linked frame's block rows is span encode.history
        with span("encode.history") if linked and per == 1 \
                else contextlib.nullcontext():
            tails = raw[: (nrows - 1) * row].reshape(nrows - 1, row)[:, -W:]
            if linked:
                work[1:, :W] = tails
            else:
                at = np.flatnonzero(cont)
                work[at, :W] = tails[at - 1]
            work[~cont, : W - take] = 0
            if take:
                work[~cont, W - take: W] = window[len(window) - take:]
    hist_start = np.where(cont, 0, hist_len - take).astype(np.int32)
    return Rows(flat, work, lens, hist_len, hist_start)


def serialize_rows(rows: Rows, chains: np.ndarray):
    """Serialize every row from its fetched u16 chain (native, on the host
    pool), each read in place in the rows' flat buffer. Returns (streams,
    meta i64[nrows, 4]) with the splice meta lanes: trailing-token
    position, trailing literal count, last-match-sequence stream offset,
    last-match output anchor (lz4t_chain_serialize16m)."""
    flat, work, lens, hist_len = rows[:4]
    width = work.shape[1]
    streams = [None] * len(lens)
    metas = np.empty((len(lens), 4), np.int64)
    with span("encode.serialize"):
        def _ser_one(k):
            src_len = int(lens[k])
            at = k * width
            streams[k], metas[k] = chain_select_serialize_meta(
                flat[at: at + hist_len + src_len + 8], hist_len, src_len,
                chains[k])

        # The native serializer releases the GIL: rows run in parallel.
        list(host_pool().map(_ser_one, range(len(lens))))
    return streams, metas


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


class EncodeState(NamedTuple):
    """One split-engine frame with its row chains queued on the device."""
    raw: np.ndarray
    bs: int
    linked: bool
    rows: Rows               # 64 KB segment rows
    chains: torch.Tensor     # u16[nrows, SEG] on the device, queued


def queue_frame_big(raw: np.ndarray, bs: int, window: Optional[np.ndarray],
                    linked: bool, device) -> EncodeState:
    """Build a frame's segment rows and queue their chains on *device*
    (the dispatch half of ``compress_frame_big``), at every block size."""
    with span("encode.rows"):
        rows = history_rows(raw, bs, SEG, window, linked)
    chains = encode_blocks_chain(rows.work, rows.lens, SEG, rows.hist_len,
                                 rows.hist_start, device=device)
    return EncodeState(raw, bs, linked, rows, chains)


def splice_blocks_big(state: EncodeState, chains_np: np.ndarray) -> list:
    """Serialize every segment from its fetched chain and splice each
    block's segments into one block stream (``_finish_frame_big`` without
    the frame assembly); a 64 KB block is its one segment's stream.
    Returns the blocks' streams."""
    raw, bs, linked, rows = state[:4]
    streams, metas = serialize_rows(rows, chains_np)
    if bs == SEG:
        return streams
    per = bs // SEG
    comps = []
    with span("encode.splice"):
        for first in range(0, len(streams), per):
            bstart = first * SEG
            seg = slice(first, first + per)
            comps.append(_splice_block(
                raw, bstart, min(bstart + bs, len(raw)), streams[seg],
                metas[seg], rows.lens[seg],
                src_floor=0 if linked else bstart))
        # the blocks spliced, a short last block included
        count("splice_blocks", len(comps))
    return comps
