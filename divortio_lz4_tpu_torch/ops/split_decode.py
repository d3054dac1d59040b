"""Host staging of the split decode: wire parse and flat record streams.

Port of the compact branch of ``divortio_lz4_tpu/ops/pallas_split_decode.py``
(``stored_wire_records``, ``parse_records_wire``, ``parse_wire_raw``, and
the record packing of ``build_compact_batch``). The native host parser
(``lz4t_parse_records2``) turns each block's LZ4 sequences into records of
at most 128 output bytes, ``(src, off | ll<<16 | ml<<24)``. The device
kernel (``compact_decode``) copies them.

The TPU staging padded each block's record stream to its interleave
group's trip bound and planned ways, pairs and SMEM budgets around it. A
GPU block walks its own records, so here the streams are simply
concatenated (CSR form): block b owns records ``rec_off[b] ..
rec_off[b+1]``. Record packing is the reference's: ``w0 = src | ll<<16 |
ml<<24`` and ``w1 = dst | off<<16``, with ``dst`` the running sum of
``ll+ml`` within the block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import WINDOW_SIZE
from ..host import parse_records2_native

W = WINDOW_SIZE
SLACK = 256
# dst is a u16 field of w1 (pallas_split_decode.py:895).
DST_CAP = 0xFFFF


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stored_wire_records(size: int) -> np.ndarray:
    """Pure-literal records for a STORED block: the wire image is the
    plaintext, copied through in 128-byte slices."""
    if size == 0:
        return np.empty((0, 2), np.uint32)
    n = -(-size // 128)
    r = np.empty((n, 2), np.uint32)
    r[:, 0] = np.arange(n, dtype=np.uint32) * 128
    take = np.full(n, 128, np.uint32)
    take[-1] = size - 128 * (n - 1)
    r[:, 1] = 1 | (take << 16)
    return r


def parse_records_wire(src: np.ndarray, out_cap: int, dict_len: int = 0):
    """Parse one block's wire bytes into records (native parser only).
    Returns (recs u32[nrec, 2], out_len); raises "LZ4: ..." ValueErrors on
    malformed streams."""
    return parse_records2_native(np.ascontiguousarray(src, np.uint8),
                                 out_cap, dict_len)


def parse_wire_raw(entries, block_size: int, window=None):
    """Parse a batch of (wire bytes, is_stored) entries. Returns
    (wire u8[nb, wire_cap], recs_l, counts i32[nb], out_lens i64[nb],
    hist u8[nb, W] | None) — the tuple the JAX staging returns."""
    nb = len(entries)
    hl = len(window) if window is not None and len(window) else 0
    max_wire = max((len(c) for c, _ in entries), default=1)
    wire_cap = _round_up(max_wire + SLACK, 1024)
    wire = np.zeros((nb, wire_cap), np.uint8)
    counts = np.zeros(nb, np.int32)
    out_lens = np.zeros(nb, np.int64)
    recs_l = []
    for i, (c, stored) in enumerate(entries):
        wire[i, : len(c)] = c
        if stored:
            r, ol = stored_wire_records(len(c)), len(c)
        else:
            r, ol = parse_records_wire(c, block_size, hl)
        recs_l.append(r)
        counts[i] = len(r)
        out_lens[i] = ol
    hist = None
    if hl:
        hist = np.zeros((nb, W), np.uint8)
        hist[:, W - hl:] = window
    return wire, recs_l, counts, out_lens, hist


def build_flat_records(recs_l):
    """Pack per-block record lists into one flat stream.

    Returns (rec_words i32[N, 2], rec_off i64[nb + 1]): block b's records
    are rec_words[rec_off[b]:rec_off[b+1]], each ``(src | ll<<16 |
    ml<<24, dst | off<<16)`` with dst clamped to the u16 field."""
    nb = len(recs_l)
    counts = np.array([len(r) for r in recs_l], np.int64)
    rec_off = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=rec_off[1:])
    if rec_off[-1] == 0:
        return np.zeros((0, 2), np.int32), rec_off
    r = np.concatenate(recs_l).astype(np.int64)
    w1r = r[:, 1]
    tot = ((w1r >> 16) & 0xFF) + ((w1r >> 24) & 0xFF)
    run = np.cumsum(tot)
    # dst = output bytes of the block's earlier records
    base = np.concatenate([[0], run])[rec_off[:-1]]
    dst = np.minimum(run - tot - np.repeat(base, counts), DST_CAP)
    words = np.empty((len(r), 2), np.uint32)
    words[:, 0] = r[:, 0] | (((w1r >> 16) & 0xFFFF) << 16)
    words[:, 1] = dst | ((w1r & 0xFFFF) << 16)
    return words.view(np.int32), rec_off


class CompactBatch(NamedTuple):
    """Device tensors of one compact decode batch (decode_blocks_compact's
    inputs)."""
    wire: torch.Tensor                 # u8[nb, wire_cap]
    rec_words: torch.Tensor            # i32[N, 2]
    rec_off: torch.Tensor              # i64[nb + 1]
    out_lens: torch.Tensor             # i64[nb]
    hist: Optional[torch.Tensor]       # u8[nb, W] or None


def from_reference_records(wire, recs_l, out_lens, hist, device
                           ) -> CompactBatch:
    """Turn parse_wire_raw's (numpy) state into the port's tensors on
    *device*. The JAX staging and this one start from the same tuple, so
    both decoders can be fed identical parsed records."""
    rec_words, rec_off = build_flat_records(recs_l)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return CompactBatch(put(wire), put(rec_words), put(rec_off),
                        put(np.asarray(out_lens, np.int64)),
                        None if hist is None else put(hist))
