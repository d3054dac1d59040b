"""Token-parsing block decode: the CUDA kernels' wrappers and their plain
versions.

Port of ``divortio_lz4_tpu/ops/pallas_decode.py``. Both TPU kernels run one
interpreter, ``_interpret_block`` (``:116``); so do both entry points of
``csrc/token_decode.cu``:

- ``decode_blocks_pallas`` is TPU kernel ``_make_kernel`` (``:233``, run by
  ``decode_blocks_pallas`` at ``:312``): independent blocks, one row each,
  after an optional shared right-aligned 64 KB history (the TPU took a
  per-row copy of it). The kernel does not walk a block one sequence
  after another: it parses each row in 32 segments at once and stitches
  them, decodes every header and literal of a block with a whole CTA,
  copies the matches 32 sequences a group, and sends a block whose
  clamps would bind (only hostile rows) to the serial interpreter
  (``decode_blocks_pallas_segmented_plain`` renders it step by step).
- ``decode_token_chains`` is TPU kernel ``_make_linked_kernel`` (``:410``,
  run by ``decode_linked_chunk_pallas`` at ``:474``): chains of dependent
  rows, each chain decoded into [64 KB window | out0 | out1 ...], stored
  rows copied through. A chain is a whole linked frame or one independent
  big block: no chunking and no window carried between calls.
  ``decode_linked_chunk`` keeps the JAX function's contract on top of it.
  The kernels parse every row alone and resolve the matches in parallel
  (``ops/resolve.py``; ``token_spans`` and ``decode_token_chains_resolved``
  are the plain rendition of that design).

``decode_block_pallas_host`` is the JAX module's one-block numpy entry point
over ``decode_blocks_pallas``.

On a CUDA tensor each wrapper launches its kernel (built by nvcc at first
use) or raises; on a CPU tensor it runs the plain PyTorch version, which the
CPU tests use and ``chip_smoke.py`` holds the kernel against. The
interpreter's clamps are the contract on hostile input (see the CUDA
source): both versions reproduce the TPU kernel's ``[0, out_len)`` and
``out_len`` on any bytes, and write zeros past the decoded output where the
TPU leaves wild writes.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._build import load_library
from .._device import resolve_device
from ..constants import WINDOW_SIZE
from .resolve import (SEGMENT, Lits, Matches, ResolveRun, resolve_segments,
                      rounds_for)

W = WINDOW_SIZE
HALF_SLACK = 128      # SLACK // 2: literal reads may run this far past a row
CHECK_EVERY = 32      # plain parse steps between checks for a live row
LONG_SPAN = 1024      # kLong of csrc/token_decode.cu
SEGMENTS = 32         # kSegs of csrc/token_decode.cu: one lane a segment
GROUP = 32            # sequences copied together, one lane each
META = 2 * SEGMENTS + 3   # kMeta: a block's state between the stages


class TokenChains(NamedTuple):
    """Device tensors of one linked decode (decode_token_chains' input)."""
    comp: torch.Tensor               # u8[comp_total] rows' wire bytes
    comp_off: torch.Tensor           # i64[n_rows + 1]
    stored: torch.Tensor             # u8[n_rows] stored-row flags
    # i64[nc + 1] chain c's rows, non-decreasing
    row_off: torch.Tensor
    # i64[nc + 1] chain c's output region: 0 = out_off[0] <= ... <=
    # out_off[nc] = out_total, so the regions tile the output. The CUDA
    # kernels read row_off and out_off as their running maxima, so other
    # offsets stay inside the buffers and no two chains share a row or a
    # byte (token_spans renders that reading)
    out_off: torch.Tensor
    seed: Optional[torch.Tensor]     # u8[W] starting window, or None (zeros)
    block_size: int
    out_total: int


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernels():
    lib = load_library("token_decode")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.lz4t_token_decode.argtypes = [p, i64, i64, p, p, i64, p, p, p,
                                      i64, p, i64, p, p, p, p]
    lib.lz4t_token_decode.restype = ctypes.c_int
    chains = [p, i64, p, p, i64, p, i64, p, i64]
    lib.lz4t_token_slots.argtypes = chains + [p, p]
    lib.lz4t_token_slots.restype = ctypes.c_int
    lib.lz4t_token_decode_linked.argtypes = chains + [
        p, i64, p, p, p, p, p, i64, p, i64, p, ctypes.c_int, p, p, i64, p]
    lib.lz4t_token_decode_linked.restype = ctypes.c_int
    return lib


def _check_blocks(comp, lens, block_size, hist):
    if comp.dtype != torch.uint8 or comp.dim() != 2 \
            or not comp.is_contiguous():
        raise ValueError("comp must be a contiguous u8[nb, M]")
    if (lens.dtype != torch.int64 or tuple(lens.shape) != (comp.shape[0],)
            or not lens.is_contiguous()):
        raise ValueError("lens must be a contiguous i64[nb]")
    if block_size < 1:
        raise ValueError("block_size must be >= 1")
    if hist is not None and (hist.dtype != torch.uint8
                             or tuple(hist.shape) != (W,)
                             or not hist.is_contiguous()):
        raise ValueError(f"hist must be a contiguous u8[{W}]")
    tensors = [comp, lens] + ([] if hist is None else [hist])
    if any(x.device != comp.device for x in tensors):
        raise ValueError("all inputs must be on one device")


def decode_blocks_pallas(comp: torch.Tensor, lens: torch.Tensor,
                         block_size: int,
                         hist: Optional[torch.Tensor] = None):
    """Decode a batch of independent blocks by parsing their tokens.

    comp u8[nb, M]: row b's stream is its first lens[b] bytes (bytes past
    it read as zeros, as the TPU rows' zero padding); lens i64[nb]; hist
    u8[65536] right-aligned history of every block, or None. Returns (out
    u8[nb, block_size], out_lens i64[nb]) on the inputs' device, zeros past
    each out_len. On CUDA the kernel is queued on the current stream and
    nothing synchronises; ``launches`` counts those launches and
    ``last_stats`` (i32[nb, 4] on the device) holds, per block, the
    sequences, those the stitch walked again, the matches copied in order
    and the serial-route flag (decode_blocks_pallas_segmented_plain's
    stats). Scratch: the parse's token positions, u32[nb, 32, M / 96 + 2]
    and 2 x u32[nb, M / 3 + 2] (positions, then matches), and 268 B a
    block of state between the kernel's five stages. The kernel takes
    M < 2**23 and block_size <= 2**24."""
    _check_blocks(comp, lens, block_size, hist)
    if comp.device.type == "cpu":
        return decode_blocks_pallas_plain(comp, lens, block_size, hist)
    if comp.device.type != "cuda":
        raise ValueError(f"no token decode for device {comp.device}")
    nb, M = comp.shape
    if M >= 1 << 23 or block_size > 1 << 24:
        raise ValueError("the CUDA token decode takes rows < 2**23 bytes "
                         "wide and block_size <= 2**24")
    dev = comp.device
    out = torch.empty((nb, block_size), dtype=torch.uint8, device=dev)
    out_lens = torch.empty(nb, dtype=torch.int64, device=dev)
    stats = torch.zeros((nb, 4), dtype=torch.int32, device=dev)
    decode_blocks_pallas.last_stats = stats
    if nb == 0:
        return out, out_lens
    # a segment of S bytes holds at most ceil(S / 3) token positions
    list_w = -(-(-(-M // SEGMENTS)) // 3) + 1
    starts_w = -(-M // 3) + 1
    lists = torch.empty(nb * SEGMENTS * list_w, dtype=torch.int32,
                        device=dev)
    starts = torch.empty(nb * starts_w, dtype=torch.int32, device=dev)
    mlens = torch.empty(nb * starts_w, dtype=torch.int32, device=dev)
    meta = torch.empty(nb * META, dtype=torch.int32, device=dev)
    fn = _kernels().lz4t_token_decode
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(comp.data_ptr(), nb, M, lens.data_ptr(),
                None if hist is None else hist.data_ptr(), block_size,
                out.data_ptr(), out_lens.data_ptr(), lists.data_ptr(),
                list_w, starts.data_ptr(), starts_w, mlens.data_ptr(),
                meta.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"token_decode kernel launch failed: "
                           f"cudaError {rc}")
    decode_blocks_pallas.launches += 1
    return out, out_lens


decode_blocks_pallas.launches = 0
decode_blocks_pallas.last_stats = None


def decode_block_pallas_host(comp_bytes, out_cap: int, history=None, *,
                             device="cuda") -> np.ndarray:
    """numpy bytes in, numpy bytes out, through decode_blocks_pallas on
    *device* (``pallas_decode.py:551``): one row of M = len + 256 bytes
    rounded up to 1 KB, out_cap output bytes, and the last 64 KB of
    *history* right-aligned (none when it is None or empty). On "cuda" it
    launches the kernel once. A malformed block gives the kernel's clamped
    bytes, as in JAX; nothing raises."""
    dev = resolve_device(device)
    comp_bytes = np.asarray(comp_bytes, np.uint8)
    m = len(comp_bytes)
    M = -(-(m + 2 * HALF_SLACK) // 1024) * 1024
    comp = np.zeros((1, M), np.uint8)
    comp[0, :m] = comp_bytes
    hist = None
    if history is not None and len(history) > 0:
        h = np.asarray(history, np.uint8)[-W:]
        hist = np.zeros(W, np.uint8)
        hist[W - len(h):] = h
        hist = torch.from_numpy(hist).to(dev)
    out, out_len = decode_blocks_pallas(
        torch.from_numpy(comp).to(dev),
        torch.tensor([m], dtype=torch.int64, device=dev), out_cap, hist)
    return out[0, : int(out_len[0])].cpu().numpy()


def _check_chains(batch: TokenChains):
    comp, comp_off, stored, row_off, out_off, seed, bs, out_total = batch
    if comp.dtype != torch.uint8 or comp.dim() != 1 \
            or not comp.is_contiguous():
        raise ValueError("comp must be a contiguous u8[comp_total]")
    n_rows = stored.shape[0] if stored.dim() == 1 else -1
    if stored.dtype != torch.uint8 or n_rows < 0 \
            or not stored.is_contiguous():
        raise ValueError("stored must be a contiguous u8[n_rows]")
    if comp_off.dtype != torch.int64 \
            or tuple(comp_off.shape) != (n_rows + 1,) \
            or not comp_off.is_contiguous():
        raise ValueError("comp_off must be a contiguous i64[n_rows + 1]")
    nc = row_off.shape[0] - 1 if row_off.dim() == 1 else -1
    for name, x in (("row_off", row_off), ("out_off", out_off)):
        if nc < 0 or x.dtype != torch.int64 or tuple(x.shape) != (nc + 1,) \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous i64[nc + 1]")
    if seed is not None and (seed.dtype != torch.uint8
                             or tuple(seed.shape) != (W,)
                             or not seed.is_contiguous()):
        raise ValueError(f"seed must be a contiguous u8[{W}]")
    if not isinstance(bs, int) or bs < 1:
        raise ValueError("block_size must be an int >= 1")
    if not isinstance(out_total, int) or out_total < 0:
        raise ValueError("out_total must be an int >= 0")
    tensors = [comp, comp_off, stored, row_off, out_off] + \
        ([] if seed is None else [seed])
    if any(x.device != comp.device for x in tensors):
        raise ValueError("all inputs must be on one device")


def decode_token_chains(batch: TokenChains):
    """Decode every chain of *batch*. Returns (out u8[out_total], out_lens
    i64[n_rows]): chain c's decoded bytes start at out[out_off[c]] and run
    for the sum of its rows' out_lens; the rest of its region, and every
    byte outside the regions, is zeros. On CUDA the kernels are queued on
    the current stream; the call synchronises once, to read the span slot
    count that sizes its scratch (1 per stored row, 1 per 3 wire bytes of
    a compressed row). ``launches`` counts those calls, and ``last`` (a
    ResolveRun) keeps what the call left on the device: its ``stats()``
    gives the rounds and the scratch bytes. The kernels take block_size <
    2**31."""
    _check_chains(batch)
    comp = batch.comp
    if comp.device.type == "cpu":
        return decode_token_chains_plain(batch)
    if comp.device.type != "cuda":
        raise ValueError(f"no token decode for device {comp.device}")
    if batch.block_size >= 1 << 31:
        raise ValueError("block_size must be < 2**31 on CUDA")
    dev = comp.device
    n_rows = batch.stored.shape[0]
    nc = batch.row_off.shape[0] - 1
    out = torch.empty(batch.out_total, dtype=torch.uint8, device=dev)
    out_lens = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    seg = max(1, min(SEGMENT, batch.out_total))
    nseg = -(-batch.out_total // seg)
    rounds = rounds_for(seg)
    rows = torch.empty(5 * n_rows + 2 * nc + 3, dtype=torch.int64,
                       device=dev)
    lib = _kernels()
    head = (comp.data_ptr(), comp.shape[0], batch.comp_off.data_ptr(),
            batch.stored.data_ptr(), n_rows, batch.row_off.data_ptr(), nc,
            batch.out_off.data_ptr(), batch.out_total)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lz4t_token_slots(*head, rows.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"token_decode_linked kernel launch failed: "
                               f"cudaError {rc}")
        n_slots = int(rows[n_rows])        # the call's one sync
        spans = torch.empty((n_slots, 4), dtype=torch.int32, device=dev)
        offs = torch.empty(n_slots, dtype=torch.int16, device=dev)
        code = torch.empty(seg, dtype=torch.int32, device=dev)
        flags = torch.zeros(nseg * rounds, dtype=torch.int32, device=dev)
        # spans with over LONG_SPAN bytes in a segment are disjoint: at most
        # seg // LONG_SPAN + 2 of them (a full list only slows a warp down)
        long_cap = seg // LONG_SPAN + 2
        longs = torch.empty((long_cap, 8), dtype=torch.int64, device=dev)
        n_long = torch.zeros(nseg, dtype=torch.int32, device=dev)
        rc = lib.lz4t_token_decode_linked(
            *head, None if batch.seed is None else batch.seed.data_ptr(),
            batch.block_size, out.data_ptr(), out_lens.data_ptr(),
            rows.data_ptr(), spans.data_ptr(), offs.data_ptr(), n_slots,
            code.data_ptr(), seg, flags.data_ptr(), rounds,
            longs.data_ptr(), n_long.data_ptr(), long_cap, stream)
    if rc != 0:
        raise RuntimeError(f"token_decode_linked kernel launch failed: "
                           f"cudaError {rc}")
    decode_token_chains.launches += 1
    decode_token_chains.last = ResolveRun(
        flags, nc, False, nseg, rounds,
        sum(x.numel() * x.element_size()
            for x in (spans, offs, rows, code, flags, longs, n_long)))
    return out, out_lens


decode_token_chains.launches = 0
decode_token_chains.last = None


def decode_linked_chunk(comp: torch.Tensor, lens: torch.Tensor,
                        stored: torch.Tensor, window: torch.Tensor,
                        block_size: int):
    """The contract of the JAX ``decode_linked_chunk_pallas`` on one chain.

    comp u8[rows, M] wire bytes (row r's first lens[r]); lens i64[rows];
    stored bool or int [rows]; window u8[W] right-aligned history. Returns
    (out u8[rows * block_size] packed plaintext, total, out_lens i64[rows],
    win_next u8[W], the last W bytes of [window | out[:total]])."""
    rows = comp.shape[0]
    dev = comp.device
    keep = torch.arange(comp.shape[1], device=dev)[None, :] \
        < lens.clamp(0, comp.shape[1])[:, None]
    comp_off = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
    comp_off[1:] = torch.cumsum(keep.sum(1), 0)
    batch = TokenChains(
        comp[keep].contiguous(), comp_off, (stored != 0).to(torch.uint8),
        torch.tensor([0, rows], dtype=torch.int64, device=dev),
        torch.tensor([0, rows * block_size], dtype=torch.int64, device=dev),
        window.contiguous(), block_size, rows * block_size)
    out, out_lens = decode_token_chains(batch)
    total = out_lens.sum()
    win_next = torch.cat([window, out])[total: total + W]
    return out, total, out_lens, win_next


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

class _Stream:
    """A flat byte buffer of compressed rows, read as the interpreter reads
    them: bytes at or past a row's end are zeros. ``run_end(i, end)`` is
    the first index >= i (and <= end) whose byte is not 255: the end of a
    0xFF-run length extension starting at i."""

    def __init__(self, flat: torch.Tensor):
        n = flat.shape[0]
        self.flat = flat.to(torch.int64)
        self.n = n
        pos = torch.arange(n, device=flat.device)
        mark = torch.where(self.flat != 255, pos, n)
        self.nxt = torch.flip(torch.cummin(torch.flip(mark, [0]), 0).values,
                              [0]) if n else mark

    def at(self, i, end):
        v = self.flat[i.clamp(0, max(self.n - 1, 0))] if self.n \
            else torch.zeros_like(i)
        return torch.where(i < end, v, 0)

    def run_end(self, i, end):
        if not self.n:
            return i
        nx = self.nxt[i.clamp(0, self.n - 1)]
        return torch.maximum(torch.minimum(nx, end), i)

    def ext(self, i, end):
        """(sum of the extension at i, index past it)."""
        q = self.run_end(i, end)
        return 255 * (q - i) + self.at(q, end), q + 1


def _parse(st: _Stream, start, clen, o, o_limit, lits, matches):
    """_interpret_block on rows batched together, one torch step per
    sequence: row k's stream is st[start[k]: start[k] + clen[k]], its
    cursor starts at o[k] and stops at o_limit[k]. Appends each step's
    literal spans (io position, wire position, length) to *lits* and match
    spans (io position, offset, length) to *matches*; returns the final
    cursors. Decoding bytes is left to _run: the parse never reads output."""
    end = start + clen
    p = torch.zeros_like(start)
    step = 0
    while step % CHECK_EVERY or bool((p < clen).any()):
        step += 1
        live = p < clen
        tok = st.at(start + p, end)
        nib = tok >> 4
        ext, after = st.ext(start + p + 1, end)
        lit = torch.where(nib == 15, 15 + ext, nib)
        p1 = torch.where(nib == 15, after - start, p + 1)
        lit = torch.minimum(torch.minimum(lit, o_limit - o),
                            clen + HALF_SLACK - p1).clamp(min=0)
        lit = torch.where(live, lit, 0)
        lits.append((o, start + p1, lit, end))
        p2 = p1 + lit
        o2 = o + lit
        valid = live & (p2 < clen)
        offset = st.at(start + p2, end) | (st.at(start + p2 + 1, end) << 8)
        mnib = tok & 15
        ext, after = st.ext(start + p2 + 2, end)
        ml = torch.where(mnib == 15, 15 + ext, mnib)
        p3 = torch.where(mnib == 15, after - start, p2 + 2)
        mlen = torch.where(valid, torch.minimum(ml + 4, o_limit - o2), 0)
        mlen = torch.where((offset >= 1) & (offset <= o2), mlen, 0)
        matches.append((o2, offset, mlen))
        p = torch.where(live, torch.where(valid, p3, p2), p)
        o = torch.where(live, o2 + mlen, o)
    return o


def _run(st: _Stream, io: torch.Tensor, io_base, lits, matches):
    """Write the parsed spans into the flat io buffer: every literal span
    first (their sources are wire bytes), then the matches in parse order,
    each from [o - offset, o), which is complete when it runs. Span
    positions are relative to io_base (one per row)."""
    dev = io.device
    if lits:
        o, src, n, end = (torch.stack(x).reshape(-1) for x in zip(*lits))
        base = io_base.repeat(len(lits))
        owner = torch.repeat_interleave(torch.arange(len(n), device=dev), n)
        j = torch.arange(len(owner), device=dev) \
            - (torch.cumsum(n, 0) - n)[owner]
        io[base[owner] + o[owner] + j] = \
            st.at(src[owner] + j, end[owner]).to(torch.uint8)
    if not matches:
        return
    mo, moff, mlen = (torch.stack(x) for x in zip(*matches))   # [T, rows]
    widths = mlen.max(1).values.tolist()
    for k, width in enumerate(widths):
        if width <= 0:
            continue
        i = torch.arange(width, device=dev)
        off = moff[k].clamp(min=1)[:, None]
        at = (io_base + mo[k])[:, None]
        take = i < mlen[k][:, None]
        src = at - off + i % off
        dst = torch.where(take, at + i, io.shape[0] - 1)
        io[dst] = torch.where(take, io[src.clamp(min=0)], io[-1])


def decode_blocks_pallas_plain(comp: torch.Tensor, lens: torch.Tensor,
                               block_size: int,
                               hist: Optional[torch.Tensor] = None):
    """decode_blocks_pallas in plain PyTorch (any device): the parse batched
    over rows, one step per sequence, then the spans written in order."""
    _check_blocks(comp, lens, block_size, hist)
    dev = comp.device
    nb, M = comp.shape
    base = W if hist is not None else 0
    row_w = base + block_size
    st = _Stream(comp.reshape(-1))
    start = torch.arange(nb, device=dev) * M
    clen = lens.clamp(0, M)
    o0 = torch.full((nb,), base, dtype=torch.int64, device=dev)
    lits, matches = [], []
    o = _parse(st, start, clen, o0, o0 + block_size, lits, matches) \
        if nb else o0
    # one spare byte at the end takes the writes of masked lanes
    io = torch.zeros(nb * row_w + 1, dtype=torch.uint8, device=dev)
    if hist is not None and nb:
        io[:-1].view(nb, row_w)[:, :W] = hist
    io_base = torch.arange(nb, device=dev) * row_w
    _run(st, io, io_base, lits, matches)
    out_lens = o - base
    out = io[:-1].view(nb, row_w)[:, base:]
    keep = torch.arange(block_size, device=dev)[None, :] < out_lens[:, None]
    return torch.where(keep, out, 0).contiguous(), out_lens


# ---------------------------------------------------------------------------
# The independent-block kernel's design, rendered step by step
# ---------------------------------------------------------------------------



class _Row:
    """One compressed row as the interpreter reads it: bytes at and past
    n are zeros."""

    def __init__(self, data: bytes, n: int):
        self.b, self.n = data, n

    def at(self, i: int) -> int:
        return self.b[i] if i < self.n else 0

    def ext(self, p: int):
        s = 0
        while True:
            v = self.at(p)
            p += 1
            s += v
            if v != 255:
                return s, p

    def head(self, p: int):
        """The sequence whose token is at p, without the cursor's clamps
        (its positions do not depend on the output cursor): (next token
        position, lit, lit_at, valid, offset, ml). lit is clamped to the
        row's end + HALF_SLACK as the interpreter clamps it."""
        token = self.at(p)
        p += 1
        lit = token >> 4
        if lit == 15:
            e, p = self.ext(p)
            lit += e
        lit = max(min(lit, self.n + HALF_SLACK - p), 0)
        lit_at = p
        p += lit
        valid = p < self.n
        offset = self.at(p) | self.at(p + 1) << 8
        p2, ml = p + 2, token & 15
        if valid and ml == 15:
            e, p2 = self.ext(p2)
            ml += e
        return (p2 if valid else p), lit, lit_at, valid, offset, ml


def _token_starts(row: _Row, segments: int):
    """A.1: the split, speculative parse, stitched. Returns (the true
    token positions in order, positions the stitch walked again)."""
    n = row.n
    S = -(-n // segments)
    lists, exits = [], []
    for w in range(segments):        # lane w walks segment w
        p, lst = w * S, []
        while p < n and p < (w + 1) * S:
            lst.append(p)
            p = row.head(p)[0]
        lists.append(lst)
        exits.append(p)
    starts, x, redo = list(lists[0]), exits[0], 0
    for w in range(1, segments):     # the stitch, in segment order
        hi = (w + 1) * S
        if x >= n:
            break
        if x >= hi:
            continue                 # a literal run passed the segment
        lst = lists[w]
        j = bisect.bisect_left(lst, x)
        while True:
            if j < len(lst) and lst[j] == x:     # x is in w's list
                starts += lst[j:]
                x = exits[w]
                break
            starts.append(x)
            redo += 1
            x = row.head(x)[0]
            if x >= hi or x >= n:
                break
            while j < len(lst) and lst[j] < x:
                j += 1
    return starts, redo


def _decode_row_segmented(row: _Row, io: bytearray, base: int,
                          o_limit: int, segments: int):
    """A.1-A.4 on one row into io (history, if any, in io[:base]).
    Returns (final cursor or None for the serial route, stats)."""
    starts, redo = _token_starts(row, segments)
    heads = [row.head(p)[1:] for p in starts]
    # A.2: each sequence's cursor by a scan of lit + mlen
    at, o = [], base
    for lit, _, valid, _, ml in heads:
        at.append(o)
        o += lit + (ml + 4 if valid else 0)
    # A.3: no clamp binds, every match's offset is in [1, om]
    for oc, (lit, _, valid, off, ml) in zip(at, heads):
        om = oc + lit
        if not (om <= o_limit
                and (not valid or (1 <= off <= om
                                   and om + ml + 4 <= o_limit))):
            return None, [len(starts), redo, 0, 1]
    # A.4: every literal (they read only the row), then the matches group
    # by group: those that read only bytes before the group's first output
    # byte g0 in parallel (every read from the group's starting state),
    # then the rest in order
    for oc, (lit, lit_at, _, _, _) in zip(at, heads):
        io[oc: oc + lit] = bytes(row.at(lit_at + i) for i in range(lit))
    in_order = 0
    for k0 in range(0, len(starts), GROUP):
        g0, snap, late = at[k0], bytes(io), []
        for oc, (lit, _, valid, off, ml) in zip(at[k0: k0 + GROUP],
                                               heads[k0: k0 + GROUP]):
            om, mlen = oc + lit, ml + 4
            if not valid:
                continue
            if om - off + min(mlen, off) <= g0:
                io[om: om + mlen] = bytes(snap[om - off + i % off]
                                          for i in range(mlen))
            else:
                late.append((om, off, mlen))
        for om, off, mlen in late:
            for i in range(mlen):
                io[om + i] = io[om - off + i % off]
        in_order += len(late)
    return o, [len(starts), redo, in_order, 0]


def decode_blocks_pallas_segmented_plain(comp: torch.Tensor,
                                         lens: torch.Tensor,
                                         block_size: int,
                                         hist: Optional[torch.Tensor] = None,
                                         segments: int = SEGMENTS):
    """decode_blocks_pallas as ``lz4t_token_decode`` computes it, in plain
    Python over each row, for the tests:

    1. each of *segments* lanes parses segment w of the row (from byte
       w * ceil(len / segments)) without the output cursor's clamps,
       recording its token positions, until it passes the segment; the
       stitch, in segment order, keeps a segment's list from the true
       cursor on if the cursor is in it, else walks on from the cursor;
    2. every sequence's header, and its cursor by a scan;
    3. the conformance check: no literal or match clamp binds and every
       match's offset is in [1, om]; a row that fails it is decoded by
       the serial interpreter (decode_blocks_pallas_plain);
    4. every literal; then, in groups of GROUP sequences, the matches
       whose source ends at or before the group's first output byte,
       from the group's starting state, then its other matches in order.

    Returns (out, out_lens, stats i64[nb, 4]): per row the sequences,
    those the stitch walked again, the matches copied in order (0 on the
    serial route) and the serial-route flag
    (``decode_blocks_pallas.last_stats`` on CUDA)."""
    _check_blocks(comp, lens, block_size, hist)
    nb, M = comp.shape
    base = W if hist is not None else 0
    head = b"" if hist is None else bytes(hist.tolist())
    out = torch.zeros((nb, block_size), dtype=torch.uint8)
    out_lens = torch.zeros(nb, dtype=torch.int64)
    stats = torch.zeros((nb, 4), dtype=torch.int64)
    rows = comp.cpu()
    for b in range(nb):
        n = int(lens[b].clamp(0, M))
        row = _Row(bytes(rows[b, :n].tolist()), n)
        io = bytearray(head + bytes(block_size))
        o, st = _decode_row_segmented(row, io, base, base + block_size,
                                      segments)
        stats[b] = torch.tensor(st)
        if o is None:
            got = decode_blocks_pallas_plain(comp[b: b + 1], lens[b: b + 1],
                                             block_size, hist)
            out[b], out_lens[b] = got[0][0].cpu(), got[1][0]
        else:
            out_lens[b] = o - base
            out[b, : o - base] = torch.tensor(list(io[base: o]),
                                              dtype=torch.uint8)
    dev = comp.device
    return out.to(dev), out_lens.to(dev), stats.to(dev)


def _flat_spans(lits, matches):
    """_parse's per-step span lists as flat tensors with each span's row
    (rows numbered by their place in the parse)."""
    if not lits:
        return None
    rows = lits[0][0].shape[0]
    row = torch.arange(rows, device=lits[0][0].device).repeat(len(lits))
    lo, lsrc, ln, lend = (torch.stack(x).reshape(-1) for x in zip(*lits))
    mo, moff, mn = (torch.stack(x).reshape(-1) for x in zip(*matches))
    return row, (lo, lsrc, ln, lend), (mo, moff, mn)


def token_spans(batch: TokenChains):
    """Stage A of the token path (``csrc/token_decode.cu``,
    ``token_parse_kernel`` and ``token_fix_kernel``). Every row is parsed
    alone at a row-local cursor W with limit W + block_size (a stored row
    is one literal span of min(len, block_size)); a scan of the lengths
    inside each chain then gives each row's cursor. The parse equals the
    serial one while cursor + n <= W + cap: the cap clamp can only bind
    in the first row that would pass the chain's region, which is parsed
    again with the room left; every row after it decodes to 0 bytes. The
    ``offset > o`` clamp never fires, the cursor being >= W > offset, in
    either parse. row_off and out_off are read as their running maxima
    (``token_rows_kernel``), so the chains' rows and regions never
    overlap. Returns (out_lens, Lits, Matches)."""
    _check_chains(batch)
    comp, comp_off, stored, row_off, out_off, _, bs, out_total = batch
    dev = comp.device
    T = comp.shape[0]
    n_rows = stored.shape[0]
    w0 = comp_off[:-1].clamp(0, T)
    wl = torch.maximum(comp_off[1:].clamp(0, T), w0) - w0
    ro = torch.cummax(row_off.clamp(0, n_rows), 0).values
    oo = torch.cummax(out_off.clamp(0, out_total), 0).values
    r0, r1 = ro[:-1], ro[1:]
    o0 = oo[:-1]
    cap = oo[1:] - o0
    st = _Stream(comp)
    is_st = stored != 0
    full = torch.full((n_rows,), W, dtype=torch.int64, device=dev)
    lits, matches = [], []
    o = _parse(st, w0, torch.where(is_st, 0, wl), full, full + bs, lits,
               matches) if n_rows else full
    n_loc = torch.where(is_st, wl.clamp(max=bs), o - W)

    # the cursor scan inside each chain, and the row the cap clips
    nc = len(r0)
    chain = torch.full((n_rows,), -1, dtype=torch.int64, device=dev)
    chain[torch.repeat_interleave(r0, r1 - r0)
          + _row_in_chain(r1 - r0)] = \
        torch.repeat_interleave(torch.arange(nc, device=dev), r1 - r0)
    inc = chain >= 0
    c = chain.clamp(min=0)
    before = _excl_in_chain(torch.where(inc, n_loc, 0), r0, r1, c)
    room = cap[c] - before
    viol = inc & (n_loc > room)
    dead = inc & (_excl_in_chain(viol.long(), r0, r1, c) > 0)
    clip = viol & ~dead
    n = torch.where(inc & ~dead, n_loc, 0)
    again = clip & (room > 0)
    rows = again.nonzero().flatten()
    lits2, matches2 = [], []
    if len(rows):
        o2 = _parse(st, w0[rows], torch.where(is_st[rows], 0, wl[rows]),
                    full[rows], full[rows] + room[rows], lits2, matches2)
        n[rows] = torch.where(is_st[rows], room[rows], o2 - W)
    n[clip & (room <= 0)] = 0
    out_lens = n
    base = o0[c] + before     # global position of the local cursor W
    keep = inc & ~dead & ~clip

    parts_l, parts_m = [], []
    for idx, ls, ms in ((torch.arange(n_rows, device=dev), lits, matches),
                        (rows, lits2, matches2)):
        flat = _flat_spans(ls, ms)
        if flat is None:
            continue
        k, (lo, lsrc, ln, lend), (mo, moff, mn) = flat
        r = idx[k]
        take = keep[r] if ls is lits else torch.ones_like(r, dtype=torch.bool)
        parts_l.append((base[r] + lo - W, lsrc, lend, ln, take))
        parts_m.append((base[r] + mo - W, o0[c[r]], base[r] + mo - W - moff,
                        moff.clamp(min=1), mn, take))
    # stored rows: one literal span of their wire bytes
    srow = (is_st & inc & ~dead).nonzero().flatten()
    parts_l.append((base[srow], w0[srow], w0[srow] + wl[srow], n[srow],
                    torch.ones_like(srow, dtype=torch.bool)))
    lit = [torch.cat(x) for x in zip(*parts_l)]
    lit = Lits(*(x[lit[4]] for x in lit[:4]))
    if parts_m:
        mat = [torch.cat(x) for x in zip(*parts_m)]
        mat = Matches(*(x[mat[5]] for x in mat[:5]))
    else:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        mat = Matches(z, z, z, z + 1, z)
    return out_lens, lit, mat


def _row_in_chain(counts):
    """0, 1, ... inside each run of *counts* rows."""
    first = torch.cumsum(counts, 0) - counts
    owner = torch.repeat_interleave(torch.arange(len(counts),
                                                 device=counts.device),
                                    counts)
    return torch.arange(len(owner), device=counts.device) - first[owner]


def _excl_in_chain(x, r0, r1, chain):
    """Exclusive prefix sums of per-row *x* inside each chain's rows (the
    chains' rows lie in order: token_spans reads row_off so)."""
    cs = torch.cumsum(x, 0) - x
    start = torch.where(r1 > r0, cs[r0.clamp(max=max(len(x) - 1, 0))], 0) \
        if len(x) else r0
    return cs - start[chain]


def decode_token_chains_resolved(batch: TokenChains,
                                 segment: Optional[int] = None):
    """decode_token_chains as the CUDA kernels compute it, in plain
    PyTorch: token_spans, then stages B-D of ``ops/resolve.py``. Returns
    (out, out_lens, stats with the rounds per segment)."""
    out_lens, lits, matches = token_spans(batch)
    out, rounds = resolve_segments(batch.out_total, batch.comp, batch.seed,
                                   lits, matches, segment or SEGMENT)
    return out, out_lens, dict(rounds=rounds)


def decode_token_chains_plain(batch: TokenChains):
    """decode_token_chains in plain PyTorch (any device): chains batched,
    their rows parsed in order (row r of every chain per pass), then the
    spans written in parse order."""
    _check_chains(batch)
    comp, comp_off, stored, row_off, out_off, seed, bs, out_total = batch
    dev = comp.device
    n_rows = stored.shape[0]
    nc = row_off.shape[0] - 1
    r0 = row_off[:-1].clamp(0, n_rows)
    nrow = torch.maximum(row_off[1:].clamp(0, n_rows), r0) - r0
    o0 = out_off[:-1].clamp(0, out_total)
    cap = torch.maximum(out_off[1:].clamp(0, out_total), o0) - o0
    st = _Stream(comp)
    cursor = torch.full((nc,), W, dtype=torch.int64, device=dev)
    out_lens = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    lits, matches = [], []
    for r in range(int(nrow.max()) if nc else 0):
        has = r < nrow
        row = (r0 + r).clamp(max=max(n_rows - 1, 0))
        w0 = comp_off[row].clamp(0, comp.shape[0])
        wl = torch.where(has, torch.maximum(
            comp_off[row + 1].clamp(0, comp.shape[0]), w0) - w0, 0)
        is_stored = has & (stored[row] != 0)
        limit = torch.minimum(cursor + bs, W + cap)
        # stored rows: one literal span of their wire bytes
        n_st = torch.where(is_stored, torch.minimum(wl, limit - cursor), 0)
        lits.append((cursor, w0, n_st, w0 + wl))
        o = _parse(st, w0, torch.where(is_stored, 0, wl), cursor, limit,
                   lits, matches)
        n = torch.where(is_stored, n_st, o - cursor)
        out_lens[row[has]] = n[has]
        cursor = cursor + n
    io_w = W + cap + 1
    io_base = torch.cumsum(io_w, 0) - io_w
    io = torch.zeros(int(io_w.sum()) + 1, dtype=torch.uint8, device=dev)
    if seed is not None and nc:
        io[io_base[:, None] + torch.arange(W, device=dev)] = seed.expand(nc,
                                                                         W)
    _run(st, io, io_base, lits, matches)
    out = torch.zeros(out_total, dtype=torch.uint8, device=dev)
    decoded = cursor - W
    owner = torch.repeat_interleave(torch.arange(nc, device=dev), decoded)
    pos = torch.arange(len(owner), device=dev) \
        - (torch.cumsum(decoded, 0) - decoded)[owner]
    out[o0[owner] + pos] = io[io_base[owner] + W + pos]
    return out, out_lens
