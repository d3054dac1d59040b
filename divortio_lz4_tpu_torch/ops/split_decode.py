"""Host staging of the split decode, and the placed-literal decode kernel.

Port of ``divortio_lz4_tpu/ops/pallas_split_decode.py``.

Compact branch (``stored_wire_records``, ``parse_records_wire``,
``parse_wire_raw``, and the record packing of ``build_compact_batch``):
the native host parser (``lz4t_parse_records2``) turns each block's LZ4
sequences into records of at most 128 output bytes, ``(src, off | ll<<16
| ml<<24)``. The device kernel (``compact_decode``) copies them. The TPU
staging padded each block's record stream to its interleave group's trip
bound and planned ways, pairs and SMEM budgets around it. A GPU block walks
its own records, so here the streams are simply concatenated (CSR form):
block b owns records ``rec_off[b] .. rec_off[b+1]``. Record packing is the
reference's: ``w0 = src | ll<<16 | ml<<24`` and ``w1 = dst | off<<16``,
with ``dst`` the running sum of ``ll+ml`` within the block.

Placed-literal branch, the round-3 decode (``parse_records``,
``parse_block_batch``, ``decode_blocks_split``, ``decode_wire_blocks``,
``decode_block_split_host``): the native parser (``lz4t_parse_records``)
places every literal byte of a block at its output offset (the literal
image) and leaves match records ``(offset | mlen<<16, dst)`` of at most 128
bytes. ``decode_blocks_split`` is the port of the TPU kernel
``_make_kernel`` (``pallas_split_decode.py:91``): on a CUDA tensor it
launches ``csrc/split_decode.cu`` or raises; on a CPU tensor it runs
``decode_blocks_split_plain``; ``decode_blocks_split_grouped_plain``
renders the kernel's own algorithm (conformance check, matches by
dependency levels in groups of 32 records, the serial route for blocks
that fail the check) with its per-block stats, for the CPU tests. The TPU
interleave scheduling (``plan_ways``,
``build_sorted_batch``, ``grouped_trips``, trips, ``UNROLL``) is not
ported: a GPU block runs its own ``counts[b]`` records, and the NOOP
padding writes nothing, so the bytes are the same. No frame route runs
this kernel, in the JAX package or here: its callers are
``decode_wire_blocks`` and ``decode_block_split_host``. The JAX
``decode_wire_blocks`` docstring says the streaming decoder uses it; that
is stale (``stream.py:617`` calls ``decode_wire_blocks2``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import ctypes
import functools

import numpy as np
import torch

from .._build import load_library
from .._device import resolve_device
from ..constants import WINDOW_SIZE
from ..host import parse_records2_native, parse_records_native
from ..tracing import put, span
from .compact_decode import STATS
from .record_groups import run_groups

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
    with span("decode.parse"):
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
    with span("decode.records"):
        rec_words, rec_off = build_flat_records(recs_l)
    return CompactBatch(put(wire, device), put(rec_words, device),
                        put(rec_off, device),
                        put(np.asarray(out_lens, np.int64), device),
                        None if hist is None else put(hist, device))


# ---------------------------------------------------------------------------
# Placed-literal decode (TPU kernel pallas_split_decode.py:91)
# ---------------------------------------------------------------------------

# A padding record that writes nothing: offset=1, mlen=0, dst=1.
NOOP_W0 = 1
NOOP_W1 = 1
SPAN = 128      # output bytes one match record covers at most


def _pow2_at_least(x: int, lo: int) -> int:
    m = lo
    while m < x:
        m <<= 1
    return m


# The JAX module's name for the placed-literal parse; the port has only the
# native parser, so it is the same function.
parse_records = parse_records_native


def parse_block_batch(comps, block_size: int, histories=None):
    """Parse a batch of blocks for ``decode_blocks_split``
    (pallas_split_decode.py:345-383).

    comps: per-block wire byte arrays; histories: None or per-block
    history windows (<= 64 KB, None entries for none). Returns (lit
    u8[nb, io_bytes], recs i32[nb, cap, 2], counts i32[nb], out_lens
    i32[nb], use_history): io_bytes = round_up((64 KB if use_history else
    0) + block_size + 256, 1024), histories right-aligned in the first
    64 KB; every row's records padded with NOOP records to cap, a power of
    two >= 128."""
    nb = len(comps)
    use_history = histories is not None and any(
        h is not None and len(h) for h in histories)
    out_base = W if use_history else 0
    io_bytes = _round_up(out_base + block_size + SLACK, 1024)
    lit = np.zeros((nb, io_bytes), np.uint8)
    recs_l = []
    counts = np.zeros(nb, np.int32)
    out_lens = np.zeros(nb, np.int32)
    for i, c in enumerate(comps):
        h = histories[i] if use_history else None
        hl = len(h) if h is not None else 0
        if hl:
            lit[i, out_base - hl: out_base] = h
        r, ol = parse_records(c, lit[i, out_base:], block_size, hl)
        recs_l.append(r)
        counts[i] = len(r)
        out_lens[i] = ol
    cap = _pow2_at_least(max(int(counts.max(initial=0)) + 1, 2), 128)
    recs = np.empty((nb, cap, 2), np.uint32)
    recs[:, :, 0] = NOOP_W0
    recs[:, :, 1] = NOOP_W1
    for i, r in enumerate(recs_l):
        recs[i, : len(r)] = r
    return lit, recs.view(np.int32), counts, out_lens, use_history


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("split_decode").lz4t_split_decode
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, i64, p, i64, p, i64, i64, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check_split(lit, recs, counts, block_size, out_base):
    nb = lit.shape[0] if lit.dim() == 2 else -1
    if lit.dtype != torch.uint8 or nb < 0 or not lit.is_contiguous():
        raise ValueError("lit must be a contiguous u8[nb, io_bytes]")
    if block_size < 1 or lit.shape[1] < out_base + block_size:
        raise ValueError(f"lit rows of {lit.shape[1]} bytes do not hold "
                         f"{out_base} + block_size={block_size}")
    if (recs.dtype != torch.int32 or recs.dim() != 3 or recs.shape[0] != nb
            or recs.shape[2] != 2 or not recs.is_contiguous()):
        raise ValueError("recs must be a contiguous i32[nb, cap, 2]")
    if (counts.dtype != torch.int32 or tuple(counts.shape) != (nb,)
            or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous i32[nb]")
    if recs.device != lit.device or counts.device != lit.device:
        raise ValueError("all inputs must be on one device")


def decode_blocks_split(lit: torch.Tensor, recs: torch.Tensor,
                        counts: torch.Tensor, block_size: int,
                        use_history: bool = False) -> torch.Tensor:
    """Run each block's match records over its literal image.

    lit u8[nb, io_bytes] placed-literal images (the history window, if
    any, in the first 64 KB); recs i32[nb, cap, 2]; counts i32[nb], the
    records block b runs. Returns u8[nb, block_size], the image's block
    region after the records, on the inputs' device (output lengths come
    from the host parser). On CUDA the kernel is queued on the current
    stream and nothing synchronises; ``launches`` counts those launches
    and ``last_stats`` (i32[nb, 5] on the device) holds, per block, the
    records, groups of 32, levels (their sum and the largest group's) and
    the serial-route flag (decode_blocks_split_grouped_plain's stats). The
    kernel takes out_base + block_size < 2**31 and 8-byte aligned recs."""
    out_base = W if use_history else 0
    _check_split(lit, recs, counts, block_size, out_base)
    if lit.device.type == "cpu":
        return decode_blocks_split_plain(lit, recs, counts, block_size,
                                         use_history)
    if lit.device.type != "cuda":
        raise ValueError(f"no split decode for device {lit.device}")
    if out_base + block_size >= 1 << 31 or recs.data_ptr() % 8:
        raise ValueError("the CUDA split decode takes out_base + block_size "
                         "< 2**31 and 8-byte aligned recs")
    nb = lit.shape[0]
    out = torch.empty((nb, block_size), dtype=torch.uint8, device=lit.device)
    stats = torch.zeros((nb, len(STATS)), dtype=torch.int32,
                        device=lit.device)
    decode_blocks_split.last_stats = stats
    if nb == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(lit.device):
        stream = torch.cuda.current_stream(lit.device).cuda_stream
        rc = fn(lit.data_ptr(), nb, lit.shape[1], recs.data_ptr(),
                recs.shape[1], counts.data_ptr(), out_base, block_size,
                out.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"split_decode kernel launch failed: "
                           f"cudaError {rc}")
    decode_blocks_split.launches += 1
    return out


decode_blocks_split.launches = 0
decode_blocks_split.last_stats = None


def decode_blocks_split_plain(lit: torch.Tensor, recs: torch.Tensor,
                              counts: torch.Tensor, block_size: int,
                              use_history: bool = False) -> torch.Tensor:
    """decode_blocks_split in plain PyTorch (any device): one batched torch
    step per record index, each gathering every record's source bytes
    before scattering them, with the TPU kernel's clamps."""
    out_base = W if use_history else 0
    _check_split(lit, recs, counts, block_size, out_base)
    nb, io_w = lit.shape
    dev = lit.device
    io = lit.clone()
    n = counts.to(torch.int64).clamp(0, recs.shape[1])
    rows = torch.arange(nb, device=dev)[:, None].expand(nb, SPAN)
    t = torch.arange(SPAN, device=dev)
    limit = out_base + block_size
    for k in range(int(n.max()) if nb else 0):
        w0 = recs[:, k, 0].to(torch.int64)
        w1 = recs[:, k, 1].to(torch.int64)
        dst = (w1.clamp(0, block_size) + out_base).clamp(min=1)
        offset = torch.minimum((w0 & 0xFFFF).clamp(min=1), dst)
        mlen = torch.minimum((w0 >> 16) & 0xFFFF,
                             (limit - dst).clamp(max=SPAN))
        mlen = torch.where(k < n, mlen, 0)
        vals = io[rows, ((dst - offset)[:, None] + t).clamp(max=io_w - 1)]
        put = t < mlen[:, None]
        io[rows[put], (dst[:, None] + t)[put]] = vals[put]
    return io[:, out_base: out_base + block_size].contiguous()


def decode_blocks_split_grouped_plain(lit: torch.Tensor, recs: torch.Tensor,
                                      counts: torch.Tensor, block_size: int,
                                      use_history: bool = False):
    """decode_blocks_split as ``csrc/split_decode.cu`` computes it, in plain
    numpy over each block, for the tests:

    1. the conformance check on every record that writes (mlen > 0): no
       clamp binds, mlen <= offset, and its write range starts at or after
       the end of every earlier one; a block that fails it is decoded by
       the serial plain version (decode_blocks_split_plain);
    2. the matches over the literal image in groups of 32 records by
       dependency levels (``record_groups.run_levels``).

    Returns (out, stats i64[nb, 5]): per block the records, groups,
    levels (their sum and the largest group's) and the serial-route flag
    (``decode_blocks_split.last_stats`` on CUDA)."""
    base = W if use_history else 0
    _check_split(lit, recs, counts, block_size, base)
    nb, cap = recs.shape[:2]
    images = lit.cpu().numpy()
    words = recs.cpu().numpy().astype(np.int64)
    ns = counts.cpu().numpy()
    out = np.zeros((nb, block_size), np.uint8)
    stats = np.zeros((nb, len(STATS)), np.int64)
    for b in range(nb):
        n = min(max(int(ns[b]), 0), cap)
        w0, w1 = words[b, :n, 0], words[b, :n, 1]
        offset, mlen, dst = w0 & 0xFFFF, (w0 >> 16) & 0xFFFF, w1 + base
        writes = mlen > 0
        end = np.where(writes, dst + mlen, 0)
        before = np.maximum.accumulate(np.concatenate([[0], end]))[:-1]
        ok = ~writes | ((w1 >= 0) & (w1 <= block_size) & (dst >= 1)
                        & (offset >= 1) & (offset <= dst) & (mlen <= SPAN)
                        & (mlen <= base + block_size - dst)
                        & (mlen <= offset) & (dst >= before))
        if not ok.all():
            stats[b] = (n, 0, 0, 0, 1)
            continue
        io = images[b].copy()
        groups, levels, most = run_groups(io, dst - offset, dst, mlen)
        stats[b] = (n, groups, levels, most, 0)
        out[b] = io[base: base + block_size]
    got = torch.from_numpy(out)
    serial = np.flatnonzero(stats[:, 4])
    if len(serial):
        got[serial] = decode_blocks_split_plain(
            lit, recs, counts, block_size, use_history).cpu()[serial]
    dev = lit.device
    return got.to(dev), torch.from_numpy(stats).to(dev)


def decode_wire_blocks(comps, block_size: int, *, device="cuda") -> list:
    """Decode a list of independent blocks' wire bytes in one batched
    kernel launch (pallas_split_decode.py:1333-1352). Returns a list of
    np.uint8 outputs, in input order."""
    dev = resolve_device(device)
    lit, recs, counts, out_lens, uh = parse_block_batch(comps, block_size)
    out = decode_blocks_split(torch.from_numpy(lit).to(dev),
                              torch.from_numpy(recs).to(dev),
                              torch.from_numpy(counts).to(dev), block_size,
                              uh).cpu().numpy()
    return [out[i, : int(n)] for i, n in enumerate(out_lens)]


def decode_block_split_host(comp_bytes, out_cap: int, history=None, *,
                            device="cuda") -> np.ndarray:
    """One block's wire bytes in, its plaintext out (numpy), for tests
    (pallas_split_decode.py:1355-1378); *history* (its last 64 KB count)
    backs matches that reach before the block."""
    dev = resolve_device(device)
    comp_bytes = np.ascontiguousarray(comp_bytes, dtype=np.uint8)
    hists = [history[-W:]] if history is not None and len(history) \
        else None
    lit, recs, counts, out_lens, uh = parse_block_batch([comp_bytes],
                                                        out_cap, hists)
    out = decode_blocks_split(torch.from_numpy(lit).to(dev),
                              torch.from_numpy(recs).to(dev),
                              torch.from_numpy(counts).to(dev), out_cap, uh)
    return out[0, : int(out_lens[0])].cpu().numpy()
