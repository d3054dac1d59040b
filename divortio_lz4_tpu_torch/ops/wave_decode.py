"""Chain decode of linked frames and big blocks: host planning, the CUDA
kernel's wrapper, and its plain version.

``decode_chains`` is the port of the TPU wave kernel ``_make_wave_kernel``
(``divortio_lz4_tpu/ops/wave_decode.py:60``, run by ``decode_chain_waves``).
On a CUDA tensor it launches ``lz4t_chain_decode`` of
``csrc/chain_decode.cu`` (built by nvcc at first use) or raises; on a CPU
tensor it runs ``decode_chains_plain``, the same function in plain
PyTorch, which the CPU tests use and ``chip_smoke.py`` holds the kernel
against.

A chain is the whole body of a linked frame, or one independent block over
256 KB (the JAX planner chains blocks the same way, ``plan_waves``). Its
records are ``w3`` words ``(src, off | ll<<16 | ml<<24, dst)``: ``src``
indexes the chain's compressed image and ``dst`` is the running sum of
``ll+ml`` over the chain. Each chain decodes into its own output region
after a 64 KB seed window (the dictionary right-aligned, or zeros); bytes
no record writes are zeros.

The TPU planner cut each chain into <= 256 KB waves with a carried window,
interleave ways and per-wave record budgets to fit VMEM and SMEM, and gave
up (``None``) on giant-RLE pieces and dense waves. The GPU kernels keep a
chain's output and records in device memory, so none of that is ported:
every block parses whole (``parse_records_wire``) and every frame the host
scanner accepts decodes here. ``build_chain_arrays`` packs a frame's
record words in one native pass (``lz4t_pack_chain_records`` of
``csrc/host_kernels.cpp``); ``stage_chains`` adds their number to the
counter ``chain_records`` while a profiler records, and the number of
chains staged to ``decode_chains``.

The kernels do not walk a chain in order: they resolve its matches in
parallel (``ops/resolve.py``; ``record_spans`` and
``decode_chains_resolved`` are the plain rendition of that design). A chain
whose records break the conformance check, which only random words do,
decodes with the serial record walk instead; both give
``decode_chains_plain``'s bytes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._build import load_library
from ..host import pack_chain_records_native, scan_pieces_native
from ..tracing import count, put, span
from ..utils import host_pool
from .resolve import (NO_PERIOD, SEGMENT, Lits, Matches, ResolveRun,
                      resolve_segments, rounds_for)
from .split_decode import parse_records_wire, stored_wire_records

W = 65536       # seed window ahead of a chain's output
SPAN = 128      # output bytes one record covers at most
SLACK = 256     # zero bytes after each chain's compressed image
PLAIN_STEPS = 1024  # record steps the plain version indexes at once
U32 = 1 << 32   # records carry src and dst as u32


class ChainBatch(NamedTuple):
    """Device tensors of one chain decode (decode_chains' input)."""
    wire: torch.Tensor           # u8[wire_total] compressed images
    wire_off: torch.Tensor       # i64[nc + 1]
    rec_words: torch.Tensor      # i32[N, 3] (src, off|ll<<16|ml<<24, dst)
    rec_off: torch.Tensor        # i64[nc + 1]
    out_off: torch.Tensor        # i64[nc + 1]
    seed: Optional[torch.Tensor]  # u8[W] or None (zeros)
    out_total: int


# ---------------------------------------------------------------------------
# Host planning
# ---------------------------------------------------------------------------

def block_pieces(buf, off, size, stored, block_max):
    """(decoded size, wire lengths of the block's pieces): a compressed
    block cut at sequence boundaries into pieces of >= 64 KB output, a
    stored block one piece. The native piece scan (lz4t_scan_pieces) raises
    "LZ4: Malformed Input" and "LZ4: Invalid Offset 0" on broken streams;
    a block that decodes past *block_max* raises "LZ4: Output Buffer Too
    Small"."""
    if stored:
        return size, np.array([size], np.int64)
    _, wl, ol = scan_pieces_native(
        np.ascontiguousarray(buf[off: off + size], np.uint8), W)
    total = int(ol.sum())
    if total > block_max:
        raise ValueError("LZ4: Output Buffer Too Small")
    return total, wl


def _block_records(buf, off, size, stored, out_len, block_max, hist):
    if stored:
        return stored_wire_records(size)
    recs, got = parse_records_wire(buf[off: off + size], block_max, hist)
    if got != out_len:
        raise ValueError("LZ4: Malformed Input")
    return recs


def plan_blocks(buf: np.ndarray, blocks, header, window):
    """Scan, then parse, every block of a frame on the host pool.

    The scan runs first over every block (the checks of the JAX
    ``_plan_pieces``): a block whose decoded total exceeds ``block_max``
    raises "LZ4: Output Buffer Too Small", a broken stream the scanner's
    error. Then each block parses whole with the history it may reach:
    the dictionary, plus, in a linked frame, everything decoded before it
    (capped at 64 KB; offsets are <= 65535, so the cap changes no
    verdict). Errors surface in block order, as in the JAX package.
    Returns (out_lens i64[nb], recs_l)."""
    bm = header["block_max"]
    pool = host_pool()
    with span("decode.parse"):
        out_lens = np.array(list(pool.map(
            lambda b: block_pieces(buf, *b, bm)[0], blocks)), np.int64)
        dict_len = len(window) if window is not None else 0
        before = np.zeros(len(blocks), np.int64)
        if not header["independent"]:
            before[1:] = np.cumsum(out_lens)[:-1]
        hists = np.minimum(dict_len + before, W)
        recs_l = list(pool.map(
            lambda i: _block_records(buf, *blocks[i], int(out_lens[i]), bm,
                                     int(hists[i])), range(len(blocks))))
    return out_lens, recs_l


def build_chain_arrays(buf: np.ndarray, blocks, independent: bool,
                       out_lens, recs_l):
    """Pack parsed blocks into chains (CSR). A linked frame is one chain;
    an independent frame has one chain per block. Chain c's compressed
    image is its blocks' bytes back to back plus SLACK zeros; its records'
    ``src`` index that image and ``dst`` counts from the chain's first
    output byte. Chains' outputs follow one another in frame order, so the
    decoded frame is the whole output. A chain whose image or output
    reaches 4 GiB raises ValueError: its records' u32 ``src`` or ``dst``
    would wrap. Returns numpy (wire, wire_off, rec_words i32[N, 3],
    rec_off, out_off)."""
    nb = len(blocks)
    if independent:
        starts = np.arange(nb + 1)
    else:
        starts = np.array([0, nb])
    sizes = np.array([size for _, size, _ in blocks], np.int64)
    counts = np.array([len(r) for r in recs_l], np.int64)
    nc = len(starts) - 1

    def per_chain(x):
        cs = np.concatenate([[0], np.cumsum(x)])
        return cs[starts[1:]] - cs[starts[:-1]]

    chain_wire = per_chain(sizes) + SLACK
    if nc and max(chain_wire.max(), per_chain(out_lens).max()) >= U32:
        raise ValueError("chain of 4 GiB or more: its records' u32 src/dst "
                         "would wrap")
    wire_off = np.concatenate([[0], np.cumsum(chain_wire)]).astype(np.int64)
    chain_of = np.repeat(np.arange(nc), np.diff(starts))
    # each block's offset inside its chain's image, then in the flat wire
    cum = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    in_chain = cum - cum[starts[:-1]][chain_of] if nb else cum
    wire = np.zeros(int(wire_off[-1]), np.uint8)
    for b, (off, size, _) in enumerate(blocks):
        at = int(wire_off[chain_of[b]] + in_chain[b])
        wire[at: at + size] = buf[off: off + size]

    rec_off = np.concatenate([[0], np.cumsum(per_chain(counts))]) \
        .astype(np.int64)
    out_off = np.concatenate([[0], np.cumsum(per_chain(out_lens))]) \
        .astype(np.int64)
    # dst restarts at each chain's first block
    first = np.full(nb, independent, np.uint8)
    first[:1] = 1
    recs = np.concatenate(recs_l) if nb else np.empty((0, 2), np.uint32)
    words = pack_chain_records_native(recs, counts, in_chain, first)
    return wire, wire_off, words.view(np.int32), rec_off, out_off


def stage_chains(buf: np.ndarray, blocks, header, window,
                 device) -> ChainBatch:
    """Plan a frame's chains on the host and move them to *device*."""
    out_lens, recs_l = plan_blocks(buf, blocks, header, window)
    with span("decode.records"):
        arrays = build_chain_arrays(buf, blocks, header["independent"],
                                    out_lens, recs_l)
        count("chain_records", len(arrays[2]))
        # one chain a linked frame, one a block of an independent frame
        count("decode_chains", len(arrays[3]) - 1)
    seed = None
    if window is not None and len(window):
        seed = np.zeros(W, np.uint8)
        seed[W - len(window):] = window[-W:]
    return ChainBatch(*(put(a, device) for a in arrays),
                      None if seed is None else put(seed, device),
                      int(arrays[4][-1]))


def decompress_frame_chains(buf: np.ndarray, blocks, header, window,
                            device) -> np.ndarray:
    """Decode a linked or big-block frame body on *device*: the port of
    ``decompress_frame_waves``. *blocks*/*header* from parse_block_index;
    *window* is the dictionary's last 64 KB or None. Returns the
    plaintext; never declines a frame."""
    return decode_chains(stage_chains(buf, blocks, header, window,
                                      device)).cpu().numpy()


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("chain_decode").lz4t_chain_decode
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, p, p, i64, p, p, i64, p, p, i64, p, i64, p,
                   ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def _check(batch: ChainBatch):
    wire, wire_off, words, rec_off, out_off, seed, out_total = batch
    if wire.dtype != torch.uint8 or wire.dim() != 1 \
            or not wire.is_contiguous():
        raise ValueError("wire must be a contiguous u8[wire_total]")
    nc = wire_off.shape[0] - 1 if wire_off.dim() == 1 else -1
    for name, x in (("wire_off", wire_off), ("rec_off", rec_off),
                    ("out_off", out_off)):
        if nc < 0 or x.dtype != torch.int64 or tuple(x.shape) != (nc + 1,) \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous i64[nc + 1] "
                             "like wire_off")
    if (words.dtype != torch.int32 or words.dim() != 2
            or words.shape[1] != 3 or not words.is_contiguous()):
        raise ValueError("rec_words must be a contiguous i32[N, 3]")
    if seed is not None and (seed.dtype != torch.uint8
                             or tuple(seed.shape) != (W,)
                             or not seed.is_contiguous()):
        raise ValueError(f"seed must be a contiguous u8[{W}]")
    if not isinstance(out_total, int) or out_total < 0:
        raise ValueError("out_total must be an int >= 0")
    tensors = [wire, wire_off, words, rec_off, out_off] + \
        ([] if seed is None else [seed])
    if any(x.device != wire.device for x in tensors):
        raise ValueError("all inputs must be on one device")


def decode_chains(batch: ChainBatch) -> torch.Tensor:
    """Decode every chain of *batch*. Returns u8[out_total] on the
    batch's device: chain c's bytes at out[out_off[c]:out_off[c+1]] (the
    chains' regions tile the output, as stage_chains builds them). On CUDA
    the kernels are queued on the current stream and nothing synchronises;
    ``launches`` counts those calls, and ``last`` (a ResolveRun) keeps
    what the call left on the device: its ``stats()`` gives the rounds,
    the chains decoded serially and the scratch bytes."""
    _check(batch)
    wire = batch.wire
    if wire.device.type == "cpu":
        return decode_chains_plain(batch)
    if wire.device.type != "cuda":
        raise ValueError(f"no chain decode for device {wire.device}")
    dev = wire.device
    out = torch.empty(batch.out_total, dtype=torch.uint8, device=dev)
    nc = batch.wire_off.shape[0] - 1
    if nc == 0:
        return out
    seg = max(1, min(SEGMENT, batch.out_total))
    nseg = -(-batch.out_total // seg)
    rounds = rounds_for(seg)
    code = torch.empty(seg, dtype=torch.int32, device=dev)
    flags = torch.zeros(1 + nc + nseg * rounds, dtype=torch.int32,
                        device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(wire.data_ptr(), wire.shape[0], batch.wire_off.data_ptr(),
                batch.rec_words.data_ptr(), batch.rec_words.shape[0],
                batch.rec_off.data_ptr(), batch.out_off.data_ptr(), nc,
                None if batch.seed is None else batch.seed.data_ptr(),
                out.data_ptr(), batch.out_total, code.data_ptr(), seg,
                flags.data_ptr(), rounds, stream)
    if rc != 0:
        raise RuntimeError(f"chain_decode kernel launch failed: "
                           f"cudaError {rc}")
    decode_chains.launches += 1
    decode_chains.last = ResolveRun(flags, nc, True, nseg, rounds,
                                    4 * (code.numel() + flags.numel()))
    return out


decode_chains.launches = 0
decode_chains.last = None


# ---------------------------------------------------------------------------
# Plain version (shared by ops/wire_decode.py)
# ---------------------------------------------------------------------------

def decode_records_plain(wire, wire_base, wire_len, words, rec_base, counts,
                         caps, seeds):
    """The record body of both kernels of ``csrc/chain_decode.cu`` in
    plain PyTorch: one step per record index k, batched over chains, chain
    c running ``words[rec_base[c] + k]`` while ``k < counts[c]``, with the
    kernels' clamps. wire u8[T]; wire_base, wire_len, rec_base, counts,
    caps i64[nc]; words i64[N, 3] holding u32 (src, w1, dst); seeds None,
    u8[W] (every chain) or u8[nc, W]. Returns (buf u8, io_base i64[nc]):
    chain c's output is ``buf[io_base[c] + W : io_base[c] + W + caps[c]]``.
    Works on any device."""
    dev = wire.device
    nc = caps.shape[0]
    n_rec = words.shape[0]

    def starts(sizes, first):
        return first + torch.cumsum(sizes, 0) - sizes

    # One byte buffer: a SPAN front pad, per chain [W seed | cap | SPAN
    # spare] (the spare bytes take the stores of lanes past a record's
    # end), then per chain [its compressed image | SPAN zeros], so that a
    # literal read past the image reads zeros, as in the kernels.
    io_w = W + caps + SPAN
    io_base = starts(io_w, SPAN)
    wr_w = wire_len + SPAN
    wr_base = starts(wr_w, SPAN + int(io_w.sum()))
    buf = torch.zeros(SPAN + int(io_w.sum()) + int(wr_w.sum()),
                      dtype=torch.uint8, device=dev)
    if seeds is not None and nc:
        buf[io_base[:, None] + torch.arange(W, device=dev)] = \
            seeds.expand(nc, W)
    owner = torch.repeat_interleave(torch.arange(nc, device=dev), wire_len)
    pos = torch.arange(len(owner), device=dev) - starts(wire_len, 0)[owner]
    buf[wr_base[owner] + pos] = wire[wire_base[owner] + pos]

    t = torch.arange(SPAN, device=dev)
    steps = int(counts.max()) if nc and n_rec else 0
    # at most 2**22 int64 indices per chunk (32 MB each for reads, writes)
    chunk = max(1, min(PLAIN_STEPS, (1 << 22) // (SPAN * max(nc, 1))))
    for k0 in range(0, steps, chunk):
        # Every index of the next `chunk` steps comes from the records
        # alone; only the byte copies depend on earlier steps.
        ks = k0 + torch.arange(min(chunk, steps - k0), device=dev)
        rec = words[(rec_base[:, None] + ks).clamp(0, n_rec - 1)]
        src, w1, dst = rec[..., 0], rec[..., 1], rec[..., 2]
        cap = caps[:, None]
        ll = (w1 >> 16) & 0xFF
        ml = (w1 >> 24) & 0xFF
        off = (w1 & 0xFFFF).clamp(min=1)
        dst = torch.minimum(dst, cap) + W
        tot = torch.minimum(ll + ml, (W + cap - dst).clamp(max=SPAN))
        tot = torch.where(ks < counts[:, None], tot, 0)
        ll = torch.minimum(ll, tot)
        msrc = (dst + ll - off).clamp(min=0)
        s = torch.minimum(src, wire_len[:, None] - SPAN).clamp(min=0)
        lit_at = (wr_base[:, None] + s)[..., None]
        mat_at = (io_base[:, None] + msrc - ll)[..., None]  # >= SPAN front
        dst_at = (io_base[:, None] + dst)[..., None]
        spare_at = (io_base + W + caps)[:, None, None]
        read = torch.where(t < ll[..., None], lit_at, mat_at) + t
        write = torch.where(t < tot[..., None], dst_at, spare_at) + t
        for j in range(len(ks)):
            buf[write[:, j]] = buf[read[:, j]]
    return buf, io_base


def _chain_bounds(batch: ChainBatch):
    """Each chain's (w0, wlen, r0, r1, o0, cap), its offsets clamped into
    the buffers as the kernels clamp them."""
    wire, wire_off, words, rec_off, out_off, _, out_total = batch
    n_rec = words.shape[0]
    w0 = wire_off[:-1].clamp(0, wire.shape[0])
    wlen = torch.maximum(wire_off[1:].clamp(0, wire.shape[0]), w0) - w0
    r0 = rec_off[:-1].clamp(0, n_rec)
    r1 = torch.maximum(rec_off[1:].clamp(0, n_rec), r0)
    o0 = out_off[:-1].clamp(0, out_total)
    cap = torch.maximum(out_off[1:].clamp(0, out_total), o0) - o0
    return w0, wlen, r0, r1, o0, cap


def record_spans(batch: ChainBatch):
    """Stage A of the record path (``csrc/chain_decode.cu``,
    ``chain_conform_kernel`` and ``chain_spans_kernel``): every record
    with ``do_record``'s clamps, one literal and one match span each, and
    a per-chain conformance flag. A chain conforms when every record
    starts at or after the end of the one before it and its match source
    ends at or before its own start: then every byte is written once and
    every match reads final bytes, so resolving in parallel gives the
    serial order's bytes. Returns (conform bool[nc], Lits, Matches) of the
    conforming chains, or None when the chains overlap."""
    _check(batch)
    w0, wlen, r0, r1, o0, cap = _chain_bounds(batch)
    # chains whose records or outputs overlap all take the serial route
    if not (bool((r0[1:] >= r1[:-1]).all())
            and bool((o0[1:] >= (o0 + cap)[:-1]).all())):
        return None
    dev = batch.wire.device
    nc = len(r0)
    counts = r1 - r0
    chain = torch.repeat_interleave(torch.arange(nc, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    k = torch.arange(len(chain), device=dev)
    idx = k - first[chain] + r0[chain]
    w = batch.rec_words[idx].to(torch.int64) & 0xFFFFFFFF
    src, w1, dst = w[:, 0], w[:, 1], w[:, 2]
    c_cap = cap[chain]
    off = (w1 & 0xFFFF).clamp(min=1)
    ll = (w1 >> 16) & 0xFF
    ml = (w1 >> 24) & 0xFF
    dst = torch.minimum(dst, c_cap) + W
    tot = torch.minimum(ll + ml, (W + c_cap - dst).clamp(max=SPAN))
    ll = torch.minimum(ll, tot)
    msrc = (dst + ll - off).clamp(min=0)
    s = torch.minimum(src, wlen[chain] - SPAN).clamp(min=0)
    prev_end = torch.cat([dst.new_zeros(1), (dst + tot)[:-1]])
    ok = ((k == first[chain]) | (dst >= prev_end)) \
        & ((tot == ll) | (msrc + tot - ll <= dst))
    conform = torch.ones(nc, dtype=torch.bool, device=dev)
    conform[chain[~ok]] = False
    keep = conform[chain]
    chain, dst, ll, tot, msrc, s = (x[keep] for x in
                                    (chain, dst, ll, tot, msrc, s))
    g = o0[chain] + dst - W
    lits = Lits(g, w0[chain] + s, w0[chain] + wlen[chain], ll)
    matches = Matches(g + ll, o0[chain], o0[chain] + msrc - W,
                      torch.full_like(g, NO_PERIOD), tot - ll)
    return conform, lits, matches


def decode_chains_resolved(batch: ChainBatch, segment: Optional[int] = None):
    """decode_chains as the CUDA kernels compute it, in plain PyTorch:
    stages A-D of ``ops/resolve.py`` for the conforming chains, the serial
    record walk (decode_chains_plain) for the rest. Returns (out, stats
    with the rounds per segment and the serially decoded chains)."""
    spans = record_spans(batch)
    nc = batch.wire_off.shape[0] - 1
    if spans is None:
        return decode_chains_plain(batch), dict(rounds=[], serial_chains=nc)
    conform, lits, matches = spans
    out, rounds = resolve_segments(batch.out_total, batch.wire, batch.seed,
                                   lits, matches, segment or SEGMENT)
    if not bool(conform.all()):
        plain = decode_chains_plain(batch)
        o0, cap = _chain_bounds(batch)[4:]
        for c in (~conform).nonzero().flatten().tolist():
            a, b = int(o0[c]), int(o0[c] + cap[c])
            out[a:b] = plain[a:b]
    return out, dict(rounds=rounds, serial_chains=int((~conform).sum()))


def decode_chains_plain(batch: ChainBatch) -> torch.Tensor:
    """decode_chains in plain PyTorch (any device): the same offsets
    clamps and record body, chains batched per record step."""
    _check(batch)
    wire, _, words, _, _, seed, out_total = batch
    dev = wire.device
    w0, wlen, r0, r1, o0, caps = _chain_bounds(batch)
    buf, io_base = decode_records_plain(
        wire, w0, wlen, words.to(torch.int64) & 0xFFFFFFFF, r0, r1 - r0,
        caps, seed)
    out = torch.zeros(out_total, dtype=torch.uint8, device=dev)
    owner = torch.repeat_interleave(torch.arange(len(caps), device=dev),
                                    caps)
    pos = torch.arange(int(caps.sum()), device=dev) \
        - (torch.cumsum(caps, 0) - caps)[owner]
    out[o0[owner] + pos] = buf[io_base[owner] + W + pos]
    return out
