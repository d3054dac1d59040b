"""Padded-record decode of independent wide blocks (256 KB): host parse, the
CUDA kernel's wrapper, and its plain version.

``decode_blocks_wire`` is the port of the TPU kernel ``_make_wire_kernel``
(``divortio_lz4_tpu/ops/pallas_split_decode.py:565``, run by
``decode_blocks_wire`` at ``:1079``) on its wide record form. On a CUDA
tensor it launches ``lz4t_wire_decode`` of ``csrc/chain_decode.cu``; on a
CPU tensor it runs ``decode_blocks_wire_plain``.

Block b's records are ``recs[b, :counts[b]]``, each ``(src, off | ll<<16 |
ml<<24)``; a record's output position is the running sum of ``ll+ml`` over
the block's earlier records (the cumsum of ``_expand_wire_records``,
``:530-562``). The TPU path's interleave (``trips``, ``ways``, ``pair``),
density tiers (``partition_by_plan``) and record-cap buckets
(``_cap_bucket``) exist for SMEM and VMEM and are not ported.

The kernel does not walk a block's records in order. It runs the chain
route's stages on the padded form, every block a chain: a per-block scan
of ``ll+ml`` gives each record's dst on the device, then the conformance
check, spans, pointer doubling and gather of ``ops/resolve.py`` (with
each block's own history row as its seed). A block whose records fail the
check, which only random words do, decodes with the serial record walk in
the same call. ``decode_blocks_wire_resolved`` is the plain rendition of
that design; ``decode_blocks_wire_plain`` stays the definition.

Every block decodes after a 64 KB seed window: its history row, or zeros
(the TPU kernel without history clamps such reads to the row start
instead; only records the parser would reject reach there). Bytes no
record writes are zeros.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .._build import load_library
from ..tracing import span
from .resolve import SEGMENT, ResolveRun, resolve_segments, rounds_for
from .split_decode import parse_wire_raw
from .wave_decode import W, ChainBatch, decode_records_plain, record_spans


def parse_wire_batch(entries, block_size: int, window=None):
    """Parse a batch of (wire bytes, is_stored) entries into the padded
    wide form. Returns (wire u8[nb, wire_cap], recs i32[nb, cap, 2],
    counts i32[nb], out_lens i64[nb], hist u8[nb, W] | None), cap the
    largest record count (at least 1)."""
    wire, recs_l, counts, out_lens, hist = parse_wire_raw(
        entries, block_size, window)
    with span("decode.records"):
        recs = np.zeros((len(entries), max(int(counts.max(initial=0)), 1),
                         2), np.uint32)
        for i, r in enumerate(recs_l):
            recs[i, : len(r)] = r
    return wire, recs.view(np.int32), counts, out_lens, hist


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("chain_decode").lz4t_wire_decode
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, i64, p, i64, p, p, i64, p, p, p, i64, p,
                   ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def _check(wire, recs, counts, block_size, hist):
    nb = wire.shape[0] if wire.dim() == 2 else -1
    if wire.dtype != torch.uint8 or nb < 0 or not wire.is_contiguous():
        raise ValueError("wire must be a contiguous u8[nb, wire_cap]")
    if (recs.dtype != torch.int32 or recs.dim() != 3
            or recs.shape[0] != nb or recs.shape[2] != 2
            or not recs.is_contiguous()):
        raise ValueError("recs must be a contiguous i32[nb, cap, 2]")
    if (counts.dtype != torch.int32 or tuple(counts.shape) != (nb,)
            or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous i32[nb]")
    if not (16 <= block_size and block_size % 16 == 0):
        raise ValueError(f"block_size {block_size} must be a multiple of 16")
    if hist is not None and (hist.dtype != torch.uint8
                             or tuple(hist.shape) != (nb, W)
                             or not hist.is_contiguous()):
        raise ValueError(f"hist must be a contiguous u8[nb, {W}]")
    tensors = [wire, recs, counts] + ([] if hist is None else [hist])
    if any(x.device != wire.device for x in tensors):
        raise ValueError("all inputs must be on one device")


def decode_blocks_wire(wire: torch.Tensor, recs: torch.Tensor,
                       counts: torch.Tensor, block_size: int,
                       hist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode a batch of blocks from their padded record rows.

    wire u8[nb, wire_cap]; recs i32[nb, cap, 2]; counts i32[nb]; hist
    u8[nb, 65536] (each block's own history row) or None. Returns u8[nb,
    block_size] on the inputs' device (lengths come from the host parser).
    On CUDA the kernels are queued on the current stream and nothing
    synchronises; ``launches`` counts those calls, and ``last`` (a
    ResolveRun) keeps what the call left on the device: its ``stats()``
    gives the rounds, the blocks decoded serially (``serial_chains``) and
    the scratch bytes: 4 B a record slot (dst), 4 B an output byte (codes)
    and the flags. The kernels take block_size < 2**31."""
    _check(wire, recs, counts, block_size, hist)
    if wire.device.type == "cpu":
        return decode_blocks_wire_plain(wire, recs, counts, block_size, hist)
    if wire.device.type != "cuda":
        raise ValueError(f"no wire decode for device {wire.device}")
    if block_size >= 1 << 31:
        raise ValueError("block_size must be < 2**31 on CUDA")
    dev = wire.device
    nb, cap = wire.shape[0], recs.shape[1]
    out = torch.empty((nb, block_size), dtype=torch.uint8, device=dev)
    if nb == 0:
        return out
    out_total = nb * block_size
    seg = min(SEGMENT, out_total)
    nseg = -(-out_total // seg)
    rounds = rounds_for(seg)
    dst = torch.empty(nb * cap, dtype=torch.int32, device=dev)
    code = torch.empty(seg, dtype=torch.int32, device=dev)
    flags = torch.zeros(1 + nb + nseg * rounds, dtype=torch.int32,
                        device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(wire.data_ptr(), nb, wire.shape[1], recs.data_ptr(), cap,
                counts.data_ptr(), None if hist is None else hist.data_ptr(),
                block_size, out.data_ptr(), dst.data_ptr(), code.data_ptr(),
                seg, flags.data_ptr(), rounds, stream)
    if rc != 0:
        raise RuntimeError(f"wire_decode kernel launch failed: "
                           f"cudaError {rc}")
    decode_blocks_wire.launches += 1
    decode_blocks_wire.last = ResolveRun(
        flags, nb, True, nseg, rounds,
        4 * (dst.numel() + code.numel() + flags.numel()))
    return out


decode_blocks_wire.launches = 0
decode_blocks_wire.last = None


def decode_blocks_wire_plain(wire: torch.Tensor, recs: torch.Tensor,
                             counts: torch.Tensor, block_size: int,
                             hist: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The same function in plain PyTorch (any device): dst by cumsum over
    each row, then the shared record body with every block its own
    chain."""
    _check(wire, recs, counts, block_size, hist)
    dev = wire.device
    nb, wire_cap = wire.shape
    cap = recs.shape[1]
    r = recs.to(torch.int64) & 0xFFFFFFFF
    tot = ((r[..., 1] >> 16) & 0xFF) + ((r[..., 1] >> 24) & 0xFF)
    dst = torch.cumsum(tot, 1) - tot
    words = torch.stack([r[..., 0], r[..., 1], dst], -1).reshape(-1, 3)
    rows = torch.arange(nb, device=dev)
    buf, io_base = decode_records_plain(
        wire.reshape(-1), rows * wire_cap,
        torch.full((nb,), wire_cap, device=dev), words, rows * cap,
        counts.to(torch.int64).clamp(0, cap),
        torch.full((nb,), block_size, device=dev), hist)
    return buf[io_base[:, None] + W + torch.arange(block_size, device=dev)]


def wire_chains(wire: torch.Tensor, recs: torch.Tensor, counts: torch.Tensor,
                block_size: int) -> ChainBatch:
    """The padded batch as the CUDA kernels read it, in the chain form:
    block b is chain b, its wire row, its first counts[b] records and its
    output row; each record's dst is the running sum of ll+ml over the
    block's earlier records, stored as at most block_size (the kernels'
    u32 dst saturates there; the record clamp reads both alike)."""
    _check(wire, recs, counts, block_size, None)
    dev = wire.device
    nb, wire_cap = wire.shape
    cap = recs.shape[1]
    r = recs.to(torch.int64) & 0xFFFFFFFF
    tot = ((r[..., 1] >> 16) & 0xFF) + ((r[..., 1] >> 24) & 0xFF)
    dst = (torch.cumsum(tot, 1) - tot).clamp(max=block_size)
    n = counts.to(torch.int64).clamp(0, cap)
    keep = torch.arange(cap, device=dev)[None, :] < n[:, None]
    words = torch.stack([r[..., 0], r[..., 1], dst], -1)[keep]
    rows = torch.arange(nb + 1, device=dev)
    rec_off = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    rec_off[1:] = torch.cumsum(n, 0)
    return ChainBatch(wire.reshape(-1), rows * wire_cap,
                      words.to(torch.int32).contiguous(), rec_off,
                      rows * block_size, None, nb * block_size)


def decode_blocks_wire_resolved(wire: torch.Tensor, recs: torch.Tensor,
                                counts: torch.Tensor, block_size: int,
                                hist: Optional[torch.Tensor] = None,
                                segment: Optional[int] = None):
    """decode_blocks_wire as the CUDA kernels compute it, in plain
    PyTorch: the dst scan (wire_chains), the record path's conformance
    check and spans (wave_decode.record_spans), stages B-D of
    ``ops/resolve.py`` with each block's history row as its seed, and the
    serial record walk (decode_blocks_wire_plain) for the blocks that do
    not conform. Returns (out u8[nb, block_size], stats with the rounds per
    segment and the blocks decoded serially)."""
    _check(wire, recs, counts, block_size, hist)
    nb = wire.shape[0]
    batch = wire_chains(wire, recs, counts, block_size)
    conform, lits, matches = record_spans(batch)
    out, rounds = resolve_segments(
        batch.out_total, batch.wire, hist, lits, matches,
        segment or SEGMENT,
        None if hist is None else matches.o0 // block_size)
    out = out.view(nb, block_size)
    bad = (~conform).nonzero().flatten()
    if len(bad):
        out[bad] = decode_blocks_wire_plain(wire, recs, counts, block_size,
                                            hist)[bad]
    return out, dict(rounds=rounds, serial_chains=len(bad))
