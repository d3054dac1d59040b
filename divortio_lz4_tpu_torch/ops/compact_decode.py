"""Compact-record decode: the CUDA kernel's wrapper and its plain versions.

``decode_blocks_compact`` is the port of the TPU kernel
``_make_wire_kernel_compact`` (``divortio_lz4_tpu/ops/pallas_split_decode.py
:689``). On a CUDA tensor it launches ``csrc/compact_decode.cu`` (built by
nvcc at first use) or raises; on a CPU tensor it runs
``decode_blocks_compact_plain``, the same function in plain PyTorch, which
the CPU tests use and ``chip_smoke.py`` holds the kernel against.
``decode_blocks_compact_grouped_plain`` renders the kernel's own algorithm
(conformance check, literals first, matches by dependency levels in groups
of 32 records, the serial route for blocks that fail the check) with its
per-block stats, for the CPU tests.

Contract (every version): block b's records are
``rec_words[rec_off[b]:rec_off[b+1]]``; each writes at most 128 bytes at
``dst`` (literals from ``wire[b, src:]``, then a match from ``dst + ll -
off`` in the output), reading every byte before writing any. The TPU
kernel's clamps keep garbage records inside their own row. The result is
u8[nb, block_size]: ``out[b, :out_lens[b]]`` is the decoded block and the
rest of the row is zero.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .._build import load_library
from .record_groups import run_groups

W = 65536       # dictionary history ahead of the payload
SPAN = 128      # output bytes one record covers at most
STATS = ("records", "groups", "levels", "most levels", "serial")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("compact_decode").lz4t_compact_decode
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, i64, p, i64, p, p, p, i64, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(wire, rec_words, rec_off, out_lens, block_size, hist):
    nb = wire.shape[0] if wire.dim() == 2 else -1
    if wire.dtype != torch.uint8 or nb < 0 or not wire.is_contiguous():
        raise ValueError("wire must be a contiguous u8[nb, wire_cap]")
    if wire.shape[1] % SPAN or wire.shape[1] < 2 * SPAN:
        raise ValueError(f"wire_cap {wire.shape[1]} must be a multiple of "
                         f"{SPAN} and >= {2 * SPAN}")
    if (rec_words.dtype != torch.int32 or rec_words.dim() != 2
            or rec_words.shape[1] != 2 or not rec_words.is_contiguous()):
        raise ValueError("rec_words must be a contiguous i32[N, 2]")
    if (rec_off.dtype != torch.int64 or tuple(rec_off.shape) != (nb + 1,)
            or not rec_off.is_contiguous()):
        raise ValueError("rec_off must be a contiguous i64[nb + 1]")
    if (out_lens.dtype != torch.int64 or tuple(out_lens.shape) != (nb,)
            or not out_lens.is_contiguous()):
        raise ValueError("out_lens must be a contiguous i64[nb]")
    if not (16 <= block_size <= W and block_size % 16 == 0):
        raise ValueError(f"block_size {block_size} must be a multiple of 16 "
                         f"in [16, {W}]")
    if hist is not None and (hist.dtype != torch.uint8
                             or tuple(hist.shape) != (nb, W)
                             or not hist.is_contiguous()):
        raise ValueError(f"hist must be a contiguous u8[nb, {W}]")
    tensors = [wire, rec_words, rec_off, out_lens] + \
        ([] if hist is None else [hist])
    if any(x.device != wire.device for x in tensors):
        raise ValueError("all inputs must be on one device")


def decode_blocks_compact(wire: torch.Tensor, rec_words: torch.Tensor,
                          rec_off: torch.Tensor, out_lens: torch.Tensor,
                          block_size: int,
                          hist: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Decode a batch of blocks from their flat record streams.

    wire u8[nb, wire_cap]; rec_words i32[N, 2]; rec_off i64[nb + 1];
    out_lens i64[nb]; hist u8[nb, 65536] or None. Returns u8[nb,
    block_size] on the inputs' device. On CUDA the kernels are queued on
    the current stream and nothing synchronises; ``launches`` counts those
    launches and ``last_stats`` (i32[nb, 5] on the device) holds, per
    block, the records, groups of 32, levels (their sum and the largest
    group's) and the serial-route flag
    (decode_blocks_compact_grouped_plain's stats)."""
    _check(wire, rec_words, rec_off, out_lens, block_size, hist)
    if wire.device.type == "cpu":
        return decode_blocks_compact_plain(wire, rec_words, rec_off,
                                           out_lens, block_size, hist)
    if wire.device.type != "cuda":
        raise ValueError(f"no compact decode for device {wire.device}")
    nb = wire.shape[0]
    out = torch.empty((nb, block_size), dtype=torch.uint8,
                      device=wire.device)
    stats = torch.zeros((nb, len(STATS)), dtype=torch.int32,
                        device=wire.device)
    decode_blocks_compact.last_stats = stats
    if nb == 0:
        return out
    if rec_words.data_ptr() % 8 or (hist is not None
                                    and hist.data_ptr() % 16):
        raise ValueError("rec_words must be 8-byte and hist 16-byte aligned")
    fn = _kernel()
    with torch.cuda.device(wire.device):
        stream = torch.cuda.current_stream(wire.device).cuda_stream
        rc = fn(wire.data_ptr(), nb, wire.shape[1], rec_words.data_ptr(),
                rec_words.shape[0], rec_off.data_ptr(), out_lens.data_ptr(),
                None if hist is None else hist.data_ptr(), block_size,
                out.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"compact_decode kernel launch failed: "
                           f"cudaError {rc}")
    decode_blocks_compact.launches += 1
    return out


decode_blocks_compact.launches = 0
decode_blocks_compact.last_stats = None


def decode_blocks_compact_plain(wire: torch.Tensor, rec_words: torch.Tensor,
                                rec_off: torch.Tensor,
                                out_lens: torch.Tensor, block_size: int,
                                hist: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The same function in plain PyTorch: one step per record index k,
    batched over all blocks, gathering then scattering <= 128 bytes per
    block with the kernel's clamps. Works on any device."""
    _check(wire, rec_words, rec_off, out_lens, block_size, hist)
    dev = wire.device
    nb, wire_cap = wire.shape
    n_rec = rec_words.shape[0]
    out_base = W if hist is not None else 0
    bs_limit = out_base + block_size
    # SPAN spare bytes per row take the stores of lanes past a record's end.
    io_w = bs_limit + SPAN
    io = torch.zeros((nb, io_w), dtype=torch.uint8, device=dev)
    if hist is not None:
        io[:, :W] = hist
    r0 = rec_off[:-1].clamp(0, n_rec)
    counts = torch.maximum(rec_off[1:].clamp(0, n_rec), r0) - r0
    steps = int(counts.max()) if nb else 0
    words = rec_words.to(torch.int64) & 0xFFFFFFFF
    t = torch.arange(SPAN, device=dev)[None, :]
    row_io = torch.arange(nb, device=dev)[:, None] * io_w
    row_wire = torch.arange(nb, device=dev)[:, None] * wire_cap
    io_flat = io.view(-1)
    wire_flat = wire.reshape(-1)
    for k in range(steps):
        rec = words[(r0 + k).clamp(max=n_rec - 1)]
        w0, w1 = rec[:, 0], rec[:, 1]
        ll = (w0 >> 16) & 0xFF
        ml = (w0 >> 24) & 0xFF
        dst = (w1 & 0xFFFF).clamp(max=block_size) + out_base
        off = ((w1 >> 16) & 0xFFFF).clamp(min=1)
        tot = torch.minimum(ll + ml, (bs_limit - dst).clamp(max=SPAN))
        tot = torch.where(k < counts, tot, 0)
        ll = torch.minimum(ll, tot)
        msrc = (dst + ll - off).clamp(min=0)
        src = (w0 & 0xFFFF).clamp(max=wire_cap - 2 * SPAN)
        lit = wire_flat[row_wire + src[:, None] + t]
        mat = io_flat[row_io + (msrc[:, None] + t - ll[:, None]).clamp(min=0)]
        val = torch.where(t < ll[:, None], lit, mat)
        tgt = torch.where(t < tot[:, None], dst[:, None] + t, bs_limit + t)
        io_flat[row_io + tgt] = val
    keep = torch.arange(block_size, device=dev)[None, :] \
        < out_lens.clamp(0, block_size)[:, None]
    return torch.where(keep, io[:, out_base:bs_limit], 0).to(torch.uint8)


def _conforms(src, ll, ml, dst, off, excl, block_size, out_base, src_max):
    """The kernel's conformance check of each record (raw fields; excl is
    the block's earlier ll + ml). Records that write nothing pass."""
    tot = ll + ml
    return (tot == 0) | ((dst <= block_size) & (tot <= SPAN)
                         & (dst + tot <= block_size) & (src <= src_max)
                         & (off >= 1) & (dst == excl)
                         & ((ml == 0) | ((off >= tot)
                                         & (out_base + dst + ll - off >= 0))))


def decode_blocks_compact_grouped_plain(wire: torch.Tensor,
                                        rec_words: torch.Tensor,
                                        rec_off: torch.Tensor,
                                        out_lens: torch.Tensor,
                                        block_size: int,
                                        hist: Optional[torch.Tensor] = None):
    """decode_blocks_compact as ``csrc/compact_decode.cu`` computes it, in
    plain numpy over each block, for the tests:

    1. the conformance check on every record that writes (ll + ml > 0):
       no clamp binds, dst is the running sum of the block's earlier
       ll + ml, and a match reads only bytes before its record and none
       below the io row; a block that fails it is decoded by the serial
       plain version (decode_blocks_compact_plain);
    2. every literal, in no order;
    3. the matches in groups of 32 records by dependency levels
       (``record_groups.run_levels``).

    Returns (out, stats i64[nb, 5]): per block the records, groups,
    levels (their sum and the largest group's) and the serial-route flag
    (``decode_blocks_compact.last_stats`` on CUDA)."""
    _check(wire, rec_words, rec_off, out_lens, block_size, hist)
    nb, wire_cap = wire.shape
    n_rec = rec_words.shape[0]
    base = W if hist is not None else 0
    rows = wire.cpu().numpy()
    words = rec_words.cpu().numpy().view(np.uint32).astype(np.int64)
    offs = rec_off.cpu().numpy()
    lens = out_lens.cpu().numpy()
    hists = None if hist is None else hist.cpu().numpy()
    out = np.zeros((nb, block_size), np.uint8)
    stats = np.zeros((nb, len(STATS)), np.int64)
    for b in range(nb):
        r0 = min(max(int(offs[b]), 0), n_rec)
        r1 = min(max(int(offs[b + 1]), r0), n_rec)
        w0, w1 = words[r0:r1, 0], words[r0:r1, 1]
        src, ll, ml = w0 & 0xFFFF, (w0 >> 16) & 0xFF, w0 >> 24
        dst, off = w1 & 0xFFFF, w1 >> 16
        tot = ll + ml
        excl = np.cumsum(tot) - tot
        if not _conforms(src, ll, ml, dst, off, excl, block_size, base,
                         wire_cap - 2 * SPAN).all():
            stats[b] = (r1 - r0, 0, 0, 0, 1)
            continue
        io = np.zeros(base + block_size, np.uint8)
        if hists is not None:
            io[:base] = hists[b]
        for s, n, d in zip(src[ll > 0], ll[ll > 0], dst[ll > 0]):
            io[base + d: base + d + n] = rows[b, s: s + n]
        md = base + dst + ll
        groups, levels, most = run_groups(io, md - off, md, ml)
        stats[b] = (r1 - r0, groups, levels, most, 0)
        olen = min(max(int(lens[b]), 0), block_size)
        out[b, :olen] = io[base: base + olen]
    got = torch.from_numpy(out)
    serial = np.flatnonzero(stats[:, 4])
    if len(serial):
        got[serial] = decode_blocks_compact_plain(
            wire, rec_words, rec_off, out_lens, block_size,
            hist).cpu()[serial]
    dev = wire.device
    return got.to(dev), torch.from_numpy(stats).to(dev)
