"""Reference-identical greedy block encode: the CUDA kernel's wrapper and its
plain version.

``encode_blocks_pallas`` is the port of the TPU kernel ``_make_kernel`` of
``divortio_lz4_tpu/ops/pallas_encode.py:66`` (run by ``encode_blocks_pallas``
at ``:272``): the reference encoder's greedy hash-table scan, so each block's
bytes equal the host C++ encoder's. On a CUDA tensor it launches
``csrc/greedy_encode.cu`` (built by nvcc at first use) or raises; on a CPU
tensor it runs ``encode_blocks_pallas_plain``, the same function in plain
PyTorch, which the CPU tests use and ``chip_smoke.py`` holds the kernel
against. ``encode_blocks_pallas_batched_plain`` renders the kernel's own
algorithm (one probe a step while the scan hits, 32 probes a warp step
after a miss, with their hash conflicts) in PyTorch for the tests.
``encode_block_pallas_host`` is the JAX module's one-block numpy entry
point over the same wrapper.

Contract (both versions): ``work`` u8[nb, B] holds one block per row (its
first ``lens[b]`` bytes); the result is ``(out u8[nb, out_width(B)],
out_lens i64[nb])``, ``out[b, :out_lens[b]]`` the block's LZ4 stream and the
rest of the row zero. An empty row encodes to nothing. The TPU kernel took
the rows widened to i32 words and wrote ``out_len`` into its last row; both
are Mosaic layouts and are not ported.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._build import load_library
from .._device import resolve_device
from ..constants import (HASH_MASK, HASH_MULTIPLIER, HASH_SHIFT,
                         LAST_LITERALS, MF_LIMIT, MIN_MATCH, SKIP_TRIGGER,
                         WINDOW_SIZE, block_bound)
from .emit import extend, serialize
from .hybrid_encode import _mul32

CHECK_EVERY = 32    # plain probe steps between checks for a live row
LANES = 32          # probes per kernel step (one warp)


def out_width(block_size: int) -> int:
    """Row width of the encoded output: block_bound(block_size)."""
    return block_bound(block_size)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("greedy_encode").lz4t_greedy_encode
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, i64, p, i64, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(work, lens, block_size):
    if work.dtype != torch.uint8 or work.dim() != 2 \
            or not work.is_contiguous():
        raise ValueError("work must be a contiguous u8[nb, block_size]")
    if work.shape[1] != block_size or block_size < 1:
        raise ValueError(f"work rows of {work.shape[1]} bytes do not match "
                         f"block_size={block_size}")
    if (lens.dtype != torch.int64 or tuple(lens.shape) != (work.shape[0],)
            or not lens.is_contiguous()):
        raise ValueError("lens must be a contiguous i64[nb]")
    if lens.device != work.device:
        raise ValueError("all inputs must be on one device")


def encode_blocks_pallas(work: torch.Tensor, lens: torch.Tensor,
                         block_size: int):
    """Encode a batch of independent blocks with the reference's greedy
    scan. Returns (out u8[nb, out_width(block_size)], out_lens i64[nb]) on
    the inputs' device. On CUDA the kernel is queued on the current stream
    and nothing synchronises; ``launches`` counts those launches, and
    ``last_stats`` holds the last launch's i64[nb, 2] (warp steps and hits
    per block)."""
    _check(work, lens, block_size)
    if work.device.type == "cpu":
        return encode_blocks_pallas_plain(work, lens, block_size)
    if work.device.type != "cuda":
        raise ValueError(f"no greedy encode for device {work.device}")
    nb = work.shape[0]
    ow = out_width(block_size)
    out = torch.empty((nb, ow), dtype=torch.uint8, device=work.device)
    out_lens = torch.empty(nb, dtype=torch.int64, device=work.device)
    stats = torch.empty((nb, 2), dtype=torch.int64, device=work.device)
    if nb == 0:
        return out, out_lens
    fn = _kernel()
    with torch.cuda.device(work.device):
        stream = torch.cuda.current_stream(work.device).cuda_stream
        rc = fn(work.data_ptr(), nb, block_size, lens.data_ptr(), ow,
                out.data_ptr(), out_lens.data_ptr(), stats.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"greedy_encode kernel launch failed: "
                           f"cudaError {rc}")
    encode_blocks_pallas.launches += 1
    encode_blocks_pallas.last_stats = stats
    return out, out_lens


encode_blocks_pallas.launches = 0
encode_blocks_pallas.last_stats = None


def encode_block_pallas_host(data, block_size=None, *,
                             device="cuda") -> np.ndarray:
    """numpy bytes in, one LZ4 block out, through encode_blocks_pallas on
    *device* (``pallas_encode.py:352``): one row of B bytes, B =
    *block_size* or len(data) rounded up to 1 KB (at least 1 KB). On
    "cuda" it launches the kernel once; an empty block encodes to
    nothing."""
    dev = resolve_device(device)
    data = np.asarray(data, np.uint8)
    n = len(data)
    B = -(-max(n, 1024) // 1024) * 1024 if block_size is None else block_size
    work = np.zeros((1, B), np.uint8)
    work[0, :n] = data
    out, out_len = encode_blocks_pallas(
        torch.from_numpy(work).to(dev),
        torch.tensor([n], dtype=torch.int64, device=dev), B)
    return out[0, : int(out_len[0])].cpu().numpy()


def _scan_inputs(work: torch.Tensor):
    """(bytes as int64 with 3 zeros of padding, the LE32 word and its
    14-bit hash at every position) of each row."""
    nb, B = work.shape
    byts = torch.cat([work.to(torch.int64),
                      torch.zeros((nb, 3), dtype=torch.int64,
                                  device=work.device)], 1)
    words = byts[:, :B] | (byts[:, 1:B + 1] << 8) \
        | (byts[:, 2:B + 2] << 16) | (byts[:, 3:B + 3] << 24)
    return byts, words, \
        (_mul32(words, HASH_MULTIPLIER) >> HASH_SHIFT) & HASH_MASK


def encode_blocks_pallas_plain(work: torch.Tensor, lens: torch.Tensor,
                               block_size: int):
    """encode_blocks_pallas in plain PyTorch (any device): one torch step
    per probe, batched over rows, recording each row's hits; then one
    vectorized pass writes every sequence. u32 arithmetic runs in int64
    masked to 32 bits (``_mul32``)."""
    _check(work, lens, block_size)
    dev = work.device
    nb, B = work.shape
    ow = out_width(B)
    src_len = lens.clamp(0, B)
    byts, words, hashes = _scan_inputs(work)
    table = torch.zeros((nb, HASH_MASK + 1), dtype=torch.int64, device=dev)
    rows = torch.arange(nb, device=dev)
    mf_limit = src_len - MF_LIMIT
    match_limit = src_len - LAST_LITERALS
    fresh = (1 << SKIP_TRIGGER) + 3
    s = torch.zeros(nb, dtype=torch.int64, device=dev)
    anchor = torch.zeros_like(s)
    search = torch.full_like(s, fresh)
    hits = []          # per probe step: (hit, anchor, lit_len, offset, mlen)
    step = 0
    while nb and (step % CHECK_EVERY or bool((s < mf_limit).any())):
        step += 1
        live = s < mf_limit
        sc = s.clamp(0, B - 1)
        h = hashes[rows, sc]
        cand = table[rows, h] - 1
        table[rows, h] = torch.where(live, s + 1, cand + 1)
        cc = cand.clamp(min=0)
        hit = live & (cand >= 0) & (s != cand) & (s - cand < WINDOW_SIZE) \
            & (words[rows, cc] == words[rows, sc])
        k = extend(byts, s + MIN_MATCH, cc + MIN_MATCH, match_limit, hit)
        mlen = MIN_MATCH + k
        hits.append((hit, anchor, s - anchor, s - cand, mlen))
        adv = s + mlen
        s = torch.where(hit, adv, torch.where(live, s + (search >> 6), s))
        anchor = torch.where(hit, adv, anchor)
        search = torch.where(hit, fresh, torch.where(live, search + 1,
                                                     search))
    return serialize(work, src_len, hits, anchor, ow)


def encode_blocks_pallas_batched_plain(work: torch.Tensor, lens: torch.Tensor,
                                       block_size: int):
    """The CUDA kernel's algorithm in plain PyTorch (any device), for the
    tests. Each step probes s alone (the kernel's fast path while the scan
    hits); after a miss, one more step resolves the next LANES probes of
    the miss run at once, exactly as the warp does: lane i probes p_i = s +
    sum_{k<i} ((search + k) >> 6) if p_i < mf_limit; its candidate is the
    highest lower lane's position with the same hash, else the table's
    entry; the first good lane f hits, lanes 0..f write the table (per hash
    the highest), later lanes are dropped. Returns
    encode_blocks_pallas_plain's (out, out_lens) and the warp steps and hits
    per row (the kernel's ``last_stats``)."""
    _check(work, lens, block_size)
    dev = work.device
    nb, B = work.shape
    ow = out_width(B)
    src_len = lens.clamp(0, B)
    byts, words, hashes = _scan_inputs(work)
    table = torch.zeros((nb, HASH_MASK + 1), dtype=torch.int64, device=dev)
    rows = torch.arange(nb, device=dev)
    lane = torch.arange(LANES, device=dev)
    lower = lane[None, :] < lane[:, None]          # [i, j]: j below i
    mf_limit = src_len - MF_LIMIT
    match_limit = src_len - LAST_LITERALS
    fresh = (1 << SKIP_TRIGGER) + 3
    s = torch.zeros(nb, dtype=torch.int64, device=dev)
    anchor = torch.zeros_like(s)
    search = torch.full_like(s, fresh)
    steps = torch.zeros_like(s)
    nhits = torch.zeros_like(s)
    hits = []
    while nb and bool((s < mf_limit).any()):
        # the probe at s alone
        live = s < mf_limit
        sc = s.clamp(0, B - 1)
        h0 = hashes[rows, sc]
        c0 = table[rows, h0] - 1
        table[rows, h0] = torch.where(live, s + 1, c0 + 1)
        good0 = live & (c0 >= 0) & (s != c0) & (s - c0 < WINDOW_SIZE) \
            & (words[rows, c0.clamp(min=0)] == words[rows, sc])
        steps += live.long()
        # after a miss, LANES probes of the miss run in one step
        miss = live & ~good0
        s = torch.where(miss, s + (search >> SKIP_TRIGGER), s)
        search = torch.where(miss, search + 1, search)
        run = miss & (s < mf_limit)
        step = (search[:, None] + lane) >> SKIP_TRIGGER
        p = s[:, None] + torch.cumsum(step, 1) - step
        joined = run[:, None] & (p < mf_limit[:, None])
        pc = p.clamp(0, B - 1)
        h = torch.gather(hashes, 1, pc)
        w = torch.gather(words, 1, pc)
        same = (h[:, :, None] == h[:, None, :]) & lower \
            & joined[:, None, :]                     # [row, i, j]
        below = torch.where(same, lane, -1).amax(2)  # highest such j
        cand = torch.where(below >= 0,
                           torch.gather(p, 1, below.clamp(min=0)),
                           torch.gather(table, 1, h) - 1)
        cc = cand.clamp(0, B - 1)
        good = joined & (cand >= 0) & (p != cand) & (p - cand < WINDOW_SIZE) \
            & (torch.gather(words, 1, cc) == w)
        hit1 = good.any(1)
        f = torch.where(hit1, good.to(torch.int8).argmax(1), LANES - 1)
        probed = joined & (lane <= f[:, None])
        later = same.transpose(1, 2) & probed[:, None, :]  # [row, i, j>i]
        writer = probed & ~later.any(2)
        wr, wl = writer.nonzero(as_tuple=True)
        table[wr, h[wr, wl]] = p[wr, wl] + 1
        steps += run.long()
        hit = good0 | hit1
        hs = torch.where(good0, s, p[rows, f])
        hc = torch.where(good0, c0, cand[rows, f])
        k = extend(byts, hs + MIN_MATCH, hc.clamp(min=0) + MIN_MATCH,
                   match_limit, hit)
        mlen = MIN_MATCH + k
        hits.append((hit, anchor, hs - anchor, hs - hc, mlen))
        nhits += hit.long()
        s = torch.where(hit, hs + mlen,
                        torch.where(run, s + step.sum(1), s))
        anchor = torch.where(hit, hs + mlen, anchor)
        search = torch.where(hit, fresh,
                             torch.where(run, search + LANES, search))
    out, out_lens = serialize(work, src_len, hits, anchor, ow)
    return out, out_lens, torch.stack([steps, nhits], 1)
