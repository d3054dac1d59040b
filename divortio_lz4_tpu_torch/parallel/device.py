"""Frame codec on a torch device: the split, pallas, hybrid and xla
engines.

Port of ``divortio_lz4_tpu/parallel/device.py``
(``device_compress_frame(s)``, ``device_decompress_frame(s)``), every
engine and every route of it. The port's default engine is "split" (the
fastest on the card and what the benchmarks' round trip runs); the JAX
package's single-frame default is "xla".

Split engine:

- Encode, every block size and mode: ``parallel/bigblock.py`` holds the
  encoder. ``queue_frame_big`` queues the chain build
  (``ops/split_encode.encode_blocks_chain``) on the frame's 64 KB segment
  rows with their 64 KB of history; ``splice_blocks_big`` serializes every
  segment on the host pool and splices a bigger block's segments into one
  stream (a 64 KB block is one segment); ``_assemble_frame_host`` builds
  the frame.
- Decode routes as the JAX package does:
  independent <= 64 KB blocks -> compact kernel (``ops/compact_decode``);
  independent 256 KB blocks -> padded wire kernel (``ops/wire_decode``);
  independent 1-4 MB blocks and every linked frame -> chain kernel
  (``ops/wave_decode``).

Pallas engine (the JAX routes of ``device.py:161-169, 623-645``, so that
verdicts match):

- Encode: independent frames without a dictionary, at every block size,
  through the greedy kernel (``ops/greedy_encode``, reference-identical
  bytes) and ``_assemble_frame_host``. Linked frames and dictionaries go
  to the XLA encoder, as in JAX.
- Decode: independent frames whose rows fit the TPU kernel's VMEM budget
  (``_pallas_indep_fits``) -> token decode per block
  (``ops/token_decode.decode_blocks_pallas``); other independent frames
  and linked frames of blocks over 256 KB -> the native scan of every
  block (the checks of ``bigblock._plan_pieces``), then the linked token
  kernel, one chain per independent block or one for the linked frame;
  linked frames of blocks up to 256 KB -> one chain, no scan.

Hybrid engine (the JAX routes of ``device.py:137-151, 152-218,
721-792``): blocks of up to 64 KB encode through
``ops/hybrid_encode.encode_blocks_hybrid`` (exact-word packed chains, then
the walk kernel), as ``[history | payload]`` rows where a dictionary or a
linked frame gives history; bigger blocks take the split engine's
big-block route, as JAX's ``compress_frame_big`` does. Hybrid decode is
the XLA decode, as JAX's fall-through (``device.py:639-647``) makes it.

XLA engine: the sort-based encoder (``ops/encode_xla``) over the same
rows, and the two-phase decoder (``ops/decode_xla``; linked frames block
after block, ``ops/linked_xla``), torch ops on the device.
``assemble="device"`` builds the block section with
``ops/assemble_xla.assemble_blocks``; independent frames without stored
blocks are joined on the device with ``concat_blocks``.

Linked frames with block checksums encode on the host
(``frame.compress_frame``) on every engine but split up to 64 KB, as in
JAX (``device.py:736-740``). ``_encode_route`` holds the whole encode
routing. Row-encoded frames are assembled on the host as JAX's
``_host_assemble`` does (an empty payload makes a frame with no block).

``compress_frames`` / ``decompress_frames`` queue every frame's device
work first, whatever its configuration, fetch all of it with one
device-to-host copy, then finish each frame on the host. The single-frame
entry points are the one-frame case. The XLA engine's loops read their
exit tests on the host, so its work is not queued behind the others'.

The frame host helpers below are copies of the JAX module's (it imports
jax at module level); their semantics and "LZ4: ..." errors are unchanged.
An engine name JAX does not have raises ValueError; nothing falls back to
another codec.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, FrameConfig
from ..constants import (
    BLOCK_SIZE_MASK,
    FLG_BLOCK_CHECKSUM,
    FLG_CONTENT_CHECKSUM,
    FLG_CONTENT_SIZE,
    FLG_DICT_ID,
    FLG_VERSION_MASK,
    LZ4_VERSION,
    MAGIC_NUMBER,
    UNCOMPRESSED_FLAG,
    WINDOW_SIZE,
)
from .._device import resolve_device
from ..constants import block_bound
from ..frame import compress_frame as compress_frame_host
from ..ops.assemble_xla import assemble_blocks, concat_blocks
from ..ops.compact_decode import decode_blocks_compact
from ..ops.decode_xla import decode_blocks_batch
from ..ops.encode_xla import encode_blocks_batch
from ..ops.greedy_encode import encode_blocks_pallas
from ..ops.hybrid_encode import encode_blocks_hybrid
from ..ops.linked_xla import decode_linked_scan
from ..ops.split_decode import CompactBatch, stage_compact_batch
from ..ops.token_decode import (TokenChains, decode_blocks_pallas,
                                decode_token_chains)
from ..ops.wave_decode import block_pieces, decode_chains, stage_chains
from ..ops.wire_decode import decode_blocks_wire, parse_wire_batch
from ..tracing import count, put, span
from ..utils import ensure_buffer, host_pool, read_u32le, write_u32le
from ..xxh import xxhash32
from .bigblock import (SEG, history_rows, queue_frame_big,
                       splice_blocks_big)

# Largest block the compact decode kernel takes (u16 record fields); the
# split engine sends bigger blocks through JAX's big-block encode routes.
SPLIT_MAX_BS = 65536
# Largest independent block the padded wire kernel decodes
# (device.py:_SPLIT_MAX_BS); bigger ones decode as chains.
WIRE_MAX_BS = 262144
# The JAX package's engines, every one ported.
ENCODE_ENGINES = ("split", "pallas", "hybrid", "xla")
DECODE_ENGINES = ("split", "pallas", "xla", "hybrid")
# The pallas decode router's constants (pallas_decode.py SLACK and
# VMEM_BUDGET, device.py:_PALLAS_LINKED_MAX_BS): they decide which route a
# frame takes, and so which errors it can raise.
PALLAS_SLACK = 256
PALLAS_VMEM_BUDGET = 6 * 1024 * 1024
PALLAS_LINKED_MAX_BS = 262144


def _frame_header_bytes(config: FrameConfig, n: int,
                        dict_id: Optional[int] = None) -> np.ndarray:
    """Frame header (magic..header checksum)."""
    hdr = np.empty(19, np.uint8)
    hdr[0:4] = (0x04, 0x22, 0x4D, 0x18)
    flg = LZ4_VERSION << 6
    if config.block_independence:
        flg |= 0x20
    if config.content_checksum:
        flg |= FLG_CONTENT_CHECKSUM
    if config.block_checksums:
        flg |= FLG_BLOCK_CHECKSUM
    if config.content_size:
        flg |= FLG_CONTENT_SIZE
    if dict_id is not None:
        flg |= FLG_DICT_ID
    hdr[4] = flg
    hdr[5] = (config.block_id & 0x07) << 4
    pos = 6
    if config.content_size:
        write_u32le(hdr, pos, n & 0xFFFFFFFF)
        write_u32le(hdr, pos + 4, n >> 32)
        pos += 8
    if dict_id is not None:
        write_u32le(hdr, pos, dict_id)
        pos += 4
    hdr[pos] = (xxhash32(hdr[4:pos], 0) >> 8) & 0xFF
    return hdr[: pos + 1]


def _dict_window(dictionary) -> tuple[Optional[np.ndarray], Optional[int]]:
    """Last-64KB window + dictID of a dictionary (None, None when absent)."""
    if dictionary is None:
        return None, None
    dict_buf = ensure_buffer(dictionary)
    if len(dict_buf) == 0:
        return None, None
    dict_id = xxhash32(dict_buf, 0)
    window = dict_buf[-WINDOW_SIZE:]
    return np.asarray(window, np.uint8), dict_id


def _assemble_frame_host(raw, comps, lens, nblocks, bs, config,
                         dict_id) -> np.ndarray:
    """Host frame assembly over per-block wire streams: header, size
    words, stored fallback, optional block checksums, EndMark, content
    checksum."""
    with span("frame.assemble"):
        n = len(raw)
        frame = np.empty(19 + n + (n // 255) + 16 * max(nblocks, 1) + 8,
                         np.uint8)
        header = _frame_header_bytes(config, n, dict_id)
        frame[: len(header)] = header
        pos = len(header)
        hashed = []         # (data start, checksum position) per block
        for b in range(nblocks):
            bsize = int(lens[b])
            comp = comps[b]
            clen = len(comp)
            if 0 < clen < bsize:
                write_u32le(frame, pos, clen)
                pos += 4
                frame[pos: pos + clen] = comp
                pos += clen
                data_start = pos - clen
            else:
                write_u32le(frame, pos, bsize | UNCOMPRESSED_FLAG)
                pos += 4
                frame[pos: pos + bsize] = raw[b * bs: b * bs + bsize]
                pos += bsize
                data_start = pos - bsize
            if config.block_checksums:
                hashed.append((data_start, pos))
                pos += 4
        write_u32le(frame, pos, 0)
        pos += 4
        if hashed or config.content_checksum:
            with span("frame.xxh32"):
                for start, at in hashed:
                    write_u32le(frame, at, xxhash32(frame[start:at], 0))
                if config.content_checksum:
                    write_u32le(frame, pos, xxhash32(raw, 0))
                    pos += 4
        return frame[:pos]


def parse_block_index(buf: np.ndarray, verify_checksum: bool = True):
    """Host scan of a frame's block table.

    Returns (header, blocks, tail_pos) where blocks is a list of
    (data_offset, size, is_stored). Every declared block size is
    bounds-checked and the EndMark must be present ("LZ4: Malformed
    Input" otherwise); the header-checksum byte is verified unless
    *verify_checksum* is False."""
    n = len(buf)
    if n < 7 or read_u32le(buf, 0) != MAGIC_NUMBER:
        raise ValueError("LZ4: Invalid Magic Number")
    pos = 4
    flg = int(buf[pos]); pos += 1
    if (flg & FLG_VERSION_MASK) >> 6 != LZ4_VERSION:
        raise ValueError("LZ4: Unsupported Version")
    bd = int(buf[pos]); pos += 1
    header = {
        "independent": bool(flg & 0x20),
        "block_checksums": bool(flg & FLG_BLOCK_CHECKSUM),
        "content_size": None,
        "content_checksum": bool(flg & FLG_CONTENT_CHECKSUM),
        "dict_id": None,
        "block_max": {4: 65536, 5: 262144, 6: 1048576, 7: 4194304}.get(
            (bd >> 4) & 0x07, 4194304),
    }
    if flg & FLG_CONTENT_SIZE:
        if pos + 8 > n:
            raise ValueError("LZ4: Malformed Input")
        header["content_size"] = read_u32le(buf, pos) | (
            read_u32le(buf, pos + 4) << 32)
        pos += 8
    if flg & FLG_DICT_ID:
        if pos + 4 > n:
            raise ValueError("LZ4: Malformed Input")
        header["dict_id"] = read_u32le(buf, pos)
        pos += 4
    if pos >= n:
        raise ValueError("LZ4: Malformed Input")
    if verify_checksum:
        expect_hc = (xxhash32(buf[4:pos], 0) >> 8) & 0xFF
        if int(buf[pos]) != expect_hc:
            raise ValueError("LZ4: Header Checksum Error")
    pos += 1  # header checksum

    blocks = []
    saw_end = False
    while pos + 4 <= n:
        word = read_u32le(buf, pos)
        pos += 4
        if word == 0:
            saw_end = True
            break
        size = word & BLOCK_SIZE_MASK
        if size > header["block_max"]:
            raise ValueError("LZ4: Malformed Input")
        need = size + (4 if header["block_checksums"] else 0)
        if pos + need > n:
            raise ValueError("LZ4: Malformed Input")
        blocks.append((pos, size, bool(word & UNCOMPRESSED_FLAG)))
        pos += need
    if not saw_end:
        raise ValueError("LZ4: Malformed Input")
    return header, blocks, pos


def _require_engine(engine: str, engines: tuple, what: str) -> None:
    if engine not in engines:
        raise ValueError(
            f"{what} has no engine={engine!r}; "
            f"{', '.join(repr(e) for e in engines)} are the engines")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _queue_compress(raw, config: FrameConfig, window, dict_id, device
                    ) -> tuple[list, Callable]:
    """Queue one frame's split-engine chain builds on *device*. Returns
    (device tensors still queued, finish) where finish(the tensors,
    fetched) returns the frame."""
    bs = config.resolved_block_size
    n = len(raw)
    state = queue_frame_big(raw, bs, window, not config.block_independence,
                            device)

    def finish(fetched):
        comps = splice_blocks_big(state, fetched[0])
        # An empty payload makes a frame with one stored empty block at
        # 64 KB (the JAX small-block split) and with no block above it
        # (bigblock.py _finish_frame_big).
        nblocks = len(comps) if n or bs == SEG else 0
        lens = [min(bs, n - b * bs) for b in range(nblocks)]
        return _assemble_frame_host(raw, comps, lens, nblocks, bs, config,
                                    dict_id)
    return [state.chains], finish


def _encode_route(engine: str, config: FrameConfig, dictionary,
                  assemble: str) -> str:
    """The encoder the JAX ``device_compress_frame`` runs for this call
    (``device.py:137-218, 733-740``): "split" (the chain build, big blocks
    in 64 KB segments), "host" (the host frame encoder), or the row
    encoder "pallas", "hybrid" or "xla"."""
    small = config.resolved_block_size <= SPLIT_MAX_BS
    if engine == "split":
        if small:
            return "split"
        engine = "hybrid"
    if engine == "hybrid" and not small:
        if assemble == "host":
            return "split"          # compress_frame_big
        engine = "xla"              # device assembly: the XLA encoder
    if not config.block_independence:
        if config.block_checksums:
            return "host"
        return "hybrid" if engine == "hybrid" else "xla"
    if engine == "pallas" and dictionary is None:
        return "pallas"
    return "hybrid" if engine == "hybrid" else "xla"


def shard_spans(n: int, devices: list) -> list:
    """Contiguous shards of *n* rows over *devices*, as JAX shards a batch
    padded to a multiple of the device count (``sharding.py:137-143``):
    ceil(n / len(devices)) rows a device, in device order. Returns
    (device, slice) pairs; a device whose shard would hold only padding
    is left out."""
    per = max(1, -(-n // len(devices)))
    return [(dev, slice(k * per, min((k + 1) * per, n)))
            for k, dev in enumerate(devices) if k * per < n]


def _encode_row_batch(encoder: str, work, lens, bs, hist_len, hist_start,
                      use_fingerprints, device):
    """Queue one batch of rows on *device* through the greedy kernel, the
    hybrid walk or the XLA encoder. Returns (d_work, d_lens, out,
    out_lens), all on *device*."""
    d_work = put(work, device)
    d_lens = put(lens.astype(np.int64), device)
    if encoder == "pallas":
        out, out_lens = encode_blocks_pallas(d_work, d_lens, bs)
    elif encoder == "hybrid":
        out, out_lens, _ = encode_blocks_hybrid(d_work, d_lens, bs, hist_len,
                                                hist_start)
    else:
        out, out_lens = encode_blocks_batch(d_work, d_lens, hist_len,
                                            use_fingerprints, hist_start)
    return d_work, d_lens, out, out_lens


def _queue_compress_rows(raw, config: FrameConfig, window, dict_id, device,
                         encoder: str, use_fingerprints: bool,
                         assemble: str, shards: Optional[list] = None
                         ) -> tuple[list, Callable]:
    """Queue one frame's row encode on *device*: the greedy kernel
    (``engine="pallas"``, rows without history), the hybrid walk or the
    XLA encoder over ``bigblock.history_rows``' whole-block rows, then
    host assembly
    (``_host_assemble``) or, with ``assemble="device"``, ``assemble_blocks``
    as JAX does (``device.py:196-215, 778-788``: linked frames always,
    independent ones without block checksums and with a payload). With
    *shards* (a list of devices, the JAX ``encode_batch`` hook of
    ``ShardedCodec``), the rows are split by ``shard_spans`` and each shard
    is encoded on its own device; host assembly only. Returns (device
    tensors, finish) as _queue_compress does."""
    bs = config.resolved_block_size
    linked = not config.block_independence
    with span("encode.rows"):
        _, work, lens, hist_len, hist_start = history_rows(raw, bs, bs,
                                                           window, linked)
    nblocks = len(lens)
    finish = _finish_rows(raw, lens, nblocks, bs, config, dict_id)
    if shards is not None:
        tensors = []
        for dev, rows in shard_spans(nblocks, shards):
            tensors += _encode_row_batch(encoder, work[rows], lens[rows], bs,
                                         hist_len, hist_start[rows],
                                         use_fingerprints, dev)[2:]
        return tensors, finish
    d_work, d_lens, out, out_lens = _encode_row_batch(
        encoder, work, lens, bs, hist_len, hist_start, use_fingerprints,
        device)
    if assemble != "device" or not (
            linked or (not config.block_checksums and len(raw) > 0)):
        return [out, out_lens], finish
    body, total = assemble_blocks(out, out_lens, d_work[:, hist_len:],
                                  d_lens, nblocks * (4 + bs) + 4)
    header = _frame_header_bytes(config, len(raw), dict_id)

    def finish_device(fetched):
        parts = [header, fetched[0]]
        if config.content_checksum:
            ck = np.empty(4, np.uint8)
            with span("frame.xxh32"):
                write_u32le(ck, 0, xxhash32(raw, 0))
            parts.append(ck)
        return np.concatenate(parts)
    return [body[: int(total)]], finish_device


def _finish_rows(raw, lens, nblocks, bs, config, dict_id) -> Callable:
    """The finish of a frame whose blocks a kernel encoded into rows: the
    fetched (rows, lengths) pairs, one pair per shard in row order,
    assembled as the JAX ``_host_assemble`` does, where an empty payload
    makes a frame with no block."""
    def finish(fetched):
        nb = nblocks if len(raw) else 0
        comps = [outs[b, : int(ols[b])]
                 for outs, ols in zip(fetched[0::2], fetched[1::2])
                 for b in range(len(ols))][:nb]
        return _assemble_frame_host(raw, comps, lens, nb, bs, config,
                                    dict_id)
    return finish


_NP_DTYPES = {torch.uint8: np.uint8, torch.uint16: np.uint16,
              torch.int32: np.int32, torch.int64: np.int64}


def _fetch_all(tensors: list) -> list:
    """Copy device tensors of any dtypes and shapes to the host with ONE
    device-to-host transfer per device (each viewed as bytes, padded to
    8-byte alignment and joined, then cut and viewed back); returns numpy
    arrays in input order. The span ``frame.fetch`` holds the copies and
    the wait for the work queued before them; ``d2h_bytes`` counts the
    joined bytes, padding included."""
    by_dev = {}
    for i, x in enumerate(tensors):
        by_dev.setdefault(x.device, []).append(i)
    got = [None] * len(tensors)
    with span("frame.fetch"):
        for idx in by_dev.values():
            parts, spans = [], []
            pos = 0
            for i in idx:
                b = tensors[i].contiguous().reshape(-1).view(torch.uint8)
                pad = -b.numel() % 8
                parts.append(b)
                if pad:
                    parts.append(torch.zeros(pad, dtype=torch.uint8,
                                             device=b.device))
                spans.append(pos)
                pos += b.numel() + pad
            count("d2h_bytes", pos)
            flat = torch.cat(parts).cpu().numpy()
            for i, at in zip(idx, spans):
                x = tensors[i]
                got[i] = flat[at: at + x.numel() * x.element_size()] \
                    .view(_NP_DTYPES[x.dtype]).reshape(tuple(x.shape))
    return got


def compress_frames(datas, config: FrameConfig = DEFAULT_CONFIG,
                    dictionary=None, engine: str = "split", *,
                    use_fingerprints: Optional[bool] = None,
                    assemble: str = "host", device="cuda") -> list:
    """Encode N payloads into N frames with every frame's device work in
    flight before one fetch per batch. Frames are byte-identical to the
    JAX package's ``device_compress_frame`` with the same *engine*,
    *use_fingerprints* and *assemble*, routed as it routes them:

    - "split" (the port's default; JAX's single-frame default is "xla"):
      every configuration through the chain build and the host serializer.
    - "pallas": independent frames without a dictionary through the
      reference encoder's greedy scan (byte-identical to
      ``divortio_lz4_tpu.compress``); linked frames and dictionaries go to
      the XLA encoder, as in JAX.
    - "hybrid": blocks up to 64 KB through the hybrid walk, bigger ones
      through the split engine's big-block route.
    - "xla": the sort-based data-parallel encoder (``ops/encode_xla``,
      torch ops on the device); *use_fingerprints* (default
      ``config.favor_ratio``) lets its matches grow past 16 bytes.

    Linked frames with block checksums go to the host frame encoder
    (``frame.compress_frame``) on every engine but "split" with blocks up
    to 64 KB. ``assemble="device"`` builds the block section on the
    device (``ops/assemble_xla``) on the row encoders, and sends
    "split"/"hybrid" frames of bigger blocks to the XLA encoder, as JAX
    does. *device* is "cuda" unless the caller asks for the CPU."""
    with span("compress_frames"):
        dev = resolve_device(device)
        _require_engine(engine, ENCODE_ENGINES, "encode")
        if assemble not in ("host", "device"):
            raise ValueError(f"assemble={assemble!r}: 'host' or 'device'")
        if use_fingerprints is None:
            use_fingerprints = config.favor_ratio
        route = _encode_route(engine, config, dictionary, assemble)
        window, dict_id = _dict_window(dictionary)
        queued = []
        for d in datas:
            raw = ensure_buffer(d)
            if route == "split":
                queued.append(_queue_compress(raw, config, window, dict_id,
                                              dev))
            elif route == "host":
                queued.append(([], lambda f, raw=raw: compress_frame_host(
                    raw, dictionary, config)))
            else:
                queued.append(_queue_compress_rows(
                    raw, config, window, dict_id, dev, route,
                    use_fingerprints, assemble))
        fetched = iter(_fetch_all([t for tensors, _ in queued
                                   for t in tensors]))
        return [finish([next(fetched) for _ in tensors])
                for tensors, finish in queued]


def compress_frame(data, config: FrameConfig = DEFAULT_CONFIG,
                   dictionary=None, engine: str = "split", *,
                   use_fingerprints: Optional[bool] = None,
                   assemble: str = "host", device="cuda") -> np.ndarray:
    """Compress *data* into one LZ4 frame on *device* (see
    compress_frames)."""
    return compress_frames([data], config, dictionary, engine,
                           use_fingerprints=use_fingerprints,
                           assemble=assemble, device=device)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class _DecodeState(NamedTuple):
    header: dict
    buf: np.ndarray
    tail: int
    tensors: list           # device tensors still queued (none: no blocks)
    join: Callable          # the tensors, fetched -> plaintext


def _decode_independent_split(buf, blocks, bs, window, device):
    """Stage every block's records on the host (one native pass) and
    queue the compact decode kernel. Returns (device tensors, join)."""
    staged = stage_compact_batch(buf, blocks, bs, window)
    out_lens = staged[3]
    batch = CompactBatch.upload(*staged, device)
    with span("decode.kernel"):
        out = decode_blocks_compact(batch.wire, batch.rec_words,
                                    batch.rec_off, batch.out_lens, bs,
                                    batch.hist)
    return [out], lambda f: _split_decode_fetch(f[0], out_lens)


def _decode_wide_split(buf, blocks, bs, window, device):
    """Parse every block's records into padded rows on the host and queue
    the wire decode kernel. Returns (device tensors, join)."""
    entries = [(buf[off: off + size], stored) for off, size, stored in blocks]
    wire, recs, counts, out_lens, hist = parse_wire_batch(entries, bs, window)
    args = (put(wire, device), put(recs, device), put(counts, device), bs,
            None if hist is None else put(hist, device))
    with span("decode.kernel"):
        out = decode_blocks_wire(*args)
    return [out], lambda f: _split_decode_fetch(f[0], out_lens)


def _split_decode_fetch(out_np: np.ndarray, out_lens) -> np.ndarray:
    """Join the fetched rows' decoded bytes in block order."""
    if not len(out_lens):
        return np.empty(0, np.uint8)
    return np.concatenate([out_np[i, : int(n)]
                           for i, n in enumerate(out_lens)])


def _bucket_pow2(n: int, floor: int = 4096) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def _pallas_indep_fits(blocks, bs: int, window) -> bool:
    """Whether the JAX package decodes this independent frame with its
    batched token kernel (``device.py:_pallas_indep_fits`` with
    ``pallas_row_bytes``): the per-block VMEM footprint of the pow2-bucketed
    compressed width fits the budget. Otherwise it takes the scan route."""
    max_comp = max((size for _, size, stored in blocks if not stored),
                   default=1)
    M = _bucket_pow2(_round_up(max_comp + PALLAS_SLACK, 1024), 1024)
    hist = WINDOW_SIZE if window is not None else 0
    row = (_round_up(hist + bs + PALLAS_SLACK, 1024) + M + hist) * 4
    return row <= PALLAS_VMEM_BUDGET


def _seed_window(window, device) -> Optional[torch.Tensor]:
    """The dictionary right-aligned in a 64 KB window, or None."""
    if window is None:
        return None
    seed = np.zeros(WINDOW_SIZE, np.uint8)
    seed[WINDOW_SIZE - len(window):] = window
    return put(seed, device)


def stage_token_blocks(buf, blocks, window, device):
    """The inputs of decode_blocks_pallas for an independent frame's
    blocks, on *device*: (comp u8[nb, M], lens i64[nb], hist u8[W] or
    None). Stored blocks get length 0: they are not decoded, their wire
    bytes being the plaintext."""
    nb = len(blocks)
    max_comp = max((size for _, size, stored in blocks if not stored),
                   default=1)
    # >= 256 zero bytes past every row, as the TPU rows carry
    comp = np.zeros((nb, _round_up(max_comp + PALLAS_SLACK, 128)), np.uint8)
    lens = np.zeros(nb, np.int64)
    for i, (off, size, stored) in enumerate(blocks):
        if not stored:
            comp[i, :size] = buf[off: off + size]
            lens[i] = size
    return put(comp, device), put(lens, device), \
        _seed_window(window, device)


def _decode_independent_pallas(buf, blocks, bs, window, device):
    """Queue the token decode of every block of an independent frame (the
    JAX ``_decode_independent_pallas``). Returns (device tensors, join)."""
    comp, lens, hist = stage_token_blocks(buf, blocks, window, device)
    out, out_lens = decode_blocks_pallas(comp, lens, bs, hist)

    def join(fetched):
        rows, ols = fetched
        return np.concatenate([
            buf[off: off + size] if stored else rows[i, : int(ols[i])]
            for i, (off, size, stored) in enumerate(blocks)])
    return [out, out_lens], join


def stage_token_chains(buf, blocks, header, window, device, scan: bool):
    """The chains of a frame for decode_token_chains: one chain per block
    of an independent frame, one chain for a linked frame, each starting
    from the dictionary window (or zeros). Returns (TokenChains on
    *device*, row_off and out_off as numpy).

    With *scan*, every block is first scanned on the host pool, as the JAX
    ``bigblock._plan_pieces`` does, in block order: a broken stream raises
    the scanner's "LZ4: ..." error and a block that decodes past the
    frame's block size "LZ4: Output Buffer Too Small"; each chain's output
    is then sized exactly, and each compressed block becomes one row per
    scanned piece (cut at sequence boundaries, >= 64 KB of output each),
    so the kernel parses a 4 MB block as ~64 rows at once. On a scanned
    block no clamp binds, so its pieces decode to the block's bytes.
    Without (linked frames of blocks up to 256 KB, the JAX
    ``_decode_linked_pallas``), nothing is checked, a block is one row and
    the chain has room for every block at full size. The TPU's per-piece
    VMEM budgets are not ported, so giant-RLE blocks, for which JAX falls
    back to its XLA decoder, decode here too."""
    bs = header["block_max"]
    nb = len(blocks)
    if scan:
        scanned = list(host_pool().map(lambda b: block_pieces(buf, *b, bs),
                                       blocks))
        caps = np.array([total for total, _ in scanned], np.int64)
        pieces = [wl for _, wl in scanned]
    else:
        caps = np.full(nb, bs, np.int64)
        pieces = [np.array([size], np.int64) for _, size, _ in blocks]
    comp = np.concatenate([buf[off: off + size] for off, size, _ in blocks])
    comp_off = np.concatenate([[0], np.cumsum(np.concatenate(pieces))]) \
        .astype(np.int64)
    per_block = np.array([len(p) for p in pieces], np.int64)
    stored = np.repeat(np.array([st for _, _, st in blocks], np.uint8),
                       per_block)
    chain_blocks = np.arange(nb + 1) if header["independent"] \
        else np.array([0, nb])
    starts = np.concatenate([[0], np.cumsum(per_block)])[chain_blocks]
    out_off = np.concatenate([[0], np.cumsum(caps)])[chain_blocks] \
        .astype(np.int64)
    batch = TokenChains(put(comp, device), put(comp_off, device),
                        put(stored, device),
                        put(starts.astype(np.int64), device),
                        put(out_off, device), _seed_window(window, device),
                        bs, int(out_off[-1]))
    return batch, starts, out_off


def _decode_chains_pallas(buf, blocks, header, window, device, scan: bool):
    """Queue the linked token decode of a frame (stage_token_chains).
    Returns (device tensors, join)."""
    batch, starts, out_off = stage_token_chains(buf, blocks, header, window,
                                                device, scan)
    out, out_lens = decode_token_chains(batch)

    def join(fetched):
        flat, ols = fetched
        done = np.concatenate([[0], np.cumsum(ols)])[starts]
        return np.concatenate([flat[out_off[c]: out_off[c] + done[c + 1]
                                    - done[c]]
                               for c in range(len(starts) - 1)])
    return [out, out_lens], join


def stage_xla_blocks(buf, blocks, bs, device):
    """The inputs of decode_blocks_batch for an independent frame's
    blocks, on *device* (the JAX ``_decode_independent``): (comp u8[nb,
    m_cap], lens i64[nb]), m_cap the pow2 bucket of the widest compressed
    block (at most block_bound(bs)); stored blocks get length 0."""
    nb = len(blocks)
    max_comp = max((size for _, size, stored in blocks if not stored),
                   default=1)
    comp = np.zeros((nb, min(_bucket_pow2(max_comp), block_bound(bs))),
                    np.uint8)
    lens = np.zeros(nb, np.int64)
    for i, (off, size, stored) in enumerate(blocks):
        if not stored:
            comp[i, :size] = buf[off: off + size]
            lens[i] = size
    return put(comp, device), put(lens, device)


def _decode_independent_xla(buf, blocks, bs, window, device):
    """Queue the XLA decode of an independent frame (the JAX
    ``_decode_independent``, rows from stage_xla_blocks); without stored
    blocks the rows are joined on the device (``concat_blocks``). Returns
    (device tensors, join)."""
    nb = len(blocks)
    comp, lens = stage_xla_blocks(buf, blocks, bs, device)
    hist = _seed_window(window, device)
    if hist is None:
        hist = torch.zeros(WINDOW_SIZE, dtype=torch.uint8, device=device)
    out, out_lens = decode_blocks_batch(comp, lens, hist, bs)
    if not any(stored for _, _, stored in blocks):
        flat, total = concat_blocks(out, out_lens, nb * bs)
        return [flat[: int(total)]], lambda f: f[0]

    def join(fetched):
        rows, ols = fetched
        return np.concatenate([
            buf[off: off + size] if stored else rows[i, : int(ols[i])]
            for i, (off, size, stored) in enumerate(blocks)])
    return [out, out_lens], join


def stage_xla_chain(buf, blocks, bs, device):
    """The inputs of decode_linked_scan for a linked frame (the JAX
    ``_decode_linked``): (comp u8[nb, m_cap] on *device*, lens i64[nb] on
    *device*, stored i64[nb] on the host), every block a row, stored ones
    too, m_cap the pow2 bucket of the widest block."""
    nb = len(blocks)
    max_comp = max(size for _, size, _ in blocks)
    comp = np.zeros((nb, min(_bucket_pow2(max_comp), block_bound(bs))),
                    np.uint8)
    lens = np.zeros(nb, np.int64)
    stored = np.zeros(nb, np.int64)
    for i, (off, size, st) in enumerate(blocks):
        comp[i, :size] = buf[off: off + size]
        lens[i] = size
        stored[i] = st
    return put(comp, device), put(lens, device), torch.from_numpy(stored)


def _decode_linked_xla(buf, blocks, bs, window, device):
    """Queue the XLA decode of a linked frame (the JAX ``_decode_linked``):
    the rows of stage_xla_chain decoded in order by ``decode_linked_scan``
    against the carried window, then joined on the device. Returns (device
    tensors, join)."""
    init = _seed_window(window, device)
    if init is None:
        init = torch.zeros(WINDOW_SIZE, dtype=torch.uint8, device=device)
    outs, out_lens = decode_linked_scan(
        *stage_xla_chain(buf, blocks, bs, device), init, bs)
    flat, total = concat_blocks(outs, out_lens, len(blocks) * bs)
    return [flat[: int(total)]], lambda f: f[0]


def _sharded_route(route, buf, blocks, bs, window, shards):
    """Run an independent-frame decode *route* on each shard of *blocks*
    (``shard_spans``) on its own device and join the shards' plaintexts
    in block order (the JAX ``_merge_sharded_pend``). Returns (device
    tensors, join)."""
    tensors, joins = [], []
    for dev, rows in shard_spans(len(blocks), shards):
        t, j = route(buf, blocks[rows], bs, window, dev)
        tensors += t
        joins.append((j, len(t)))

    def join(fetched):
        parts, at = [], 0
        for j, k in joins:
            parts.append(j(fetched[at: at + k]))
            at += k
        return np.concatenate(parts)
    return tensors, join


def _stage_frame(buf, verify_checksum, window, dict_id, device,
                 engine, shards: Optional[list] = None) -> _DecodeState:
    """Header, dictionary and block-checksum checks, then queue the decode
    (device_decompress_frame's order of checks). With *shards* (a list of
    devices, the JAX ``decode_batch`` / ``split_sharded`` hooks of
    ``ShardedCodec``), an independent frame on the xla engine, or on the
    split engine with blocks up to 256 KB, decodes each shard of its
    blocks on its own device; every other frame decodes on *device*."""
    with span("frame.index"):
        header, blocks, tail = parse_block_index(buf, verify_checksum)
        count("decode_blocks", len(blocks))
        bs = header["block_max"]
        if header["dict_id"] is not None:
            if window is None:
                raise ValueError("LZ4: Frame requires a Dictionary")
            if dict_id != header["dict_id"]:
                raise ValueError("LZ4: Dictionary ID Mismatch")
        if verify_checksum and header["block_checksums"]:
            with span("frame.xxh32"):
                for off, size, _ in blocks:
                    stored = read_u32le(buf, off + size)
                    if stored != xxhash32(buf[off: off + size], 0):
                        raise ValueError("LZ4: Block Checksum Error")
    # Independent-frame routes: each decodes a shard of blocks as it
    # decodes a whole frame.
    route = None
    if header["independent"] and engine in ("xla", "hybrid"):
        route = _decode_independent_xla
    elif header["independent"] and engine == "split" and bs <= SPLIT_MAX_BS:
        route = _decode_independent_split
    elif header["independent"] and engine == "split" and bs <= WIRE_MAX_BS:
        route = _decode_wide_split
    if not blocks:
        tensors, join = [], lambda f: np.empty(0, dtype=np.uint8)
    elif route is not None and shards is not None:
        tensors, join = _sharded_route(route, buf, blocks, bs, window,
                                       shards)
    elif route is not None:
        tensors, join = route(buf, blocks, bs, window, device)
    elif engine in ("xla", "hybrid"):
        tensors, join = _decode_linked_xla(buf, blocks, bs, window, device)
    elif engine == "pallas" and header["independent"]:
        if _pallas_indep_fits(blocks, bs, window):
            tensors, join = _decode_independent_pallas(buf, blocks, bs,
                                                       window, device)
        else:
            tensors, join = _decode_chains_pallas(buf, blocks, header,
                                                  window, device, scan=True)
    elif engine == "pallas":
        tensors, join = _decode_chains_pallas(
            buf, blocks, header, window, device,
            scan=bs > PALLAS_LINKED_MAX_BS)
    else:
        batch = stage_chains(buf, blocks, header, window, device)
        with span("decode.kernel"):
            tensors = [decode_chains(batch)]
        join = lambda f: f[0]   # noqa: E731  (the chains tile the frame)
    return _DecodeState(header, buf, tail, tensors, join)


def _finish_frame(state: _DecodeState, fetched, verify_checksum
                  ) -> np.ndarray:
    with span("frame.join"):
        result = state.join(fetched)
    if state.header["content_checksum"] and verify_checksum:
        if state.tail + 4 > len(state.buf):
            raise ValueError("LZ4: Malformed Input")
        with span("frame.xxh32"):
            ok = read_u32le(state.buf, state.tail) == xxhash32(result, 0)
        if not ok:
            raise ValueError("LZ4: Content Checksum Error")
    return result


def decompress_frames(frames, verify_checksum: bool = True,
                      dictionary=None, engine: str = "split", *,
                      device="cuda") -> list:
    """Decode N frames with every frame's kernel queued before one fetch
    per batch. The bytes, or the "LZ4: ..." error, are the JAX package's
    ``device_decompress_frame`` with the same *engine*: "split" (the
    port's default; JAX's is "xla"), "pallas", or "xla" and "hybrid",
    which both take the XLA decoder (``ops/decode_xla``, torch ops on the
    device; ``ops/linked_xla`` for linked frames), as JAX's fall-through
    does. The XLA decoder does not diagnose a broken block: it gives JAX's
    clipped bytes, and only a checksum catches them. A frame with a dictID
    requires *dictionary* and verifies its id. *device* is "cuda" unless
    the caller asks for the CPU."""
    with span("decompress_frames"):
        dev = resolve_device(device)
        _require_engine(engine, DECODE_ENGINES, "decode")
        window, dict_id = _dict_window(dictionary)
        states = [_stage_frame(ensure_buffer(f), verify_checksum, window,
                               dict_id, dev, engine) for f in frames]
        fetched = iter(_fetch_all([t for s in states for t in s.tensors]))
        return [_finish_frame(s, [next(fetched) for _ in s.tensors],
                              verify_checksum) for s in states]


def decompress_frame(data, verify_checksum: bool = True, dictionary=None,
                     engine: str = "split", *,
                     device="cuda") -> np.ndarray:
    """Decompress one LZ4 frame on *device* (see decompress_frames)."""
    return decompress_frames([data], verify_checksum, dictionary, engine,
                             device=device)[0]


# ---------------------------------------------------------------------------
# The JAX package's names
# ---------------------------------------------------------------------------

def _no_hook(name: str, hook) -> None:
    if hook is not None:
        raise ValueError(f"{name}: the JAX package's callable hook has no "
                         "port; shard a frame with parallel.ShardedCodec")


def device_compress_frame(data, config: FrameConfig = DEFAULT_CONFIG,
                          use_fingerprints: Optional[bool] = None,
                          encode_batch=None, dictionary=None,
                          engine: str = "xla", assemble: str = "host", *,
                          device="cuda") -> np.ndarray:
    """The JAX package's ``device_compress_frame``: its parameter order and
    defaults (``engine="xla"``), then compress_frame on *device*.
    *encode_batch* must be None."""
    _no_hook("encode_batch", encode_batch)
    return compress_frame(data, config, dictionary, engine,
                          use_fingerprints=use_fingerprints,
                          assemble=assemble, device=device)


def device_decompress_frame(data, verify_checksum: bool = True,
                            decode_batch=None, engine: str = "xla",
                            dictionary=None, split_sharded=None, *,
                            device="cuda") -> np.ndarray:
    """The JAX package's ``device_decompress_frame``: its parameter order
    and defaults (``engine="xla"``), then decompress_frame on *device*.
    *decode_batch* and *split_sharded* must be None."""
    _no_hook("decode_batch", decode_batch)
    _no_hook("split_sharded", split_sharded)
    return decompress_frame(data, verify_checksum, dictionary, engine,
                            device=device)


def device_compress_frames(datas, config: FrameConfig = DEFAULT_CONFIG,
                           dictionary=None, engine: str = "split", *,
                           device="cuda") -> list:
    """The JAX package's ``device_compress_frames`` (default
    ``engine="split"``): compress_frames on *device*."""
    return compress_frames(datas, config, dictionary, engine, device=device)


def device_decompress_frames(frames, verify_checksum: bool = True,
                             dictionary=None, engine: str = "split", *,
                             device="cuda") -> list:
    """The JAX package's ``device_decompress_frames`` (default
    ``engine="split"``): decompress_frames on *device*."""
    return decompress_frames(frames, verify_checksum, dictionary, engine,
                             device=device)
