"""Frame codec on a torch device: the split engine on independent frames.

Port of the ``engine="split"`` path of ``divortio_lz4_tpu/parallel/
device.py`` for frames of independent blocks of up to 64 KB.

- Encode: ``_compress_independent_split`` queues the chain builder on the
  device (``ops/split_encode.encode_blocks_chain``); ``_split_encode_fetch``
  fetches the chains, serializes every block on the host pool with the
  native serializer, and ``_assemble_frame_host`` builds the frame.
- Decode: ``_decode_independent_split`` parses every block's records on
  the host (``ops/split_decode``) and queues the compact decode kernel
  (``ops/compact_decode``); ``_split_decode_fetch`` joins the blocks.

``compress_frames`` / ``decompress_frames`` queue every frame's device
work first, fetch all of it with one device-to-host copy, then finish each
frame on the host. The single-frame entry points are the one-frame case.

The frame host helpers below are copies of the JAX module's (it imports
jax at module level); their semantics and "LZ4: ..." errors are unchanged.
Linked frames, blocks over 64 KB and other engines are not ported yet and
raise NotImplementedError; nothing falls back to another codec.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from divortio_lz4_tpu.config import DEFAULT_CONFIG, FrameConfig
from divortio_lz4_tpu.constants import (
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
from divortio_lz4_tpu.utils import ensure_buffer, read_u32le, write_u32le
from divortio_lz4_tpu.utils.pool import host_pool
from divortio_lz4_tpu.xxh import xxhash32

from .._device import resolve_device
from ..ops.compact_decode import decode_blocks_compact
from ..ops.split_decode import from_reference_records, parse_wire_raw
from ..ops.split_encode import chain_select_serialize, encode_blocks_chain

# Largest block the port's split engine takes (u16 record and chain fields).
SPLIT_MAX_BS = 65536


def _blocks_to_batch(raw: np.ndarray, block_size: int):
    n = len(raw)
    nblocks = max(1, -(-n // block_size))
    work = np.zeros((nblocks, block_size), dtype=np.uint8)
    lens = np.zeros(nblocks, dtype=np.int32)
    for i in range(nblocks):
        chunk = raw[i * block_size: (i + 1) * block_size]
        work[i, : len(chunk)] = chunk
        lens[i] = len(chunk)
    return work, lens, nblocks


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
    n = len(raw)
    frame = np.empty(19 + n + (n // 255) + 16 * max(nblocks, 1) + 8,
                     np.uint8)
    header = _frame_header_bytes(config, n, dict_id)
    frame[: len(header)] = header
    pos = len(header)
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
            write_u32le(frame, pos, xxhash32(frame[data_start:pos], 0))
            pos += 4
    write_u32le(frame, pos, 0)
    pos += 4
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


def _require_split(engine: str) -> None:
    if engine != "split":
        raise NotImplementedError(
            f"engine={engine!r} is not ported; only engine='split' is "
            "(ROADMAP.md queue 1 item 9: other engines)")


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

class _EncodeState(NamedTuple):
    raw: np.ndarray
    work: np.ndarray        # u8[nb, hist_len + bs]
    lens: np.ndarray        # i32[nb]
    nblocks: int
    bs: int
    hist_len: int
    config: FrameConfig
    dict_id: Optional[int]
    chains: torch.Tensor    # u16[nb, bs] on the device, still queued


def _compress_independent_split(data, config: FrameConfig, dictionary,
                                device: torch.device) -> _EncodeState:
    """Queue one frame's chain builds on *device*."""
    raw = ensure_buffer(data)
    bs = config.resolved_block_size
    work, lens, nblocks = _blocks_to_batch(raw, bs)
    window, dict_id = _dict_window(dictionary)
    if window is not None:
        # Every independent block sees the dictionary as history: rows are
        # [64 KB window (right-aligned) | payload].
        hist_len = WINDOW_SIZE
        hist_start = WINDOW_SIZE - len(window)
        hist_block = np.zeros((nblocks, WINDOW_SIZE), np.uint8)
        hist_block[:, hist_start:] = window
        work = np.concatenate([hist_block, work], axis=1)
    else:
        hist_len = 0
        hist_start = 0
    chains = encode_blocks_chain(work, lens, bs, hist_len, hist_start,
                                 device=device)
    return _EncodeState(raw, work, lens, nblocks, bs, hist_len, config,
                        dict_id, chains)


def _split_encode_fetch(state: _EncodeState,
                        chains_np: np.ndarray) -> np.ndarray:
    """Serialize every block from its fetched chain (native, on the host
    pool) and assemble the frame."""
    raw, work, lens, nblocks, bs, hist_len = state[:6]
    comps = [None] * nblocks

    if hist_len == 0:
        # One padded copy of the frame: row b's work view is
        # raw_pad[b*bs : b*bs+src_len+8]; the 8 slack bytes only need to
        # be readable (the extension clamps at its match limit).
        raw_pad = np.zeros(nblocks * bs + 8, np.uint8)
        raw_pad[: len(raw)] = np.asarray(raw, np.uint8)

        def _serialize_one(b):
            src_len = int(lens[b])
            comps[b] = chain_select_serialize(
                raw_pad[b * bs: b * bs + src_len + 8], 0, src_len,
                chains_np[b])
    else:
        def _serialize_one(b):
            src_len = int(lens[b])
            wk = np.zeros(hist_len + src_len + 8, np.uint8)
            wk[:hist_len] = work[b, :hist_len]
            wk[hist_len: hist_len + src_len] = raw[b * bs: b * bs + src_len]
            comps[b] = chain_select_serialize(wk, hist_len, src_len,
                                              chains_np[b])

    # The native serializer releases the GIL: blocks run in parallel.
    for f in [host_pool().submit(_serialize_one, b)
              for b in range(nblocks)]:
        f.result()
    return _assemble_frame_host(raw, comps, lens, nblocks, bs, state.config,
                                state.dict_id)


def _fetch_rows(tensors: list) -> list:
    """Copy device tensors of one trailing shape to the host with ONE
    device-to-host transfer; returns numpy arrays in input order."""
    if not tensors:
        return []
    flat = torch.cat(tensors).cpu().numpy() if len(tensors) > 1 \
        else tensors[0].cpu().numpy()
    out, pos = [], 0
    for x in tensors:
        out.append(flat[pos: pos + x.shape[0]])
        pos += x.shape[0]
    return out


def compress_frames(datas, config: FrameConfig = DEFAULT_CONFIG,
                    dictionary=None, engine: str = "split", *,
                    device) -> list:
    """Encode N payloads into N frames with every frame's device work in
    flight before the first fetch. Frames are byte-identical to the JAX
    package's ``device_compress_frame(engine="split")``."""
    dev = resolve_device(device)
    _require_split(engine)
    if not config.block_independence:
        raise NotImplementedError(
            "linked frames are not ported (ROADMAP.md queue 1 item 3: "
            "_compress_linked_split)")
    if config.resolved_block_size > SPLIT_MAX_BS:
        raise NotImplementedError(
            f"blocks of {config.resolved_block_size} bytes are not ported; "
            "the split engine covers 64 KB blocks (ROADMAP.md queue 1 "
            "item 6: big-block encode)")
    states = [_compress_independent_split(d, config, dictionary, dev)
              for d in datas]
    fetched = _fetch_rows([s.chains for s in states])
    return [_split_encode_fetch(s, c) for s, c in zip(states, fetched)]


def compress_frame(data, config: FrameConfig = DEFAULT_CONFIG,
                   dictionary=None, engine: str = "split", *,
                   device) -> np.ndarray:
    """Compress *data* into one LZ4 frame on *device* (see
    compress_frames)."""
    return compress_frames([data], config, dictionary, engine,
                           device=device)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class _DecodeState(NamedTuple):
    header: dict
    buf: np.ndarray
    tail: int
    out: Optional[torch.Tensor]          # u8[nb, bs] on the device, queued
    out_lens: Optional[np.ndarray]       # i64[nb]


def _decode_independent_split(buf, blocks, bs, window, device):
    """Parse every block's records on the host and queue the compact
    decode kernel. Returns (out u8[nb, bs] on *device*, out_lens)."""
    entries = [(buf[off: off + size], stored) for off, size, stored in blocks]
    wire, recs_l, _, out_lens, hist = parse_wire_raw(entries, bs, window)
    batch = from_reference_records(wire, recs_l, out_lens, hist, device)
    out = decode_blocks_compact(batch.wire, batch.rec_words, batch.rec_off,
                                batch.out_lens, bs, batch.hist)
    return out, out_lens


def _split_decode_fetch(out_np: np.ndarray, out_lens) -> np.ndarray:
    """Join the fetched rows' decoded bytes in block order."""
    if not len(out_lens):
        return np.empty(0, np.uint8)
    return np.concatenate([out_np[i, : int(n)]
                           for i, n in enumerate(out_lens)])


def _stage_frame(buf, verify_checksum, window, dict_id,
                 device) -> _DecodeState:
    """Header, dictionary and block-checksum checks, then queue the decode
    (device_decompress_frame's order of checks)."""
    header, blocks, tail = parse_block_index(buf, verify_checksum)
    bs = header["block_max"]
    if header["dict_id"] is not None:
        if window is None:
            raise ValueError("LZ4: Frame requires a Dictionary")
        if dict_id != header["dict_id"]:
            raise ValueError("LZ4: Dictionary ID Mismatch")
    if verify_checksum and header["block_checksums"]:
        for off, size, _ in blocks:
            stored = read_u32le(buf, off + size)
            if stored != xxhash32(buf[off: off + size], 0):
                raise ValueError("LZ4: Block Checksum Error")
    if not blocks:
        return _DecodeState(header, buf, tail, None, None)
    if not header["independent"]:
        raise NotImplementedError(
            "linked frames are not ported (ROADMAP.md queue 1 item 5: "
            "big-block and linked decode)")
    if bs > SPLIT_MAX_BS:
        raise NotImplementedError(
            f"frames of {bs}-byte blocks are not ported; the split engine "
            "covers 64 KB blocks (ROADMAP.md queue 1 items 5 and 7)")
    out, out_lens = _decode_independent_split(buf, blocks, bs, window,
                                              device)
    return _DecodeState(header, buf, tail, out, out_lens)


def _finish_frame(state: _DecodeState, out_np, verify_checksum
                  ) -> np.ndarray:
    if state.out is None:
        result = np.empty(0, dtype=np.uint8)
    else:
        result = _split_decode_fetch(out_np, state.out_lens)
    if state.header["content_checksum"] and verify_checksum:
        if state.tail + 4 > len(state.buf):
            raise ValueError("LZ4: Malformed Input")
        if read_u32le(state.buf, state.tail) != xxhash32(result, 0):
            raise ValueError("LZ4: Content Checksum Error")
    return result


def decompress_frames(frames, verify_checksum: bool = True,
                      dictionary=None, engine: str = "split", *,
                      device) -> list:
    """Decode N frames with every frame's kernel queued before one fetch.
    A frame with a dictID requires *dictionary* and verifies its id."""
    dev = resolve_device(device)
    _require_split(engine)
    window, dict_id = _dict_window(dictionary)
    states = [_stage_frame(ensure_buffer(f), verify_checksum, window,
                           dict_id, dev) for f in frames]
    fetched = iter(_fetch_rows([s.out for s in states if s.out is not None]))
    return [_finish_frame(s, None if s.out is None else next(fetched),
                          verify_checksum) for s in states]


def decompress_frame(data, verify_checksum: bool = True, dictionary=None,
                     engine: str = "split", *, device) -> np.ndarray:
    """Decompress one LZ4 frame on *device* (see decompress_frames)."""
    return decompress_frames([data], verify_checksum, dictionary, engine,
                             device=device)[0]
