"""The host frame codec: ``compress_frame`` and ``decompress_frame``.

A copy of ``divortio_lz4_tpu/frame.py`` over the port's own host layer
(``backends``, ``host.py`` over ``csrc/host_kernels.cpp``): the LZ4 Frame
Format v1.6.1 wire contract (magic, FLG/BD descriptor, optional content
size and dictID, header checksum, size words with the stored-block flag,
EndMark, optional content checksum), the same bytes and the same
"LZ4: ..." errors. The "native" backend (the default) runs a frame's
block loop in one call (``compress_frame_body``, ``decompress_frame_body``;
independent frames on threads); the "python" backend, or an output buffer
below the body's bound, takes the per-block loop.

These are the package's host codec, ``divortio_lz4_tpu_torch.compress`` /
``decompress``. The device codec is ``parallel/device.py``'s
``compress_frame`` / ``decompress_frame``, exported at the top level under
those names; its linked frames with block checksums come here, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .backends import get_backend
from .config import DEFAULT_CONFIG, FrameConfig
from .constants import (
    BLOCK_MAX_SIZES,
    BLOCK_SIZE_MASK,
    FLG_BLOCK_CHECKSUM,
    FLG_BLOCK_INDEPENDENCE,
    FLG_CONTENT_CHECKSUM,
    FLG_CONTENT_SIZE,
    FLG_DICT_ID,
    FLG_VERSION_MASK,
    LZ4_VERSION,
    MAGIC_NUMBER,
    SKIPPABLE_MAGIC_MAX,
    SKIPPABLE_MAGIC_MIN,
    UNCOMPRESSED_FLAG,
    WINDOW_SIZE,
)
from .ops.block_ref import new_hash_table
from .utils import ensure_buffer, read_u32le, write_u32le
from .xxh import xxhash32


def compress_frame(data,
                   dictionary=None,
                   config: FrameConfig = DEFAULT_CONFIG,
                   output_buffer: Optional[np.ndarray] = None,
                   backend: Optional[str] = None) -> np.ndarray:
    """Compress *data* into one LZ4 frame on the host.

    A non-empty *dictionary* warms the hash table with its last 64 KB and
    stamps its xxh32 as the frame's dictID. Returns the frame as uint8 (a
    view of *output_buffer* when one is given).
    """
    be = get_backend(backend)
    raw = ensure_buffer(data)
    n = len(raw)

    dict_len = 0
    dict_id = None
    window = raw[:0]
    if dictionary is not None:
        dict_buf = ensure_buffer(dictionary)
        if len(dict_buf) > 0:
            dict_id = xxhash32(dict_buf, 0)
            window = dict_buf[-WINDOW_SIZE:]
            dict_len = len(window)
    # [dictionary window | payload | 16 readable bytes for the native
    # loop's 16-byte literal copies]
    working = np.zeros(dict_len + n + 16, np.uint8)
    working[:dict_len] = window
    working[dict_len: dict_len + n] = raw
    input_start = dict_len

    block_size = config.resolved_block_size

    if output_buffer is not None:
        out = output_buffer
    else:
        nblocks = max(1, -(-n // block_size))
        # Worst-case frame bound + 24 bytes of native wild-copy slack.
        out = np.empty(19 + nblocks * 9 + n + (n // 255) + 16 * nblocks + 32,
                       dtype=np.uint8)

    out[0], out[1], out[2], out[3] = 0x04, 0x22, 0x4D, 0x18
    pos = 4
    flg = LZ4_VERSION << 6
    if config.block_independence:
        flg |= FLG_BLOCK_INDEPENDENCE
    if config.content_checksum:
        flg |= FLG_CONTENT_CHECKSUM
    if config.block_checksums:
        flg |= FLG_BLOCK_CHECKSUM
    if dict_id is not None:
        flg |= FLG_DICT_ID
    if config.content_size:
        flg |= FLG_CONTENT_SIZE
    out[pos] = flg
    pos += 1
    out[pos] = (config.block_id & 0x07) << 4
    pos += 1
    header_start = 4
    if config.content_size:
        write_u32le(out, pos, n & 0xFFFFFFFF)
        write_u32le(out, pos + 4, n >> 32)
        pos += 8
    if dict_id is not None:
        write_u32le(out, pos, dict_id)
        pos += 4
    out[pos] = (xxhash32(out[header_start:pos], 0) >> 8) & 0xFF
    pos += 1

    table = new_hash_table()
    if dict_len > 0:
        be.warm_table(table, working, dict_len)

    src_pos = input_start
    total_end = input_start + n
    nblocks = max(1, -(-n // block_size))
    body_bound = nblocks * 8 + n + (n // 255) + 16 * nblocks + 4 + 24
    if (be.compress_frame_body is not None
            and len(out) - pos >= body_bound):
        # One native call: size words, stored fallback, block checksums,
        # EndMark.
        pos += be.compress_frame_body(
            working, src_pos, total_end, out, pos, block_size, table,
            config.block_independence, config.block_checksums)
    else:
        while src_pos < total_end:
            end = min(src_pos + block_size, total_end)
            bsize = end - src_pos
            size_pos = pos
            pos += 4
            comp = be.compress_block(working, out, src_pos, bsize, table, pos)
            if 0 < comp < bsize:
                write_u32le(out, size_pos, comp)
                pos += comp
            else:
                # Stored-block fallback.
                write_u32le(out, size_pos, bsize | UNCOMPRESSED_FLAG)
                out[pos: pos + bsize] = working[src_pos:end]
                pos += bsize
            if config.block_checksums:
                data_start = size_pos + 4
                write_u32le(out, pos, xxhash32(out[data_start:pos], 0))
                pos += 4
            if config.block_independence:
                table[:] = 0
            src_pos = end
        write_u32le(out, pos, 0)  # EndMark
        pos += 4

    if config.content_checksum:
        write_u32le(out, pos, xxhash32(raw, 0))
        pos += 4
    return out[:pos]


def decompress_frame(data,
                     dictionary=None,
                     verify_checksum: bool = True,
                     backend: Optional[str] = None) -> np.ndarray:
    """Decompress one LZ4 frame on the host; returns the plaintext as uint8.

    Leading skippable frames are skipped. A frame with a content size is
    written straight into one exact allocation; one without takes the
    per-block loop with a rolling 64 KB window. Header, block and content
    checksums are verified when *verify_checksum* is set.
    """
    be = get_backend(backend)
    buf = ensure_buffer(data)
    n = len(buf)
    dict_buf = ensure_buffer(dictionary) if dictionary is not None else None

    pos = 0
    while (pos + 8 <= n
           and SKIPPABLE_MAGIC_MIN <= read_u32le(buf, pos)
           <= SKIPPABLE_MAGIC_MAX):
        pos += 8 + read_u32le(buf, pos + 4)
    if pos + 4 > n or read_u32le(buf, pos) != MAGIC_NUMBER:
        raise ValueError("LZ4: Invalid Magic Number")
    pos += 4
    desc_start = pos
    flg = int(buf[pos]); pos += 1
    version = (flg & FLG_VERSION_MASK) >> 6
    if version != LZ4_VERSION:
        raise ValueError(f"LZ4: Unsupported Version {version}")
    independent = bool(flg & FLG_BLOCK_INDEPENDENCE)
    has_block_checksum = bool(flg & FLG_BLOCK_CHECKSUM)
    has_content_size = bool(flg & FLG_CONTENT_SIZE)
    has_content_checksum = bool(flg & FLG_CONTENT_CHECKSUM)
    has_dict_id = bool(flg & FLG_DICT_ID)
    # BD byte: the block maximum, read for the threaded decode only.
    block_max = BLOCK_MAX_SIZES.get((int(buf[pos]) >> 4) & 0x07,
                                    BLOCK_MAX_SIZES[7])
    pos += 1

    expected_size = 0
    if has_content_size:
        if pos + 8 > n:
            raise ValueError("LZ4: Malformed Input")
        expected_size = read_u32le(buf, pos) | (read_u32le(buf, pos + 4) << 32)
        pos += 8
    if has_dict_id:
        if pos + 4 > n:
            raise ValueError("LZ4: Malformed Input")
        frame_dict_id = read_u32le(buf, pos)
        pos += 4
        if dict_buf is None:
            raise ValueError("LZ4: Frame requires a Dictionary")
        if xxhash32(dict_buf, 0) != frame_dict_id:
            raise ValueError("LZ4: Dictionary ID Mismatch")
    if pos >= n:
        raise ValueError("LZ4: Malformed Input")
    if verify_checksum:
        expect_hc = (xxhash32(buf[desc_start:pos], 0) >> 8) & 0xFF
        if int(buf[pos]) != expect_hc:
            raise ValueError("LZ4: Header Checksum Error")
    pos += 1

    # A corrupted content size must not drive a giant allocation: LZ4
    # expands at most ~255x per wire byte.
    max_plausible = (n - pos) * 256 + WINDOW_SIZE
    if expected_size > max_plausible:
        raise ValueError("LZ4: Malformed Input")

    use_direct = expected_size > 0
    if use_direct and be.decompress_frame_body is not None:
        result = np.empty(expected_size, dtype=np.uint8)
        result_pos, pos = be.decompress_frame_body(
            buf, pos, n, result, dict_buf, independent,
            has_block_checksum, verify_checksum, block_max)
        result = result[:result_pos]
        if has_content_checksum and verify_checksum:
            if pos + 4 > n:
                raise ValueError("LZ4: Malformed Input")
            stored_hash = read_u32le(buf, pos)
            if stored_hash != xxhash32(result, 0):
                raise ValueError("LZ4: Content Checksum Error")
        return result
    if use_direct:
        result = np.empty(expected_size, dtype=np.uint8)
        result_pos = 0
    else:
        chunks = []
        window = np.zeros(WINDOW_SIZE, dtype=np.uint8)
        window_pos = 0
        if dict_buf is not None:
            d = len(dict_buf)
            take = min(d, WINDOW_SIZE)
            window[:take] = dict_buf[d - take:]
            window_pos = take
        workspace = np.empty(BLOCK_MAX_SIZES[7], dtype=np.uint8)

    while pos < n:
        word = read_u32le(buf, pos)
        pos += 4
        if word == 0:
            break  # EndMark
        stored = bool(word & UNCOMPRESSED_FLAG)
        bsize = word & BLOCK_SIZE_MASK
        if pos + bsize > n:
            raise ValueError("LZ4: Malformed Input")

        # The block checksum is verified before the block is read; a frame
        # cut at a block checksum is malformed, never silently unverified.
        if has_block_checksum:
            if pos + bsize + 4 > n:
                raise ValueError("LZ4: Malformed Input")
            if verify_checksum:
                stored_bc = read_u32le(buf, pos + bsize)
                if stored_bc != xxhash32(buf[pos: pos + bsize], 0):
                    raise ValueError("LZ4: Block Checksum Error")

        if use_direct:
            if stored:
                result[result_pos: result_pos + bsize] = buf[pos: pos + bsize]
                result_pos += bsize
            elif independent:
                # An independent block references the dictionary only.
                result_pos += be.decompress_block(
                    buf, pos, bsize, result[result_pos:], 0, dict_buf)
            else:
                result_pos += be.decompress_block(
                    buf, pos, bsize, result, result_pos, dict_buf)
        else:
            if stored:
                chunk = np.array(buf[pos: pos + bsize])
            else:
                if independent:
                    hist = dict_buf
                else:
                    hist = window[:window_pos] if window_pos > 0 else None
                nbytes = be.decompress_block(buf, pos, bsize, workspace, 0,
                                             hist)
                chunk = np.array(workspace[:nbytes])
            chunks.append(chunk)
            # Rolling 64 KB window (read by linked frames only).
            cl = len(chunk)
            if cl >= WINDOW_SIZE:
                window[:] = chunk[cl - WINDOW_SIZE:]
                window_pos = WINDOW_SIZE
            elif window_pos + cl <= WINDOW_SIZE:
                window[window_pos: window_pos + cl] = chunk
                window_pos += cl
            else:
                keep = WINDOW_SIZE - cl
                window[:keep] = window[window_pos - keep: window_pos]
                window[keep:] = chunk
                window_pos = WINDOW_SIZE

        pos += bsize
        if has_block_checksum:
            pos += 4

    if use_direct:
        result = result[:result_pos]
    else:
        if len(chunks) == 1:
            result = chunks[0]
        elif chunks:
            result = np.concatenate(chunks)
        else:
            result = np.empty(0, dtype=np.uint8)

    if has_content_checksum and verify_checksum:
        if pos + 4 > n:
            raise ValueError("LZ4: Malformed Input")
        stored_hash = read_u32le(buf, pos)
        if stored_hash != xxhash32(result, 0):
            raise ValueError("LZ4: Content Checksum Error")

    return result
