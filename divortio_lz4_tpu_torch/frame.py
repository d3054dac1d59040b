"""The host frame encoder: the reference's greedy block parse, on the host.

A copy of ``divortio_lz4_tpu/frame.py:compress_frame`` on its default
"native" backend (``lz4t_warm_table`` and ``lz4t_compress_frame_body``,
copied into ``csrc/host_kernels.cpp``). The JAX package's device encoders
send linked frames with block checksums here
(``parallel/device.py:_compress_linked``), and so does the port's.
The Python fallback loop over ``compress_block``, which the native
backend never reaches (the output always holds the body's bound), and the
caller-supplied output buffer are not copied. Independent frames run the
serial block loop, whose bytes the JAX package's threaded variant equals.
"""

from __future__ import annotations

import numpy as np

from .config import DEFAULT_CONFIG, FrameConfig
from .constants import (FLG_BLOCK_CHECKSUM, FLG_BLOCK_INDEPENDENCE,
                        FLG_CONTENT_CHECKSUM, FLG_CONTENT_SIZE, FLG_DICT_ID,
                        HASH_MASK, LZ4_VERSION, WINDOW_SIZE)
from .host import compress_frame_body_native, warm_table_native
from .utils import ensure_buffer, write_u32le
from .xxh import xxhash32


def compress_frame(data, dictionary=None,
                   config: FrameConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Compress *data* into one LZ4 frame on the host. A non-empty
    *dictionary* warms the hash table with its last 64 KB and stamps its
    xxh32 as the frame's dictID. Returns the frame as uint8."""
    raw = ensure_buffer(data)
    n = len(raw)
    dict_len = 0
    dict_id = None
    window = np.zeros(0, np.uint8)
    if dictionary is not None:
        dict_buf = ensure_buffer(dictionary)
        if len(dict_buf) > 0:
            dict_id = xxhash32(dict_buf, 0)
            window = dict_buf[-WINDOW_SIZE:]
            dict_len = len(window)
    # [dictionary window | payload | 16 readable bytes of slack]
    working = np.zeros(dict_len + n + 16, np.uint8)
    working[:dict_len] = window
    working[dict_len: dict_len + n] = raw

    block_size = config.resolved_block_size
    nblocks = max(1, -(-n // block_size))
    out = np.empty(19 + nblocks * 9 + n + (n // 255) + 16 * nblocks + 32,
                   dtype=np.uint8)
    out[0:4] = (0x04, 0x22, 0x4D, 0x18)
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
    out[4] = flg
    out[5] = (config.block_id & 0x07) << 4
    pos = 6
    if config.content_size:
        write_u32le(out, pos, n & 0xFFFFFFFF)
        write_u32le(out, pos + 4, n >> 32)
        pos += 8
    if dict_id is not None:
        write_u32le(out, pos, dict_id)
        pos += 4
    out[pos] = (xxhash32(out[4:pos], 0) >> 8) & 0xFF
    pos += 1

    table = np.zeros(HASH_MASK + 1, np.int32)
    if dict_len > 0:
        warm_table_native(table, working, dict_len)
    pos += compress_frame_body_native(
        working, dict_len, dict_len + n, out, pos, block_size, table,
        config.block_independence, config.block_checksums)
    if config.content_checksum:
        write_u32le(out, pos, xxhash32(raw, 0))
        pos += 4
    return out[:pos]
