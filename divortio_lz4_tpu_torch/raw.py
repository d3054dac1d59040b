"""Raw block API: headerless LZ4 blocks, no frame.

A copy of ``divortio_lz4_tpu/raw.py`` over the port's host block codecs
(``backends``): one calling convention on top of the block ABI, with the
same defaults, bytes and "LZ4: ..." errors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .backends import get_backend
from .constants import block_bound
from .ops.block_ref import new_hash_table
from .utils import ensure_buffer


def compress_raw(src,
                 dst: Optional[np.ndarray] = None,
                 src_start: int = 0,
                 src_len: Optional[int] = None,
                 hash_table: Optional[np.ndarray] = None,
                 dst_off: int = 0,
                 backend: Optional[str] = None):
    """Compress one raw LZ4 block.

    With *dst* provided, writes in place and returns bytes written (the
    block ABI). Without it, allocates a worst-case buffer and returns the
    compressed bytes as a uint8 array.
    """
    be = get_backend(backend)
    buf = ensure_buffer(src)
    if src_len is None:
        src_len = len(buf) - src_start
    if hash_table is None:
        hash_table = new_hash_table()
    if dst is not None:
        return be.compress_block(buf, dst, src_start, src_len, hash_table,
                                 dst_off)
    out = np.empty(dst_off + block_bound(src_len), dtype=np.uint8)
    n = be.compress_block(buf, out, src_start, src_len, hash_table, dst_off)
    return out[dst_off: dst_off + n]


def decompress_raw(src,
                   dst,
                   src_off: int = 0,
                   src_len: Optional[int] = None,
                   dst_off: int = 0,
                   dictionary=None,
                   backend: Optional[str] = None):
    """Decompress one raw LZ4 block.

    *dst* is either an output buffer (writes in place, returns bytes
    written: the block ABI) or an int capacity (allocates, returns the
    decoded bytes). Raw blocks carry no size, so the capacity must cover
    the plaintext; raises "LZ4: Output Buffer Too Small" when it does not.
    """
    be = get_backend(backend)
    buf = ensure_buffer(src)
    if src_len is None:
        src_len = len(buf) - src_off
    dict_buf = ensure_buffer(dictionary) if dictionary is not None else None
    if isinstance(dst, (int, np.integer)):
        out = np.empty(int(dst) + dst_off, dtype=np.uint8)
        n = be.decompress_block(buf, src_off, src_len, out, dst_off, dict_buf)
        return out[dst_off: dst_off + n]
    return be.decompress_block(buf, src_off, src_len, dst, dst_off, dict_buf)
