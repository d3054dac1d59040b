"""Host helpers: input coercion, little-endian words, the shared host pool.

``ensure_buffer``, ``concat_bytes``, ``read_u32le`` and ``write_u32le``
are copies of ``divortio_lz4_tpu/utils/buffers.py``; ``host_pool`` is a
copy of ``divortio_lz4_tpu/utils/pool.py``.
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np


def ensure_buffer(data: Any) -> np.ndarray:
    """Coerce *data* to a 1-D uint8 numpy array (zero-copy where possible):
    bytes, bytearray, memoryview, str (UTF-8), arrays and array-likes,
    lists of ints, or a JSON-serializable dict."""
    if isinstance(data, np.ndarray):
        if data.dtype == np.uint8 and data.ndim == 1:
            return np.ascontiguousarray(data)
        if data.dtype == np.uint8:
            return np.ascontiguousarray(data).reshape(-1)
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data) if isinstance(data, memoryview)
                             else data, dtype=np.uint8)
    if isinstance(data, str):
        return np.frombuffer(data.encode("utf-8"), dtype=np.uint8)
    if hasattr(data, "__array__"):
        arr = np.asarray(data)
        if arr.dtype == np.uint8:
            return np.ascontiguousarray(arr).reshape(-1)
        return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    if isinstance(data, (list, tuple)):
        return np.asarray(data, dtype=np.uint8)
    if isinstance(data, dict):
        try:
            return np.frombuffer(json.dumps(data).encode("utf-8"),
                                 dtype=np.uint8)
        except (TypeError, ValueError):
            pass
    raise TypeError(
        "LZ4: Input must be bytes, str, array, memoryview, list, or a "
        "JSON-serializable object"
    )


def concat_bytes(chunks) -> bytes:
    """Join a list of byte-like chunks into one bytes object."""
    return b"".join(bytes(c) if not isinstance(c, (bytes, bytearray)) else c
                    for c in chunks)


def read_u32le(buf, pos: int) -> int:
    return int(buf[pos]) | (int(buf[pos + 1]) << 8) | (
        int(buf[pos + 2]) << 16) | (int(buf[pos + 3]) << 24)


def write_u32le(buf, pos: int, value: int) -> None:
    buf[pos] = value & 0xFF
    buf[pos + 1] = (value >> 8) & 0xFF
    buf[pos + 2] = (value >> 16) & 0xFF
    buf[pos + 3] = (value >> 24) & 0xFF


# The native serialize and parse functions release the GIL (ctypes), so
# the frame paths fan blocks across one shared, lazily built pool.
_pool: ThreadPoolExecutor | None = None
_lock = threading.Lock()


def _reset_after_fork() -> None:
    # A forked child inherits a pool whose threads do not exist in it:
    # drop the reference so the child builds its own.
    global _pool, _lock
    _pool = None
    _lock = threading.Lock()


os.register_at_fork(after_in_child=_reset_after_fork)


def host_pool() -> ThreadPoolExecutor:
    """The shared internal pool (lazy, process-lifetime)."""
    global _pool
    if _pool is None:
        with _lock:
            if _pool is None:
                _pool = ThreadPoolExecutor(
                    max_workers=min(os.cpu_count() or 1, 8),
                    thread_name_prefix="lz4t-host")
    return _pool
