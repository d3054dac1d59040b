"""xxHash32 for frame checksums, through the port's host library
(``csrc/host_kernels.cpp:lz4t_xxhash32``, built with g++ at first use).

The counterpart of ``divortio_lz4_tpu.xxh.xxhash32`` on its native path.
"""

from __future__ import annotations

from .host import xxhash32_native
from .utils import ensure_buffer


def xxhash32(buf, seed: int = 0) -> int:
    """xxHash32 of *buf* (anything ensure_buffer takes) with *seed*."""
    return xxhash32_native(ensure_buffer(buf), seed)
