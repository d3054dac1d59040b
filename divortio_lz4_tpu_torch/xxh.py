"""xxHash32 for frame checksums, one-shot and streaming, through the port's
host library (``csrc/host_kernels.cpp``: ``lz4t_xxhash32`` and
``lz4t_xxh32_round4``, built with g++ at first use).

The counterpart of ``divortio_lz4_tpu.xxh`` on its native path:
``xxhash32`` and the streaming ``XXHash32`` (a copy of
``xxh/xxhash32.py:107-199``), whose ``state_dict`` has the same keys and
values as the JAX class's, so a stream checkpoint moves between the two
packages.
"""

from __future__ import annotations

import numpy as np

from .host import xxh32_round4_native, xxhash32_native
from .utils import ensure_buffer

PRIME1 = 0x9E3779B1
PRIME2 = 0x85EBCA77
PRIME3 = 0xC2B2AE3D
PRIME4 = 0x27D4EB2F
PRIME5 = 0x165667B1

_M32 = 0xFFFFFFFF


def xxhash32(buf, seed: int = 0) -> int:
    """xxHash32 of *buf* (anything ensure_buffer takes) with *seed*."""
    return xxhash32_native(ensure_buffer(buf), seed)


def _rotl(x: int, r: int) -> int:
    x &= _M32
    return ((x << r) | (x >> (32 - r))) & _M32


def _tail(h32: int, buf: np.ndarray, p: int) -> int:
    """Process the < 16-byte tail starting at p, then avalanche."""
    n = len(buf)
    while p + 4 <= n:
        lane = int(buf[p]) | (int(buf[p + 1]) << 8) | (
            int(buf[p + 2]) << 16) | (int(buf[p + 3]) << 24)
        h32 = (h32 + (lane * PRIME3 & _M32)) & _M32
        h32 = (_rotl(h32, 17) * PRIME4) & _M32
        p += 4
    while p < n:
        h32 = (h32 + (int(buf[p]) * PRIME5 & _M32)) & _M32
        h32 = (_rotl(h32, 11) * PRIME1) & _M32
        p += 1
    h32 ^= h32 >> 15
    h32 = (h32 * PRIME2) & _M32
    h32 ^= h32 >> 13
    h32 = (h32 * PRIME3) & _M32
    h32 ^= h32 >> 16
    return h32


class XXHash32:
    """Incremental xxHash32 with a 16-byte carry buffer.

    ``digest()`` is a non-destructive peek: it may be called repeatedly
    and interleaved with further ``update()`` calls.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed & _M32
        self.reset()

    def reset(self) -> "XXHash32":
        s = self.seed
        self._v1 = (s + PRIME1 + PRIME2) & _M32
        self._v2 = (s + PRIME2) & _M32
        self._v3 = s
        self._v4 = (s - PRIME1) & _M32
        self._total = 0
        self._mem = np.empty(16, dtype=np.uint8)
        self._memsize = 0
        return self

    def _stripes(self, words: np.ndarray) -> None:
        self._v1, self._v2, self._v3, self._v4 = xxh32_round4_native(
            self._v1, self._v2, self._v3, self._v4, words)

    def update(self, data) -> "XXHash32":
        buf = ensure_buffer(data)
        n = len(buf)
        if n == 0:
            return self
        self._total += n
        pos = 0
        # Fill the carry buffer first.
        if self._memsize > 0:
            take = min(16 - self._memsize, n)
            self._mem[self._memsize: self._memsize + take] = buf[:take]
            self._memsize += take
            pos = take
            if self._memsize < 16:
                return self
            self._stripes(np.frombuffer(self._mem.tobytes(), dtype="<u4"))
            self._memsize = 0
        # Bulk stripes, through a zero-copy u32 view where the slice
        # allows one.
        nstripes = (n - pos) // 16
        if nstripes > 0:
            seg = buf[pos: pos + nstripes * 16]
            try:
                words = seg.view("<u4")
            except ValueError:  # non-contiguous or oddly-aligned slice
                words = np.frombuffer(seg.tobytes(), dtype="<u4")
            self._stripes(words)
            pos += nstripes * 16
        # Stash the remainder.
        rem = n - pos
        if rem > 0:
            self._mem[:rem] = buf[pos:]
            self._memsize = rem
        return self

    def state_dict(self) -> dict:
        """Serializable snapshot (checkpoint/resume for streaming
        sessions)."""
        return {
            "seed": self.seed, "v": (self._v1, self._v2, self._v3, self._v4),
            "total": self._total,
            "mem": bytes(self._mem[: self._memsize]),
        }

    @classmethod
    def from_state(cls, state: dict) -> "XXHash32":
        h = cls(state["seed"])
        h._v1, h._v2, h._v3, h._v4 = state["v"]
        h._total = state["total"]
        h._memsize = len(state["mem"])
        h._mem[: h._memsize] = np.frombuffer(state["mem"], np.uint8)
        return h

    def digest(self) -> int:
        if self._total >= 16:
            h32 = (_rotl(self._v1, 1) + _rotl(self._v2, 7) +
                   _rotl(self._v3, 12) + _rotl(self._v4, 18)) & _M32
        else:
            h32 = (self.seed + PRIME5) & _M32
        h32 = (h32 + self._total) & _M32
        return _tail(h32, self._mem[: self._memsize], 0)
