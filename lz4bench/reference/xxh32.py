"""xxHash32, written from its specification in plain Python.

Slow (about 7 MB/s): the reference checks the frames of a sample only.
"""

from __future__ import annotations

import struct

P1, P2, P3, P4, P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
M = 0xFFFFFFFF


def xxh32(data, seed: int = 0) -> int:
    mv = memoryview(bytes(data))
    n = len(mv)
    p = 0
    if n >= 16:
        v1, v2 = (seed + P1 + P2) & M, (seed + P2) & M
        v3, v4 = seed & M, (seed - P1) & M
        lim = n - n % 16
        for a, b, c, d in struct.iter_unpack("<4I", mv[:lim]):
            v1 = (v1 + a * P2) & M
            v1 = ((v1 << 13 | v1 >> 19) & M) * P1 & M
            v2 = (v2 + b * P2) & M
            v2 = ((v2 << 13 | v2 >> 19) & M) * P1 & M
            v3 = (v3 + c * P2) & M
            v3 = ((v3 << 13 | v3 >> 19) & M) * P1 & M
            v4 = (v4 + d * P2) & M
            v4 = ((v4 << 13 | v4 >> 19) & M) * P1 & M
        h = ((v1 << 1 | v1 >> 31) + (v2 << 7 | v2 >> 25)
             + (v3 << 12 | v3 >> 20) + (v4 << 18 | v4 >> 14)) & M
        p = lim
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while p + 4 <= n:
        h = (h + struct.unpack_from("<I", mv, p)[0] * P3) & M
        h = ((h << 17 | h >> 15) & M) * P4 & M
        p += 4
    while p < n:
        h = (h + mv[p] * P5) & M
        h = ((h << 11 | h >> 21) & M) * P1 & M
        p += 1
    h ^= h >> 15
    h = h * P2 & M
    h ^= h >> 13
    h = h * P3 & M
    h ^= h >> 16
    return h
