"""The level schedule of ``csrc/record_groups.cuh`` in plain numpy, for the
grouped renditions of the compact and placed-literal decodes.

A group holds up to 32 records; record i's match copies ``n[i]`` bytes
from io position ``ms[i]`` to ``md[i]`` (``n[i] == 0``: none). A record is
ready when its source meets the output of no earlier record of the group
that was still pending when the level began; all ready records copy
together, then the next level begins.
"""

from __future__ import annotations

import numpy as np

GROUP = 32      # records a group: one a lane of a warp


def run_levels(io: np.ndarray, ms: np.ndarray, md: np.ndarray,
               n: np.ndarray) -> int:
    """Run one group's matches in *io* (in place) by dependency levels;
    returns the levels taken (0 when no record copies a match)."""
    k = len(n)
    writes = n > 0
    earlier = np.arange(k)[None, :] < np.arange(k)[:, None]
    dep = (earlier & writes[:, None] & writes[None, :]
           & (md[None, :] < (ms + n)[:, None])
           & (ms[:, None] < (md + n)[None, :]))
    pending = writes.copy()
    levels = 0
    while pending.any():
        ready = pending & ~(dep & pending[None, :]).any(1)
        idx = np.flatnonzero(ready)
        vals = [io[ms[i]: ms[i] + n[i]].copy() for i in idx]
        for i, v in zip(idx, vals):
            io[md[i]: md[i] + n[i]] = v
        pending &= ~ready
        levels += 1
    return levels


def run_groups(io: np.ndarray, ms: np.ndarray, md: np.ndarray,
               n: np.ndarray):
    """Every group of a block's records in order; returns (groups, the
    sum of their levels, the largest group's)."""
    levels = [run_levels(io, ms[g: g + GROUP], md[g: g + GROUP],
                         n[g: g + GROUP]) for g in range(0, len(n), GROUP)]
    return len(levels), sum(levels), max(levels, default=0)
