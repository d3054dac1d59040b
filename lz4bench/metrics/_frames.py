"""Readers shared by the per-frame metrics of the small-frame path (the
``kafka-lz4`` cell): the roots' wall time a frame, in two parts.

Every ``lz4t.`` span of a call nests in its root, so the self times of
all the spans within the direction's calls add up to the roots' wall time
there. ``frame.put`` and ``frame.fetch`` are the host blocked on copies
(which wait for the kernels queued before them); every other span is the
host at work. Each part, in microseconds, is divided by the port's
counter ``frames``. A program without that counter, or without the
spans, gives no reading.
"""

from __future__ import annotations

from typing import Optional

from ._linked import counter, self_ns
from ._spans import port_spans

WAIT = ("frame.put", "frame.fetch")


def us_per_frame(run, kind: str, wait: bool) -> Optional[float]:
    """Self time a frame, us, of the *kind* calls' copy waits (*wait*) or
    of every other port span; None without the counter or the spans."""
    frames = counter(kind, "frames")
    spans = port_spans(run.trace)
    if not frames or not spans:
        return None
    names = set(WAIT) if wait else {s.name for s in spans} - set(WAIT)
    ns = self_ns(run.trace, kind, names)
    if ns is None:
        return None
    return ns / 1e3 / frames
