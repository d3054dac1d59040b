"""Readers shared by the metrics of the linked 64 KB route (the
``pylz4default`` cell): a counter of the port's by name, and a span's self
time in nanoseconds.

A program without the counter, the span or the port's ``tracing`` module
gives no reading, so each reader returns None there and never raises.
"""

from __future__ import annotations

from typing import Optional

from ._spans import ROOT, port_spans, self_intervals
from ._trace import calls_of, overlap


def counter(kind: str, name: str) -> Optional[int]:
    """The traced window's total of the port's counter *name* under the
    *kind* direction's root; None where the program keeps no such
    counter."""
    try:
        from divortio_lz4_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.counters().get(ROOT[kind], {}).get(name)


def self_ns(trace, kind: str, names) -> Optional[int]:
    """Self time, ns, of the spans named *names* within the *kind* calls;
    None without port spans or calls."""
    spans = port_spans(trace)
    ranges = calls_of(trace, kind) if spans else []
    if not ranges:
        return None
    own = self_intervals(spans)
    return overlap(sorted(iv for n in names for iv in own.get(n, ())),
                   ranges)
