"""The port's own spans and counters, read from the traced run.

The port opens a ``record_function`` range ``lz4t.<name>`` at each step of
its entry points while a profiler records
(``divortio_lz4_tpu_torch/tracing.py``), all on the thread that called
it, so the ranges nest. A span's self time is its interval less the parts
its ``lz4t.`` children cover; a share is the self time of the named spans
within the direction's benchmark calls over those calls' wall time.

The copy counters (``h2d_bytes``, ``d2h_bytes``) count only while a
profiler records, and only the traced window runs the port under one, so
their totals at read time are the window's. A program without these
spans or that module gives no reading.
"""

from __future__ import annotations

from typing import Optional

from ._trace import calls_of, overlap

PREFIX = "lz4t."
# the root span of each benchmark direction's calls
ROOT = {"compress": "compress_frames", "decompress": "decompress_frames"}


def self_intervals(spans) -> dict:
    """{name: [(start, end), ...]}: the parts of each span that none of its
    children covers. *spans* are properly nested, as ranges of one thread
    are."""
    out = {}

    def add(name, s, e):
        if e > s:
            out.setdefault(name, []).append((s, e))

    stack = []          # [span, end of its last child so far]
    for sp in sorted(spans, key=lambda x: (x.start, -x.end)):
        while stack and stack[-1][0].end <= sp.start:
            top, cursor = stack.pop()
            add(top.name, cursor, top.end)
        if stack:
            parent = stack[-1]
            add(parent[0].name, parent[1], min(sp.start, parent[0].end))
            parent[1] = max(parent[1], min(sp.end, parent[0].end))
        stack.append([sp, sp.start])
    while stack:
        top, cursor = stack.pop()
        add(top.name, cursor, top.end)
    return out


def port_spans(trace) -> list:
    """The traced run's ``lz4t.`` spans, names without the prefix."""
    if trace is None:
        return []
    return [h._replace(name=h.name[len(PREFIX):]) for h in trace.host
            if h.name.startswith(PREFIX)]


def self_pct(trace, kind: str, names) -> Optional[float]:
    """Self time of the spans named *names* within the *kind* calls, over
    those calls' wall time (percent); None without port spans or calls."""
    spans = port_spans(trace)
    if not spans:
        return None
    ranges = calls_of(trace, kind)
    wall = sum(e - s for s, e in ranges)
    if not wall:
        return None
    own = self_intervals(spans)
    parts = sorted(iv for n in names for iv in own.get(n, ()))
    return 100.0 * overlap(parts, ranges) / wall


def frame_host_pct(trace, kind: str):
    """The frame layer's host time: the root's own and the frame steps'."""
    return self_pct(trace, kind, (ROOT[kind], "frame.index",
                                  "frame.assemble", "frame.join",
                                  "frame.xxh32"))


def device_wait_pct(trace, kind: str):
    """The host blocked on copies, which wait for the kernels queued
    before them."""
    return self_pct(trace, kind, ("frame.put", "frame.fetch"))


def copy_bytes_per_byte(run, kind: str):
    """Bytes copied to and from the device in the *kind* calls over the
    plaintext bytes of those calls; None where the program keeps no such
    counters."""
    try:
        from divortio_lz4_tpu_torch import tracing
    except ImportError:
        return None
    got = tracing.counters().get(ROOT[kind])
    if kind == "compress":
        plain = sum(r.size for r in run.records)
    else:
        plain = sum(r.size for r in run.records
                    if r.t_decompress is not None)
    if not got or not plain:
        return None
    return (got.get("h2d_bytes", 0) + got.get("d2h_bytes", 0)) / plain
