"""The traced run's profile, reduced to intervals the per-layer readers
share.

The benchmark marks each of its calls with a ``record_function`` range
(``lz4bench.compress`` / ``lz4bench.decompress``). Device work is given to
the call whose host range it overlaps: every call ends with its result in
host memory, so its device work ends inside it.

Device work is told apart by the profiler's activity type alone: kernels,
memcpys and memsets. The device-side copies of ``record_function`` ranges
(``gpu_user_annotation``), the benchmark's or any the program adds, are
no work and are dropped, whatever their names.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

CALL_PREFIX = "lz4bench."
# kineto activity types of work on the device
DEVICE_WORK = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}


class Span(NamedTuple):
    name: str
    start: int      # ns
    end: int        # ns
    kind: str = ""  # device work: "kernel", "memcpy" or "memset"


class Trace(NamedTuple):
    calls: list      # Span per benchmark call, name "compress"/"decompress"
    device: list     # Span per kernel, memcpy or memset on the device
    host: list       # Span per other host op
    start: int       # the traced window, ns
    end: int


def from_events(events) -> Trace:
    """Build a Trace from (name, activity type, on_device, start_ns,
    end_ns) tuples. The traced window runs from the first benchmark call's
    start to the last one's end."""
    calls, device, host = [], [], []
    for name, activity, on_device, s, e in events:
        if on_device:
            if activity in DEVICE_WORK:
                device.append(Span(name, s, e, DEVICE_WORK[activity]))
        elif name.startswith(CALL_PREFIX):
            calls.append(Span(name[len(CALL_PREFIX):], s, e))
        else:
            host.append(Span(name, s, e))
    calls.sort(key=lambda x: x.start)
    device.sort(key=lambda x: x.start)
    start = min((c.start for c in calls), default=0)
    end = max((c.end for c in calls), default=0)
    return Trace(calls, device, host, start, end)


def from_profile(prof) -> Trace:
    """Read a finished ``torch.profiler.profile`` (CPU and CUDA
    activities) through its raw kineto events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == cuda
        events.append((e.name(), activity(e, on_device), on_device,
                       e.start_ns(), e.start_ns() + e.duration_ns()))
    return from_events(events)


def activity(e, on_device: bool) -> str:
    """The kineto activity type of a profiler event. Where torch does not
    give it (before 2.12), device events other than the copies of ranges
    are kernels, memcpys and memsets, which CUPTI names "Memcpy ..." and
    "Memset ..."."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu_op"
    name = e.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else \
        "gpu_memset" if name.startswith("Memset") else "kernel"


def base_name(name: str) -> str:
    """A kernel's name without return type, namespace wrappers, template
    arguments or parameters: ``resolve::round_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return re.split(r"[(<]", name, 1)[0].strip()


def union(spans) -> list:
    """Merged (start, end) pairs of *spans*, sorted."""
    out = []
    for s, e in sorted((x.start, x.end) for x in spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(merged, ranges) -> int:
    """ns of the merged intervals that fall inside *ranges* (disjoint,
    sorted)."""
    total, j = 0, 0
    for s, e in ranges:
        while j < len(merged) and merged[j][1] <= s:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < e:
            total += min(e, merged[k][1]) - max(s, merged[k][0])
            k += 1
    return total


def calls_of(trace: Trace, kind: str) -> list:
    return [(c.start, c.end) for c in trace.calls if c.name == kind]


def idle_pct(trace: Optional[Trace], kind: str):
    """Share of the *kind* calls' wall time in which nothing ran on the
    device (percent), or None without such calls."""
    if trace is None:
        return None
    ranges = calls_of(trace, kind)
    wall = sum(e - s for s, e in ranges)
    if not wall:
        return None
    busy = overlap(union(trace.device), ranges)
    return 100.0 * (1.0 - busy / wall)


def copy_pct(trace: Optional[Trace], kind: str):
    """Device memcpy time (host to device and back) within the *kind*
    calls over their wall time (percent), or None without such calls."""
    if trace is None:
        return None
    ranges = calls_of(trace, kind)
    wall = sum(e - s for s, e in ranges)
    if not wall:
        return None
    copies = [d for d in trace.device if d.kind == "memcpy"]
    return 100.0 * overlap(union(copies), ranges) / wall


def kernel_ns(trace: Trace, names, kind: str) -> int:
    """Device time of the kernels named *names* within the *kind* calls."""
    spans = [d for d in trace.device if base_name(d.name) in names]
    return overlap(union(spans), calls_of(trace, kind))


def busy_s(trace: Trace) -> float:
    return overlap(union(trace.device), [(trace.start, trace.end)]) / 1e9


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by the innermost host op (or benchmark
    call) that covers the gap's middle."""
    by_name = {}
    for d in trace.device:
        by_name[d.name] = by_name.get(d.name, 0) + d.end - d.start
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union([d for d in trace.device
                  if d.end > trace.start and d.start < trace.end])
    edges = [trace.start] + [x for s, e in busy for x in (s, e)] \
        + [trace.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) // 2
        cover = [h for h in trace.host + [Span(CALL_PREFIX + c.name, c.start,
                                               c.end) for c in trace.calls]
                 if h.start <= mid < h.end]
        what = min(cover, key=lambda h: h.end - h.start).name if cover \
            else "between calls"
        named.append([what, (e - s) / 1e9])
    return {"device_ops": [[n, t / 1e9] for n, t in ops],
            "idle_gaps": named}
