"""Spans and copy counters of the port's host steps.

A span is a ``torch.profiler.record_function`` range named ``"lz4t." +
name``. It is opened only while a profiler is recording; otherwise
``span`` hands back one shared null context, so an untraced call pays one
check a span. The profiler stamps the ranges on the clock of the device
trace (kernels, memcpys), so every stretch in which the device waits
falls under the innermost range that covers it.

Spans nest: the root of each call is ``lz4t.compress_frames`` or
``lz4t.decompress_frames`` (``parallel/device.py``), and every step of the
call is a range inside it. Spans open only on the thread that called the
entry point: a fan-out to the host pool is one span around its submit and
join, since ranges opened on pool threads are not recorded.

The span ``encode.history``, inside ``encode.rows``, is the fill of the
history columns of a linked frame's whole-block rows in
``parallel/bigblock.history_rows`` (each row's history being the 64 KB of
plaintext before it, one slice copy for the frame). It opens only where
the rows are the blocks of a linked frame (the split route's 64 KB
blocks, the row encoders' linked frames), never for independent blocks
or for the segment rows of bigger blocks.

Counters (``count``) add while a profiler is recording, under the root
that is open on the calling thread: ``frames`` (the frames of every call,
counted in the roots on every route: the payloads of a compress, the
frames of a decompress), ``h2d_bytes`` (every upload of ``put``),
``d2h_bytes`` (every fetch of ``_fetch_all``), ``splice_cmp_bytes`` (the
plaintext that the big-block splice compared to extend matches over
segment boundaries, ``parallel/bigblock._ext_len``), ``hist_h2d_bytes``
(the history columns that the chain builder's row uploads carry,
``hist_len`` bytes a row, ``ops/split_encode.encode_blocks_chain``; a part
of ``h2d_bytes``), ``row_pad_bytes`` (the payload-less columns of the same
uploads, each row's payload width, ``block_size``, less its length:
columns that the chain builder uploads, sorts, picks over and sends back
with no plaintext in them; a frame shorter than a 64 KB segment pads its
one row to 64 KB, and full rows add 0), ``decode_blocks`` (the blocks of
every frame that ``parallel/device._stage_frame`` stages, on every route),
``compact_records`` (the records that the compact route's native staging,
``ops/split_decode.stage_compact_batch``, parsed and packed, inside
``decode.records``: every frame of independent blocks up to 64 KB on the
split engine, and the streaming decoder's compact bursts),
``chain_records`` (the records whose words the native pass of
``ops/wave_decode.build_chain_arrays`` packed, inside ``decode.records``;
only a linked frame or one of blocks over 256 KB takes that route),
``decode_chains`` (the chains that ``ops/wave_decode.stage_chains`` staged
on that route, beside ``chain_records``: one a linked frame, one a block
of an independent frame), ``splice_blocks`` (the blocks that
``parallel/bigblock.splice_blocks_big`` spliced from their segments,
inside ``encode.splice``: every block of a frame over 64 KB blocks, a
short last block included) and ``chain_kernel_rows`` (the rows that the
CUDA chain builder, ``csrc/chain_build.cu``, built in
``ops/hybrid_encode.build_dist_chains``, inside ``encode.chains``: an
operator's check that the main path went through the kernel; no metric
reads it).
To trace the port, run its calls under ``torch.profiler.profile``, then
read the ranges from the profile and the totals from ``counters()``.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

PREFIX = "lz4t."
ROOTS = ("compress_frames", "decompress_frames")

_profiling = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_local = threading.local()      # .root: the root open on this thread
_lock = threading.Lock()
_totals: dict = {}              # {root: {counter: total}}


class _Range:
    """A recorded range; a root also marks its thread's counters."""

    __slots__ = ("_range", "_root", "_outer")

    def __init__(self, name: str):
        self._range = torch.profiler.record_function(PREFIX + name)
        self._root = name if name in ROOTS else None

    def __enter__(self):
        if self._root is not None:
            self._outer = getattr(_local, "root", None)
            _local.root = self._root
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        if self._root is not None:
            _local.root = self._outer
        return False


def span(name: str):
    """The range ``lz4t.<name>`` while a profiler records, else a shared
    null context."""
    if not _profiling():
        return _NULL
    return _Range(name)


def recording() -> bool:
    """Whether a profiler records: spans open and counters add. A counter
    whose value takes work to find checks it first."""
    return _profiling()


def count(name: str, n: int) -> None:
    """Add *n* to counter *name* of the root open on this thread, while a
    profiler records."""
    if not _profiling():
        return
    root = getattr(_local, "root", None)
    if root is None:
        return
    with _lock:
        per = _totals.setdefault(root, {})
        per[name] = per.get(name, 0) + int(n)


def counters() -> dict:
    """A copy of the totals: {root: {counter: total}}."""
    with _lock:
        return {k: dict(v) for k, v in _totals.items()}


def reset() -> None:
    """Clear every total."""
    with _lock:
        _totals.clear()


def put(a: np.ndarray, device) -> torch.Tensor:
    """Copy a host array to *device*: the span ``frame.put`` and the
    counter ``h2d_bytes``. A pageable copy waits for the work already
    queued on the stream, so the span holds that wait."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    with span("frame.put"):
        count("h2d_bytes", host.numel() * host.element_size())
        return host.to(device)
