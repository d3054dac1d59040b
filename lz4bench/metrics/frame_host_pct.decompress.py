"""The frame layer's host time in the traced decompress calls: the self time
of the port's root span and of ``frame.index``, ``frame.assemble``,
``frame.join`` and ``frame.xxh32``, over the calls' wall time
(percent)."""

from ._spans import frame_host_pct


def read(run):
    return frame_host_pct(run.trace, "decompress")
