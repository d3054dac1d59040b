"""The split decode's host time a block in the traced decompress calls:
the self time of the port's spans ``decode.parse``, ``decode.records``
and ``decode.kernel``, in microseconds, over the blocks those calls
staged (the port's counter ``decode_blocks``)."""

from ._linked import counter, self_ns

SPANS = ("decode.parse", "decode.records", "decode.kernel")


def read(run):
    blocks = counter("decompress", "decode_blocks")
    ns = self_ns(run.trace, "decompress", SPANS)
    if not blocks or ns is None:
        return None
    return ns / 1e3 / blocks
