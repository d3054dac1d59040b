"""The big-block splice's time a block in the traced compress calls: the
self time of the port's span ``encode.splice``, in microseconds, over the
blocks those calls spliced from their 64 KB segments (the port's counter
``splice_blocks``)."""

from ._linked import counter, self_ns


def read(run):
    blocks = counter("compress", "splice_blocks")
    ns = self_ns(run.trace, "compress", ("encode.splice",))
    if not blocks or ns is None:
        return None
    return ns / 1e3 / blocks
