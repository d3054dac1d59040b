"""The chain builder's host time in the traced compress calls: the self time
of the port's spans ``encode.rows`` (history or segment rows) and
``encode.chains`` (the chain builds' enqueue, less their uploads), over the
calls' wall time (percent)."""

from ._spans import self_pct


def read(run):
    return self_pct(run.trace, "compress", ("encode.rows", "encode.chains"))
