"""The serializer's time in the traced compress calls: the self time of the
port's span ``encode.serialize`` (the host pool's fan-out and join), over
the calls' wall time (percent)."""

from ._spans import self_pct


def read(run):
    return self_pct(run.trace, "compress", ("encode.serialize",))
