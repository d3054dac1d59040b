"""The build of a linked frame's history rows in the traced compress
calls: the self time of the port's span ``encode.history`` (the 64 KB of
plaintext before each block copied into its row,
``parallel/device._history_rows``), over the calls' wall time (percent).
No reading where the trace holds no such span: a program without it, or
frames that build no linked history rows."""

from ._spans import port_spans, self_pct

SPAN = "encode.history"


def read(run):
    if not any(s.name == SPAN for s in port_spans(run.trace)):
        return None
    return self_pct(run.trace, "compress", (SPAN,))
