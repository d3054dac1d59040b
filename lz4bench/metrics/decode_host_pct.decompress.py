"""The split decode's host time in the traced decompress calls: the self
time of the port's spans ``decode.parse`` (record parse), ``decode.records``
(flat records or chain arrays) and ``decode.kernel`` (the kernel's checks
and enqueue), over the calls' wall time (percent)."""

from ._spans import self_pct


def read(run):
    return self_pct(run.trace, "decompress",
                    ("decode.parse", "decode.records", "decode.kernel"))
