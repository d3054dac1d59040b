"""The split decode's host time a chain in the traced decompress calls:
the self time of the port's spans ``decode.parse``, ``decode.records``
and ``decode.kernel``, in microseconds, over the chains those calls staged
for the chain kernel (the port's counter ``decode_chains``: one a block
of an independent frame of blocks over 256 KB, one a linked frame)."""

from ._linked import counter, self_ns

SPANS = ("decode.parse", "decode.records", "decode.kernel")


def read(run):
    chains = counter("decompress", "decode_chains")
    ns = self_ns(run.trace, "decompress", SPANS)
    if not chains or ns is None:
        return None
    return ns / 1e3 / chains
