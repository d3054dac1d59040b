"""History bytes uploaded a plaintext byte in the traced compress calls:
the port's counter ``hist_h2d_bytes`` (the history columns of the chain
builder's row uploads) over the calls' plaintext bytes. About 1.00 where
every 64 KB block's row carries the 64 KB before it; a history built on
the device from the one payload upload would read about 0."""

from ._linked import counter


def read(run):
    got = counter("compress", "hist_h2d_bytes")
    plain = sum(r.size for r in run.records)
    if got is None or not plain:
        return None
    return got / plain
