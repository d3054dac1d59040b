"""Row padding uploaded a plaintext byte in the traced compress calls: the
port's counter ``row_pad_bytes`` (the payload-less columns of the chain
builder's 64 KB rows, which it uploads, sorts, picks over and sends back)
over the calls' plaintext bytes. Exactly 3.0 on frames of 16 KB, whose
one row is 64 KB wide; a row cut to its payload would read about 0."""

from ._linked import counter


def read(run):
    got = counter("compress", "row_pad_bytes")
    plain = sum(r.size for r in run.records)
    if not got or not plain:
        return None
    return got / plain
