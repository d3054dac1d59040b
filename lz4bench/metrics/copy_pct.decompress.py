"""Device memcpy time, host to device and back, within the traced decompress
calls over their wall time (percent)."""

from ._trace import copy_pct


def read(run):
    return copy_pct(run.trace, "decompress")
