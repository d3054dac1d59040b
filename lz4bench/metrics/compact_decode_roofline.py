"""compact_decode's share of its roofline (percent): the bytes it must
move for the traced decompress calls' frames over 3.35 TB/s, over its
profiled time in those calls."""

from ._roofline import roofline_pct

NAMES = {"compact_groups_kernel", "compact_serial_kernel"}


def read(run):
    return roofline_pct(run, "compact_decode", NAMES)
