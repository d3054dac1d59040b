"""Share of the traced compress calls' wall time in which no kernel, memcpy
or memset ran on the device (percent)."""

from ._trace import idle_pct


def read(run):
    return idle_pct(run.trace, "compress")
