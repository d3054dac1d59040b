"""The host blocked on copies in the traced compress calls: the self time of
the port's spans ``frame.put`` and ``frame.fetch``, which wait for the
kernels queued before them, over the calls' wall time (percent)."""

from ._spans import device_wait_pct


def read(run):
    return device_wait_pct(run.trace, "compress")
