"""The host blocked on copies a frame in the traced compress calls: the
self time of ``frame.put`` and ``frame.fetch`` (pageable uploads and
the one fetch, each waiting for the kernels queued before it), in
microseconds, over the frames of those calls (the port's counter
``frames``). With ``host_us_per_frame.compress`` it adds up to the
roots' wall time a frame."""

from ._frames import us_per_frame


def read(run):
    return us_per_frame(run, "compress", wait=True)
