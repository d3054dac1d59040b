"""The host's own time a frame in the traced decompress calls: the self time
of every port span except ``frame.put`` and ``frame.fetch`` (the root,
the frame steps and the decode steps), in microseconds, over the
frames of those calls (the port's counter ``frames``). With
``device_wait_us_per_frame.decompress`` it adds up to the roots' wall time
a frame."""

from ._frames import us_per_frame


def read(run):
    return us_per_frame(run, "decompress", wait=False)
