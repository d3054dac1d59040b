"""chain_decode's share of its roofline (percent): the bytes it must move
for the traced decompress calls' frames over 3.35 TB/s, over the profiled
time of its kernels (check, conformance, spans, the resolve rounds and the
copy) in those calls."""

from ._roofline import roofline_pct

NAMES = {"chain_check_kernel", "chain_conform_kernel", "chain_spans_kernel",
         "chain_decode_kernel", "resolve::init_kernel",
         "resolve::round_kernel", "resolve::gather_kernel"}


def read(run):
    return roofline_pct(run, "chain_decode", NAMES)
