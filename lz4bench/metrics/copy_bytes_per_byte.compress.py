"""Bytes the traced compress calls copied to the device and back (the port's
counters ``h2d_bytes`` and ``d2h_bytes``) over their plaintext bytes."""

from ._spans import copy_bytes_per_byte


def read(run):
    return copy_bytes_per_byte(run, "compress")
