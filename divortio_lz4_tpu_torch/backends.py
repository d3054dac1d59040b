"""Host block-codec backends of the port's streams.

A copy of ``divortio_lz4_tpu/backends.py``: the same ``Backend`` bundle,
registry, names and error strings. Two backends are registered:

- "python": the scalar oracle in ``ops/block_ref.py``;
- "native" (the default): the port's host library, ``csrc/host_kernels.cpp``
  through ``host.py``, built with g++ at its first use, never at import.
  Its bytes are the oracle's.

The device bursts of ``stream.py`` (``backend="device"``) are not a host
backend: blocks outside a burst go to the default one, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .host import (compress_block_native, decompress_block_native,
                   warm_table_native)
from .ops.block_ref import (compress_block_ref, decompress_block_ref,
                            warm_hash_table)


class Backend:
    """A host block-codec bundle: compress_block, decompress_block and
    warm_table with the JAX package's signatures."""

    def __init__(self, name: str,
                 compress_block: Callable,
                 decompress_block: Callable,
                 warm_table: Callable):
        self.name = name
        self.compress_block = compress_block
        self.decompress_block = decompress_block
        self.warm_table = warm_table


_REGISTRY: Dict[str, Backend] = {}
_DEFAULT: Optional[str] = None


def register_backend(backend: Backend, make_default: bool = False) -> None:
    global _DEFAULT
    _REGISTRY[backend.name] = backend
    if make_default or _DEFAULT is None:
        _DEFAULT = backend.name


def get_backend(name: Optional[str] = None) -> Backend:
    if name is None:
        name = _DEFAULT
    if name not in _REGISTRY:
        raise KeyError(f"LZ4: unknown backend {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends():
    return sorted(_REGISTRY)


register_backend(Backend(
    "python",
    compress_block=compress_block_ref,
    decompress_block=decompress_block_ref,
    warm_table=warm_hash_table,
))
register_backend(Backend(
    "native",
    compress_block=compress_block_native,
    decompress_block=decompress_block_native,
    warm_table=warm_table_native,
), make_default=True)
