"""FrameConfig, the port's typed frame configuration.

A copy of ``divortio_lz4_tpu/config.py``: the same fields, defaults,
``block_id``, ``resolved_block_size`` and ``with_``, so a configuration
means the same frame in both packages. The port keeps its own copy rather
than importing the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .constants import BLOCK_MAX_SIZES, DEFAULT_BLOCK_SIZE, get_block_id


@dataclass(frozen=True)
class FrameConfig:
    """Configuration for LZ4 frame encoding.

    Attributes:
      block_size: requested max block size; quantized to 64K/256K/1M/4M.
      block_independence: if True, each block is self-contained (parallel
        decode; slightly lower ratio). Default False (linked blocks), the
        reference encoder's default.
      content_checksum: append xxHash32 of the whole plaintext.
      content_size: store the 64-bit plaintext size in the header.
      block_checksums: write a 4-byte xxHash32 after each block.
      favor_ratio: read by the JAX package's XLA encoder only; kept so a
        configuration round-trips between the two packages.
    """

    block_size: int = DEFAULT_BLOCK_SIZE
    block_independence: bool = False
    content_checksum: bool = False
    content_size: bool = True
    block_checksums: bool = False
    favor_ratio: bool = True

    @property
    def block_id(self) -> int:
        return get_block_id(self.block_size)

    @property
    def resolved_block_size(self) -> int:
        return BLOCK_MAX_SIZES[self.block_id]

    def with_(self, **kw) -> "FrameConfig":
        return replace(self, **kw)


DEFAULT_CONFIG = FrameConfig()
